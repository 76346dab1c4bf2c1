"""``run_circuit`` and ``main`` of the map-scale circuit
(``orbslam2_tpu_torch/tools/scale_demo.py``) on the CPU past 256
keyframe slots, over the scale circuit's first frames (moved from
tests/test_torch_scale.py, which holds both engines at the circuit's
capacity): the rows' and the summary's keys (the JAX script's, plus the
peak allocation), the ATE against a numpy recomputation, and ``main``
writes no file without ``--out`` and the table with it; ``--device
cuda`` raises where torch has no card.
"""

import json
import os

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.tools import scale_demo as sd
from orbslam2_tpu_torch.utils import render_pool, synthetic

torch.set_num_threads(2)

# tools/benchmarks/scale_demo.py:146-166
JAX_SUMMARY_KEYS = {
    "metric", "n_frames", "capacity_kf", "capacity_mp", "wall_s",
    "overall_fps", "fps_first3_chunks", "fps_last3_chunks",
    "fps_degradation", "peak_kfs", "peak_points", "loops_closed",
    "kf_evicted", "gba_runs", "gba_drain_s", "tracked_frames", "ate_m",
    "mem_MB_last"}
# tools/benchmarks/scale_demo.py:101-111
JAX_ROW_KEYS = {"frames", "fps", "n_kfs", "live_points", "kf_inserted",
                "kf_culled", "loops", "state", "mem_MB"}


SMALL = ("320", "32768")          # past 256 slots: the GBA would take CG


def _circuit_head(rng, n_frames, laps=1.15):
    """The scale circuit's first ``n_frames`` poses (its step between
    frames), instead of ``n_frames`` frames around the whole circuit."""
    world, poses = _scale_scene(rng, 2400, laps)
    return world, poses[:n_frames]


_scale_scene = sd.scale_scene


@pytest.mark.parametrize("flush", [True, False],
                         ids=["flush-each-chunk", "no-flush"])
def test_run_circuit_rows_summary_and_ate(flush):
    cfg = sd.scale_config(*map(int, SMALL))
    rng = np.random.default_rng(7)
    world, poses = _circuit_head(rng, 8)
    frames = render_pool.render_frames(synthetic.render_world_stereo, world,
                                       cfg.camera, poses, rng)
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, device="cpu",
                             window=4)
    pushed, flushes = [], []
    track, eng_flush = eng.track_stereo, eng.flush
    eng.track_stereo = lambda *a, **k: pushed.append(1) or track(*a, **k)
    eng.flush = lambda: flushes.append(len(pushed)) or eng_flush()
    logged = []
    rows, summary, flog = sd.run_circuit(eng, frames, poses, chunk=4,
                                         log=logged.append, flush=flush)
    assert logged == rows and [r["frames"] for r in rows] == [4, 8]
    # flushes at the chunks' ends, or none before the drain's
    assert flushes[0] == (4 if flush else 8)
    assert flushes.count(4) == int(flush)
    for r in rows:
        assert set(r) == JAX_ROW_KEYS | {"peak_alloc_MB"}
        assert r["mem_MB"] is None and r["peak_alloc_MB"] is None   # CPU
        assert r["state"] == 2 and r["fps"] > 0
    assert set(summary) == JAX_SUMMARY_KEYS | {"peak_alloc_MB"}
    assert (summary["n_frames"], summary["capacity_kf"],
            summary["capacity_mp"], summary["tracked_frames"]) == \
        (8, 320, 32768, 8)
    assert len(flog["frame_ms"]) == 8 and flog["loop_frames"] == []
    # the ATE, recomputed: centres -Rᵀt against ground truth rebased so
    # that camera 0 is the origin
    est = eng.frame_poses()
    gt = [T @ np.linalg.inv(poses[0]) for T in poses]
    ce = np.array([-T[:3, :3].T @ T[:3, 3] for T in est])
    cg = np.array([-T[:3, :3].T @ T[:3, 3] for T in gt])
    want = np.sqrt(np.mean(np.sum((ce - cg) ** 2, axis=1)))
    assert summary["ate_m"] == pytest.approx(want, rel=1e-12, abs=0)
    assert summary["ate_m"] < 0.05


def test_main_writes_only_to_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sd, "scale_scene", _circuit_head)
    argv = ["6", "--device", "cpu", "--max-kf", SMALL[0], "--max-mp",
            SMALL[1]]
    summary = sd.main(argv)
    assert os.listdir(tmp_path) == []
    out = capsys.readouterr().out.splitlines()
    assert json.loads(next(l for l in out if l.startswith("{\"metric\""))) \
        == summary
    assert summary["tracked_frames"] == 6
    sd.main(argv + ["--out", "table.md"])
    assert os.listdir(tmp_path) == ["table.md"]
    text = (tmp_path / "table.md").read_text()
    assert "| frames | fps | keyframes | points | culled | loops | " \
           "allocated MB | chunk peak allocated MB |" in text
    assert "| 6 |" in text and '"metric": "scale_demo"' in text


def test_main_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card refusal; this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        sd.main(["4"])
