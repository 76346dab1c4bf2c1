"""The map-scale circuit (``orbslam2_tpu_torch/tools/scale_demo.py``) and
the trajectory tool (``orbslam2_tpu_torch/tools/plot_trajectory.py``)
against the JAX package.

  * both ``WindowedSlamEngine(window=4)``s, loop closing on, at the
    circuit's configuration and full capacity (1024 keyframe slots,
    131,072 points, 1000 features, the scale camera) over the first 12
    frames of tests/test_scale_circuit.py's scene, uint8 frames on both
    sides, ``_mapper_idle`` patched to True on both and the port handed
    JAX's frontend (tests/jax_angles.py: its pyramids, IC angles and
    stereo SAD sum in a host-dependent float order): the same
    ``kf_inserted``,
    ``n_kfs`` and ``n_live_points``; neither LOST; every camera centre
    and the ATE within 0.01 m of the JAX engine's (test_torch_windowed.py's
    parity bar for whole-engine runs), ATE < 0.1 m (both packages take
    ~0.050 m here, at 0.54 m a frame; the corridor's 0.05 m bar is that
    scene's);
  * ``run_circuit`` on the CPU past 256 keyframe slots over the scale
    circuit's first frames: the rows' and the summary's keys (the JAX
    script's, plus the peak allocation), the ATE against a numpy
    recomputation, and ``main`` writes no file without ``--out`` and the
    table with it; ``--device cuda`` raises where torch has no card;
  * the trajectory tool against ``tools/analysis/plot_trajectory.py`` on
    TUM files made from a seed, with and without ground truth, with
    ``--align`` and ``--align --scale``: the same printed lines, and the
    same PLY bytes with matplotlib hidden.

The ``slow`` test is tests/test_scale_circuit.py on the port: the same
scene, configuration and bars at that test's capacity and at the
circuit's.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.tools import plot_trajectory as tplot
from orbslam2_tpu_torch.tools import scale_demo as sd
from orbslam2_tpu_torch.utils import render_pool, synthetic

from jax_angles import hand_over_frontend

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENGINE = 12

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


def _jax_cfg(tcfg):
    return SlamConfig(
        camera=CameraConfig(**dataclasses.asdict(tcfg.camera)),
        orb=OrbConfig(**dataclasses.asdict(tcfg.orb)),
        capacity=CapacityConfig(**dataclasses.asdict(tcfg.capacity)),
        sensor=STEREO)


def _u8(frames):
    return [(np.ascontiguousarray(l, dtype=np.uint8),
             np.ascontiguousarray(r, dtype=np.uint8)) for l, r in frames]


# ------------------------------------------------------ engines at scale --

def test_config_is_the_jax_scripts():
    cfg = sd.scale_config()
    assert (cfg.capacity.max_keyframes, cfg.capacity.max_map_points) == \
        (1024, 1 << 17)
    assert (cfg.camera.fx, cfg.camera.bf, cfg.camera.width,
            cfg.camera.th_depth, cfg.orb.n_features) == \
        (225.0, 120.0, 320, 35.0, 1000)
    assert (cfg.capacity.local_ba_keyframes,
            cfg.capacity.local_ba_points) == (8, 2048)
    assert isinstance(cfg, tconfig.SlamConfig)


def test_windowed_engines_at_scale_capacity_track_alike(monkeypatch):
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxW

    tcfg = sd.scale_config()
    rng = np.random.default_rng(0)
    world, poses = sd.small_circuit(rng)
    poses = poses[:N_ENGINE]
    frames = _u8(render_pool.render_frames(synthetic.render_world_stereo,
                                           world, tcfg.camera, poses, rng))
    jeng = JaxW(_jax_cfg(tcfg), enable_loop_closing=True, window=4)
    jeng._mapper_idle = lambda: True
    hand_over_frontend(monkeypatch)
    teng = WindowedSlamEngine(tcfg, enable_loop_closing=True, device="cpu",
                              window=4)
    teng._mapper_idle = lambda: True
    for i, (l, r) in enumerate(frames):
        jeng.track_stereo(l, r, 0.1 * i)
        teng.track_stereo(l, r, 0.1 * i)
    jeng.flush()
    teng.flush()
    assert teng.ms.K == 1024 and teng.ms.P == 1 << 17
    assert jeng.state == teng.state == 2
    got = (teng.stats["kf_inserted"], teng.n_kfs, teng.n_live_points)
    want = (jeng.stats["kf_inserted"], jeng.n_kfs, jeng.n_live_points)
    assert got == want, (got, want)
    est_t, est_j = teng.frame_poses(), jeng.frame_poses()
    assert sum(T is not None for T in est_t) == \
        sum(T is not None for T in est_j) == N_ENGINE
    gap = max(np.linalg.norm(Tt[:3, :3].T @ Tt[:3, 3]
                             - Tj[:3, :3].T @ Tj[:3, 3])
              for Tt, Tj in zip(est_t, est_j))
    t_ate, j_ate = sd.circuit_ate(est_t, poses), sd.circuit_ate(est_j, poses)
    assert gap < 0.01, gap
    assert abs(t_ate - j_ate) < 0.01, (t_ate, j_ate)
    assert t_ate < 0.1, (t_ate, j_ate)


# ------------------------------------------------------------ the tool ---

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


# ------------------------------------------------------- plot_trajectory --

def _jax_plot_tool():
    path = os.path.join(REPO, "tools", "analysis", "plot_trajectory.py")
    spec = importlib.util.spec_from_file_location("_jax_plot_trajectory",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_tum(path, ts, pos, rng):
    q = rng.normal(size=(len(ts), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, qq in zip(ts, pos, q):
            f.write(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*p, *qq))
                    + "\n")


@pytest.fixture(scope="module")
def tum_files(tmp_path_factory):
    """A ground-truth walk and an estimate of it: rotated, shifted,
    scaled by 1.3 and noisy, on timestamps jittered by up to 15 ms, with
    gaps (estimate frames with no ground truth within 20 ms)."""
    d = tmp_path_factory.mktemp("tum")
    rng = np.random.default_rng(11)
    n = 120
    ts = 0.1 * np.arange(n)
    gt = np.cumsum(rng.normal(0, 0.2, (n, 3)), axis=0)
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    est = 1.3 * gt @ R.T + np.array([0.5, -0.2, 1.0]) \
        + rng.normal(0, 0.01, (n, 3))
    ts_e = ts + rng.uniform(-0.015, 0.015, n)
    ts_e[::17] += 0.05
    _write_tum(d / "gt.txt", ts, gt, rng)
    _write_tum(d / "est.txt", ts_e, est, rng)
    return str(d / "est.txt"), str(d / "gt.txt")


def _run_tool(main, argv, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", ["plot_trajectory.py", *argv])
    main()
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    pytest.param(None, id="no-gt"), pytest.param([], id="gt"),
    pytest.param(["--align"], id="align"),
    pytest.param(["--align", "--scale"], id="align-scale")])
def test_plot_tool_matches_jax_without_matplotlib(flags, tum_files,
                                                  tmp_path, monkeypatch,
                                                  capsys):
    est, gt = tum_files
    argv = [est] + ([] if flags is None else [gt, *flags]) + \
        ["--out", "traj.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    jtool = _jax_plot_tool()
    outs = {}
    for name, main in (("jax", jtool.main), ("port", tplot.main)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = (_run_tool(main, argv, d, monkeypatch, capsys),
                      (d / "traj.ply").read_bytes())
        assert os.listdir(d) == ["traj.ply"]
    assert outs["port"] == outs["jax"]
    lines = outs["port"][0].splitlines()
    assert lines[-1] == "matplotlib unavailable; wrote traj.ply"
    if flags is not None:
        t_est = np.loadtxt(est, usecols=0)
        t_gt = np.loadtxt(gt, usecols=0)
        n_matched = int(np.sum(
            np.abs(t_est[:, None] - t_gt[None]).min(axis=1) <= 0.02))
        assert n_matched == 112          # the fixture's 8 gaps
        assert lines[0].startswith("ATE RMSE: ")
        assert lines[0].endswith(f" m over {n_matched} matched poses")


def test_plot_tool_matches_jax_with_matplotlib(tum_files, tmp_path,
                                               monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    est, gt = tum_files
    argv = [est, gt, "--align", "--scale", "--out", "traj.png"]
    jtool = _jax_plot_tool()
    outs = {}
    for name, main in (("jax", jtool.main), ("port", tplot.main)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = _run_tool(main, argv, d, monkeypatch, capsys)
        assert os.listdir(d) == ["traj.png"]
        assert (d / "traj.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert outs["port"] == outs["jax"]
    assert outs["port"].splitlines()[-1] == "wrote traj.png"


def test_associate_matches_jax():
    jtool = _jax_plot_tool()
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 10, 200))
    b = np.sort(rng.uniform(0, 10, 150))
    for dt in (0.005, 0.02, 0.1):
        assert tplot.associate(a, b, dt) == jtool.associate(a, b, dt)


# ------------------------------------------------------------------ slow --

@pytest.mark.slow
@pytest.mark.parametrize("max_kf,max_mp", [(128, 1 << 15), (1024, 1 << 17)],
                         ids=["128-slots", "1024-slots"])
def test_circuit_closes_loop_and_stays_bounded_on_the_port(max_kf, max_mp):
    """tests/test_scale_circuit.py on the port (its scene, configuration
    and bars), at that test's capacity and at the circuit's."""
    cfg = tconfig.SlamConfig(
        camera=tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                                    bf=75.0, width=320, height=240,
                                    fps=10.0, th_depth=40.0),
        orb=tconfig.OrbConfig(n_features=600),
        capacity=tconfig.CapacityConfig(max_keyframes=max_kf,
                                        max_map_points=max_mp,
                                        local_ba_keyframes=8,
                                        local_ba_points=2048),
        sensor=tconfig.STEREO)
    rng = np.random.default_rng(0)
    world, poses = sd.small_circuit(rng)
    n = len(poses)
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, device="cpu",
                             window=4)
    for i, T in enumerate(poses):
        l, r = synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                             noise=1.0)
        eng.track_stereo(l, r, timestamp=0.1 * i)
    eng.flush()
    eng.finish_gba()
    est = eng.frame_poses()
    tracked = sum(p is not None for p in est)
    assert tracked >= 0.95 * n, (tracked, n, eng.stats)
    assert eng.stats.get("loops_closed", 0) >= 1, eng.stats
    assert eng.n_kfs <= cfg.capacity.max_keyframes
    assert eng.stats["kf_inserted"] >= 30, eng.stats
    ate = sd.circuit_ate(est, poses)
    assert ate < 1.5, (ate, eng.stats)
