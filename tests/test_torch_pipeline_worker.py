"""The port's async pipeline (``orbslam2_tpu_torch/runtime/pipeline.py``)
as a user drives it, on tests/test_torch_pipeline.py's sequence (moved
from that file, which holds the drained and held parity runs against the
JAX package): the free (undrained) run held to JAX's own bars
(tests/test_pipeline.py:60-96: every frame tracked, state OK, ≥ 2
keyframes, rmse < 0.2 m); a worker's error raised by the tracking
thread and by ``shutdown``; a worker that does not finish is an error;
``System.shutdown`` drains the worker before the map is saved.
"""

import os
import threading

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import STEREO
from orbslam2_tpu_torch.runtime import serialization, tracking
from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine
from orbslam2_tpu_torch.runtime.system import System
from test_torch_pipeline import CFG, N_FRAMES, _centre, \
    sequence  # noqa: F401  (the module's fixture)

torch.set_num_threads(2)


def test_free_run_within_jax_bars(sequence):
    """Not drained: the worker maps while tracking runs, as a user drives
    it; JAX's own bars (tests/test_pipeline.py:60-96)."""
    frames, poses = sequence
    eng = AsyncSlamEngine(CFG, enable_loop_closing=False, device="cpu")
    eng.start()
    tracked = sum(eng.track_stereo(left, right, 0.1 * i) is not None
                  for i, (left, right) in enumerate(frames))
    eng.shutdown()
    assert not eng._worker.is_alive()
    assert tracked == len(frames), eng.stats
    assert eng.state == tracking.OK
    assert eng.stats["kf_inserted"] >= 2, eng.stats
    errs = [np.sum((_centre(Te) - _centre(Tg)) ** 2)
            for Te, Tg in zip(eng.frame_poses(), poses) if Te is not None]
    rmse = float(np.sqrt(np.mean(errs)))
    assert rmse < 0.2, (rmse, eng.stats)


def test_worker_error_is_raised(sequence):
    """A failed mapping step on the worker is raised by the tracking
    thread's next ``track_stereo`` and by ``shutdown``."""
    frames, _ = sequence
    eng = AsyncSlamEngine(CFG, enable_loop_closing=False, device="cpu")

    def broken(*args, **kwargs):
        raise ValueError("mapping step failed")

    eng._run_mapping_step = broken
    eng.start()
    i = 0
    while not eng._token and i < N_FRAMES:     # until a keyframe is queued
        eng.track_stereo(*frames[i], 0.1 * i)
        i += 1
    eng._worker.join(timeout=60)
    assert not eng._worker.is_alive() and i < N_FRAMES
    with pytest.raises(RuntimeError, match="mapping worker failed") as e:
        eng.track_stereo(*frames[i], 0.1 * i)
    assert isinstance(e.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="mapping worker failed"):
        eng.shutdown()


def test_shutdown_raises_on_a_worker_that_does_not_finish(sequence):
    """A worker still mapping when ``shutdown``'s join times out is an
    error, not a silent return."""
    frames, _ = sequence
    eng = AsyncSlamEngine(CFG, enable_loop_closing=False, device="cpu")
    release = threading.Event()
    eng._map_job = lambda tok: release.wait(60)
    i = 0
    while not eng._token:                      # until a keyframe is queued
        eng.track_stereo(*frames[i], 0.1 * i)
        i += 1
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="did not finish"):
            eng.shutdown(timeout=0.2)
    finally:
        release.set()
        eng._worker.join(timeout=60)
    assert not eng._worker.is_alive()


def test_system_shutdown_drains_the_worker(sequence, tmp_path):
    """``System.shutdown`` with an async engine joins the worker, which
    maps the keyframe still queued, before the map is saved."""
    frames, _ = sequence
    path = str(tmp_path / "map.npz")
    sys_ = System(None, None, STEREO, save_map=True,
                  config=CFG.replace(map_file=path), device="cpu")
    eng = AsyncSlamEngine(sys_.cfg, device="cpu")       # loop closing on
    sys_.engine = eng
    i = 0
    while not eng.kf_queue.size():
        assert sys_.track_stereo(*frames[i], 0.1 * i) is not None, i
        i += 1
    assert eng.stats["kf_inserted"] == 1 and eng._jobs
    eng.start()
    sys_.shutdown()
    assert not eng._worker.is_alive() and not eng._jobs
    assert eng.stats["kf_inserted"] == 2
    assert os.path.exists(path)
    ms, _, counters = serialization.load_map(path, device="cpu")
    assert int(ms.kf_valid.sum()) == 2 and counters["kf_ordinal"] == 2
