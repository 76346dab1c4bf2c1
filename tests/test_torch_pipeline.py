"""The port's async tracking/mapping pipeline
(``orbslam2_tpu_torch/runtime/pipeline.py``) against the JAX package's
``AsyncSlamEngine``, on the CPU.

Async runs depend on timing, so the parity runs take the timing out:
either the worker is drained after every frame (``_drain``: no job left
in ``_jobs`` and the worker not busy — a job leaves ``_jobs`` only after
the worker has set ``_worker_busy``), or it is held (frames tracked
before ``start()`` until two keyframe jobs wait), in both packages.

Sequence: tests/test_pipeline.py's scene (900 sprites, extent (14, 9,
40), nearest 3 m) and 16 frames of ``straight_trajectory(16, 0.25)``,
rendered with the port's copy of ``synthetic``; 640×480, 400 features,
64 keyframes; loop closing off.

The drained run's port engine takes JAX's frontend (tests/jax_angles.py:
its pyramids, IC angles and stereo SAD sum in a host-dependent float
order), since its keyframe count is held exact.

Tolerances: keyframe count and slots equal; each frame's camera centre
within 0.01 m of JAX's (the per-frame engines' parity tests hold the ATE
within 0.01-0.03 m); the counter sums handed to each mapping step within
0.5% of JAX's in total (the point slots part, and a found count at an
inlier threshold can differ by one; see the test) and their accumulation
equal on the same masks;
after the held run, keyframe poses within 1e-3 (rotation) / 1e-3 m and the
live map point count within 2%.  The free (undrained) run is held to JAX's
own bars (tests/test_pipeline.py:60-96): every frame tracked, state OK,
≥ 2 keyframes, rmse < 0.2 m.
"""

import dataclasses
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.config import CameraConfig as JCam
from orbslam2_tpu.config import CapacityConfig as JCap
from orbslam2_tpu.config import OrbConfig as JOrb
from orbslam2_tpu.config import SlamConfig as JCfg
from orbslam2_tpu.runtime.pipeline import AsyncSlamEngine as JaxAsync
from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.runtime import serialization, tracking
from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.utils import synthetic

from jax_angles import hand_over_frontend

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)
CAP = CapacityConfig(max_keyframes=64, max_map_points=1 << 14,
                     local_ba_keyframes=8, local_ba_points=2048)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=400), capacity=CAP,
                 sensor=STEREO)
JCFG = JCfg(camera=JCam(**dataclasses.asdict(CAM)), orb=JOrb(n_features=400),
            capacity=JCap(**dataclasses.asdict(CAP)), sensor=STEREO)
N_FRAMES = 16
CENTRE_TOL = 0.01


@pytest.fixture(scope="module")
def sequence():
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, 900, extent=(14.0, 9.0, 40.0),
                                 z_near=3.0)
    poses = synthetic.straight_trajectory(N_FRAMES, step=0.25)
    frames = [synthetic.render_stereo(scene, CAM, T, rng, 1.0)
              for T in poses]
    return frames, poses


def _drain(eng, timeout=120.0):
    """Wait until the worker has mapped every queued keyframe."""
    t_end = time.monotonic() + timeout
    while eng._jobs or eng._worker_busy:
        assert time.monotonic() < t_end, "the worker did not drain"
        time.sleep(0.002)


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _spy_mapping(eng):
    """Record (ba_ok, visible sums, found sums) of every mapping step."""
    calls = []
    step = eng._run_mapping_step

    def spy(ms, fd, Tcw, assoc, kf_slot, parent, frame_id, ts, ba_ok,
            counters=None):
        vis, found = counters
        calls.append((ba_ok, np.asarray(vis), np.asarray(found)))
        return step(ms, fd, Tcw, assoc, kf_slot, parent, frame_id, ts,
                    ba_ok=ba_ok, counters=counters)

    eng._run_mapping_step = spy
    return calls


def _drained_run(eng, frames):
    calls = _spy_mapping(eng)
    eng.start()
    out = []
    for i, (left, right) in enumerate(frames):
        out.append(eng.track_stereo(left, right, 0.1 * i))
        _drain(eng)
    eng.shutdown()
    return out, calls


def _share_programs(dst, src):
    """Give a second JAX engine the first one's compiled step functions
    (the same config), so that the module compiles them once."""
    for name in ("frontend", "fns", "f_track", "f_track_ref", "f_pose_cov",
                 "f_apply_counters", "f_init", "f_track_frame",
                 "f_track_frame_loc", "f_mapping_step"):
        setattr(dst, name, getattr(src, name))


@pytest.fixture(scope="module")
def drained(sequence):
    frames, _ = sequence
    jeng = JaxAsync(JCFG, enable_loop_closing=False)
    with pytest.MonkeyPatch.context() as mp:
        hand_over_frontend(mp)
        teng = AsyncSlamEngine(CFG, enable_loop_closing=False, device="cpu")
    return ((jeng,) + _drained_run(jeng, frames),
            (teng,) + _drained_run(teng, frames))


def test_drained_run_matches_jax(drained, sequence):
    (jeng, jout, _), (teng, tout, _) = drained
    _, poses = sequence
    assert all(T is not None for T in tout) and teng.state == tracking.OK
    assert teng.stats["kf_inserted"] == jeng.stats["kf_inserted"] >= 3, \
        (teng.stats, jeng.stats)
    np.testing.assert_array_equal(teng.ms.kf_valid.numpy(),
                                  np.asarray(jeng.ms.kf_valid))
    for i, (Tt, Tj) in enumerate(zip(tout, jout)):
        assert np.linalg.norm(_centre(Tt) - _centre(np.asarray(Tj))) \
            < CENTRE_TOL, i
    for Tt, Tj in zip(teng.frame_poses(), jeng.frame_poses()):
        assert np.linalg.norm(_centre(Tt) - _centre(Tj)) < CENTRE_TOL


def test_counter_sums_match_jax(drained):
    """The visible/found sums tracking accumulated between keyframes, as
    each mapping step received them.  Their totals agree within 0.5% (at
    least 2): the runs' map point slots part after the first insertions,
    where one package triangulates a point the other does not, so the
    sums are not compared slot by slot."""
    (_, _, jcalls), (_, _, tcalls) = drained
    assert len(tcalls) == len(jcalls) >= 2
    _sums_agree(jcalls, tcalls)
    assert tcalls[0][1].sum() > 0 and tcalls[0][2].sum() > 0


def _sums_agree(jcalls, tcalls):
    for (jb, jv, jf), (tb, tv, tf) in zip(jcalls, tcalls):
        assert tb == jb and tv.dtype == tf.dtype == np.int32
        for t, j in ((tv, jv), (tf, jf)):
            assert abs(int(t.sum()) - int(j.sum())) <= max(2, 0.005 * j.sum())


def test_counter_accumulation_matches_jax(drained):
    """``_absorb_track`` / ``_counter_args`` on the same masks in both
    packages: int32 sums, handed over and reset, zeros when nothing was
    absorbed since the last hand-over."""
    (jeng, _, _), (teng, _, _) = drained
    jeng._counter_args(), teng._counter_args()     # the run's last frames
    rng = np.random.default_rng(7)
    P = CAP.max_map_points
    for n_frames in (3, 0, 1, 5):
        for _ in range(n_frames):
            vis = rng.random(P) < 0.3
            found = vis & (rng.random(P) < 0.6)
            jeng._absorb_track(None, types.SimpleNamespace(
                visible_mask=jnp.asarray(vis), found_mask=jnp.asarray(found)))
            teng._absorb_track(None, types.SimpleNamespace(
                visible_mask=torch.from_numpy(vis),
                found_mask=torch.from_numpy(found)))
        (jv, jf), (tv, tf) = jeng._counter_args(), teng._counter_args()
        assert tv.dtype == tf.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert tv.sum() > 0 if n_frames else not tv.any()


def _held_run(eng, frames):
    """Track without a worker until two keyframe jobs wait, then start
    and drain: (frames tracked, mapping calls, _interrupt_ba calls)."""
    calls = _spy_mapping(eng)
    interrupts = []
    interrupt = eng._interrupt_ba
    eng._interrupt_ba = lambda: (interrupts.append(eng.frame_id),
                                 interrupt())
    n = 0
    for i, (left, right) in enumerate(frames):
        assert eng.track_stereo(left, right, 0.1 * i) is not None, i
        n = i + 1
        if eng.kf_queue.size() >= 2:
            break
    eng.start()
    _drain(eng)
    eng.shutdown()
    return n, calls, interrupts


def test_held_worker_matches_jax(drained, sequence):
    """Keyframe decisions that meet a busy mapper (c1b false, the BA
    interrupted, queued while < 3 wait) and a job mapped with
    ``ba_ok=False``, deterministically, in both packages."""
    frames, _ = sequence
    (jprog, _, _), _ = drained
    jeng = JaxAsync(JCFG, enable_loop_closing=False)
    _share_programs(jeng, jprog)
    teng = AsyncSlamEngine(CFG, enable_loop_closing=False, device="cpu")
    jn, jcalls, jint = _held_run(jeng, frames)
    tn, tcalls, tint = _held_run(teng, frames)
    assert tn == jn < N_FRAMES and tint == jint and tint, (tn, jn, tint,
                                                           jint)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert [c[0] for c in tcalls][:2] == [False, True]
    _sums_agree(jcalls, tcalls)
    kv = teng.ms.kf_valid.numpy()
    np.testing.assert_array_equal(kv, np.asarray(jeng.ms.kf_valid))
    tp, jp = teng.ms.kf_pose.numpy()[kv], np.asarray(jeng.ms.kf_pose)[kv]
    np.testing.assert_allclose(tp[:, :3, :3], jp[:, :3, :3], atol=1e-3)
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=1e-3)
    nt, nj = int(teng.ms.mp_valid.sum()), int(np.sum(jeng.ms.mp_valid))
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)


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
