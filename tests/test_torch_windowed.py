"""The windowed stereo engine of the port against the JAX package.  The
streaming LOC tracker on the same corridor and JAX map:
tests/test_torch_streaming.py; the scripted checks of the windowed
engine's own rules (runtime/windowed.py): tests/test_torch_windowed_rules.py.

Parity, on the CPU at 640×480, 400 features, 16 keyframes, 4096 points:

  * one window of ``make_slam_window_tracker`` on a map built by the JAX
    windowed engine (carried across by ``convert.py``), over four frames
    of which one is jolted (a 0.12 rad yaw), so that three frames take the
    in-window TrackReferenceKeyFrame fallback and keep its re-run:
    summaries' integer fields, associations, inlier masks and counters
    identical; poses within 1e-4 (float32 pose optimisation, other
    summation order; 7e-6 seen); the port is handed JAX's frontend
    (tests/jax_angles.py: the pyramids, the IC angles' moment sums and
    the stereo SAD round by the host CPU, and a resized level's ULP
    flipped one descriptor bit), and the frames' descriptors are held
    bit-exact;
  * 12 frames through both ``WindowedSlamEngine(window=4)``, loop closing
    off, ``_mapper_idle`` patched to True on both (whether a device
    program has finished is timing; ADVICE.md r5): neither LOST, keyframe
    counts within ±1, ATE < 0.05 m and within 0.01 m of the JAX ATE;
    after their closing ``flush()``, the next window's stale
    constant-velocity prediction the same in both (centres within
    0.01 m).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxWindowed
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import map_state_from_numpy, to_tensor
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime import windowed as twindowed
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.utils import render_pool

from jax_angles import hand_over_frontend

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)
CAP = CapacityConfig(max_keyframes=16, max_map_points=4096,
                     local_ba_keyframes=8, local_ba_points=1024)
JCFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=400), capacity=CAP,
                  sensor=STEREO)
N_ENGINE = 12                    # frames through both engines
JOLT_FRAME, JOLT_YAW = 13, 0.12  # inside the parity window (frames 12-15)


def _tcfg(cfg):
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=tconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
        capacity=tconfig.CapacityConfig(**dataclasses.asdict(cfg.capacity)),
        sensor=cfg.sensor)


TCFG = _tcfg(JCFG)


def _ate(poses_est, poses_gt):
    errs = [np.sum((-Te[:3, :3].T @ Te[:3, 3]
                    + Tg[:3, :3].T @ Tg[:3, 3]) ** 2)
            for Te, Tg in zip(poses_est, poses_gt) if Te is not None]
    return float(np.sqrt(np.mean(errs))), len(errs)


def _yawed(T, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    Y = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                 T.dtype)
    return Y @ T


def _u8(frames):
    return [(np.ascontiguousarray(l, dtype=np.uint8),
             np.ascontiguousarray(r, dtype=np.uint8)) for l, r in frames]


def _pairs(frames):
    return [(torch.from_numpy(l.astype(np.float32)),
             torch.from_numpy(r.astype(np.float32))) for l, r in _u8(frames)]


@pytest.fixture(scope="module")
def corridor():
    """The corridor walk: 12 engine frames, then four window frames with a
    yaw jolt at frame 13, and the same four frames unjolted."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(N_ENGINE + 4, step=0.25)
    # on threads, bit-equal to the sequential loop (the same noise draws)
    frames = render_pool.render_frames(synthetic.render_world_stereo, world,
                                       CAM, poses, rng)
    jolted = render_pool.render_frames(
        synthetic.render_world_stereo, world, CAM,
        [_yawed(T, JOLT_YAW) if i == JOLT_FRAME else T
         for i, T in enumerate(poses) if i >= N_ENGINE], rng)
    return poses, _u8(frames), _u8(jolted)


@pytest.fixture(scope="module")
def jax_engine(corridor):
    poses, frames, _ = corridor
    eng = JaxWindowed(JCFG, enable_loop_closing=False, window=4)
    eng._mapper_idle = lambda: True
    for i in range(N_ENGINE):
        eng.track_stereo(*frames[i], 0.1 * i)
    eng.flush()
    assert eng.state == 2
    return eng


def _start_state(jeng):
    sT = np.stack([jeng.last_Tcw, jeng._prev2_Tcw]).astype(np.float32)
    return (sT, np.array(jeng.last_assoc), np.array(jeng.last_inlier),
            int(jeng.ref_kf))


def _port_map(jeng):
    return map_state_from_numpy({k: np.asarray(v)
                                 for k, v in jeng.ms._asdict().items()})


def _assert_summaries(tsm, jsm):
    np.testing.assert_array_equal(tsm[:, 32:40], jsm[:, 32:40])
    np.testing.assert_allclose(tsm[:, :32], jsm[:, :32], atol=1e-4, rtol=0)


# ---------------------------------------------------------------- parity --

def test_window_tracker_matches_jax_with_in_window_fallback(
        corridor, jax_engine, monkeypatch):
    _, _, jolted = corridor
    sT, assoc0, inl0, ref_kf = _start_state(jax_engine)
    payload = tuple(jnp.asarray(np.concatenate([l.reshape(-1), r.reshape(-1)]))
                    for l, r in jolted)
    jout = jax_engine.f_track_window(
        jax_engine.ms, payload, jnp.asarray(sT), jnp.asarray(assoc0),
        jnp.asarray(inl0), jnp.int32(ref_kf))

    fallbacks = []
    make_fns = ttracking.make_tracking_fns

    def recording_fns(cfg):
        fns = make_fns(cfg)

        def track_ref_kf(*args):
            fallbacks.append(args[2])
            return fns.track_ref_kf(*args)

        return fns._replace(track_ref_kf=track_ref_kf)

    monkeypatch.setattr(ttracking, "make_tracking_fns", recording_fns)
    hand_over_frontend(monkeypatch, jax_engine=jax_engine)
    tracker = twindowed.make_slam_window_tracker(TCFG, 4)
    tout = tracker(_port_map(jax_engine), _pairs(jolted), to_tensor(sT),
                   to_tensor(assoc0), to_tensor(inl0), ref_kf)

    # the jolted frame and the two after it (their constant-velocity
    # prediction carries the jolt) take the fallback
    assert len(fallbacks) == 3, fallbacks
    jsm = np.asarray(jout.summaries)
    assert (jsm[:, 34] >= 30).all(), jsm[:, 34]
    _assert_summaries(tout.summaries.numpy(), jsm)
    for f in ("assocs", "inliers", "counters", "last_assoc", "last_inlier"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)), f)
    for f in ("Tcws", "state_T"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(tout.fds.desc.numpy().view(np.uint32),
                                  np.asarray(jout.fds.desc))


@pytest.fixture(scope="module")
def port_engine(corridor):
    """The port's engine over the JAX fixture's frames, ended as it is."""
    _, frames, _ = corridor
    eng = WindowedSlamEngine(TCFG, enable_loop_closing=False, device="cpu",
                             window=4)
    eng._mapper_idle = lambda: True
    for i in range(N_ENGINE):
        eng.track_stereo(*frames[i], 0.1 * i)
    eng.flush()
    return eng


def test_windowed_engine_tracks_like_jax_engine(corridor, jax_engine,
                                                port_engine):
    poses, _, _ = corridor
    teng = port_engine
    t_poses = teng.frame_poses()
    assert teng.state == jax_engine.state == 2
    j_ate, jn = _ate(jax_engine.frame_poses(), poses[:N_ENGINE])
    t_ate, tn = _ate(t_poses, poses[:N_ENGINE])
    assert jn == tn == N_ENGINE
    assert abs(teng.stats["kf_inserted"]
               - jax_engine.stats["kf_inserted"]) <= 1, \
        (teng.stats, jax_engine.stats)
    assert t_ate < 0.05, t_ate
    assert abs(t_ate - j_ate) < 0.01, (t_ate, j_ate)


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def test_flush_leaves_the_next_window_prediction_stale_as_jax_does(
        corridor, jax_engine, port_engine):
    """JAX's rule, mirrored (ROADMAP Queue 3): ``flush()`` retires window
    B (frames 5-8), which sets ``_prev2_Tcw`` to frame 7, then tracks the
    partial window (frames 9-11) frame by frame, which moves ``last_Tcw``
    and ``velocity`` but not ``_prev2_Tcw``.  The next window's
    constant-velocity prediction, last · prev2⁻¹ · last, then spans four
    frames (to about frame 15), where the per-frame one, velocity · last,
    spans one (frame 12).  Centres within 0.01 m across the packages (the
    whole-engine tolerance above), 0.05 m of the ground truth."""
    poses, _, _ = corridor
    got = {}
    for name, eng in (("jax", jax_engine), ("port", port_engine)):
        assert eng._pending is None and not eng._buf, name
        assert eng.velocity is not None, name
        last = np.asarray(eng.last_Tcw, np.float64)
        prev2 = np.asarray(eng._prev2_Tcw, np.float64)
        window_pred = last @ np.linalg.inv(prev2) @ last
        frame_pred = np.asarray(eng.velocity, np.float64) @ last
        got[name] = [_centre(T) for T in (prev2, last, window_pred,
                                          frame_pred)]
        for c, f in zip(got[name], (7, N_ENGINE - 1, N_ENGINE + 3,
                                    N_ENGINE)):
            assert np.linalg.norm(c - _centre(poses[f])) < 0.05, \
                (name, f, c, _centre(poses[f]))
    for cj, ct in zip(got["jax"], got["port"]):
        assert np.linalg.norm(cj - ct) < 0.01, (cj, ct)


# ------------------------------------------------------ the bench sequence --

@pytest.mark.slow
def test_bench_sequence_both_engines_loop_closing_on():
    """The bench.py stereo sequence (its world, its 0.25 m steps, noise
    1.0), first 76 frames (the bench's 28 warm-up frames and one 48-frame
    pass, the span of its ATE), loop closing on, at this file's widths
    with 32 keyframes and 8192 points (the bench's 1000 features / 128
    keyframes / 16k points are not run on a CPU).  Both engines track
    every frame; the port's ATE is under the cv2 proxy's 0.1127 m, and
    the two engines' median centre errors are within 0.01 m.  The JAX
    engine's ATE is not held to the bar: it reuses the slot of a culled
    keyframe that an unretired window still measures against, and those
    frames take the new keyframe's pose (ROADMAP.md, Queue 3; 0.21 m in
    one run here, the port 0.03 m)."""
    n = 76
    cap = dataclasses.replace(CAP, max_keyframes=32, max_map_points=8192)
    jcfg = dataclasses.replace(JCFG, capacity=cap)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(n, step=0.25)
    frames = _u8([synthetic.render_world_stereo(world, CAM, T, rng,
                                                noise=1.0) for T in poses])
    jeng = JaxWindowed(jcfg, enable_loop_closing=True, window=4)
    teng = WindowedSlamEngine(_tcfg(jcfg), enable_loop_closing=True,
                              device="cpu", window=4)
    errs = []
    for eng in (jeng, teng):
        eng._mapper_idle = lambda: True
        for i, (left, right) in enumerate(frames):
            eng.track_stereo(left, right, 0.1 * i)
        eng.finish_gba()
        est = eng.frame_poses()
        assert len(est) == n and all(T is not None for T in est)
        errs.append(np.array([np.linalg.norm(
            -Te[:3, :3].T @ Te[:3, 3] + Tg[:3, :3].T @ Tg[:3, 3])
            for Te, Tg in zip(est, poses)]))
    j_err, t_err = errs
    t_ate = float(np.sqrt(np.mean(t_err ** 2)))
    j_ate = float(np.sqrt(np.mean(j_err ** 2)))
    assert t_ate < 0.1127, (t_ate, j_ate, teng.stats)
    assert abs(np.median(t_err) - np.median(j_err)) < 0.01, \
        (np.median(t_err), np.median(j_err), t_ate, j_ate)
