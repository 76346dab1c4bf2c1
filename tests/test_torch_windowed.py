"""The windowed stereo engine and the streaming LOC tracker of the port
against the JAX package, plus scripted checks of the windowed engine's
own rules (runtime/windowed.py).

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
  * one window of ``streaming.make_window_tracker`` on the same map:
    same tolerances;
  * 12 frames through both ``WindowedSlamEngine(window=4)``, loop closing
    off, ``_mapper_idle`` patched to True on both (whether a device
    program has finished is timing; ADVICE.md r5): neither LOST, keyframe
    counts within ±1, ATE < 0.05 m and within 0.01 m of the JAX ATE;
    after their closing ``flush()``, the next window's stale
    constant-velocity prediction the same in both (centres within
    0.01 m).

The scripted tests replace the window tracker and the mapping step with
stand-ins and pin the rules the per-frame engine does not have:
dispatch before retire, the counter hand-off, ``ref_override``, the busy
mapper, loop closing inside the retire, stats read at the next retire,
and the LOST re-runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.runtime import streaming as jstreaming
from orbslam2_tpu.runtime.slam import SlamEngine as JaxSlamEngine
from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxWindowed
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import map_state_from_numpy, to_tensor
from orbslam2_tpu_torch.ops import hamming_top2 as tk
from orbslam2_tpu_torch.runtime import streaming as tstreaming
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime import windowed as twindowed
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchSlamEngine
from orbslam2_tpu_torch.runtime.windowed import (SlamWindowOut,
                                                 WindowedSlamEngine)

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
    frames = [synthetic.render_world_stereo(world, CAM, T, rng, noise=1.0)
              for T in poses]
    jolted = [synthetic.render_world_stereo(
        world, CAM, _yawed(T, JOLT_YAW) if i == JOLT_FRAME else T, rng,
        noise=1.0) for i, T in enumerate(poses) if i >= N_ENGINE]
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
    hand_over_frontend(monkeypatch)
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


def test_streaming_tracker_matches_jax(corridor, jax_engine):
    _, frames, _ = corridor
    window = frames[N_ENGINE:N_ENGINE + 4]
    sT, assoc0, _, ref_kf = _start_state(jax_engine)
    flat = jstreaming.pack_window_uint8(window)
    np.testing.assert_array_equal(tstreaming.pack_window_uint8(window), flat)
    jres = jstreaming.make_window_tracker(JCFG, 4)(
        jax_engine.ms, jnp.asarray(flat), jnp.asarray(sT),
        jnp.asarray(assoc0), jnp.int32(ref_kf))
    track = tstreaming.make_window_tracker(TCFG, 4, device="cpu")
    tres = track(_port_map(jax_engine), flat, sT, assoc0, ref_kf)
    jsm = np.asarray(jres.summaries)
    assert (jsm[:, 34] >= 30).all(), jsm[:, 34]
    _assert_summaries(tres.summaries.numpy(), jsm)
    np.testing.assert_array_equal(tres.assoc.numpy(), np.asarray(jres.assoc))
    np.testing.assert_array_equal(tres.counters.numpy(),
                                  np.asarray(jres.counters))
    np.testing.assert_allclose(tres.state_T.numpy(), np.asarray(jres.state_T),
                               atol=1e-4, rtol=0)


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


# --------------------------------------------------- base-engine hooks ----

def test_need_new_keyframe_matches_jax():
    """The port's NeedNewKeyFrame, idle and busy, with and without
    ref_override, decides as the JAX engine's on the same summaries and
    counts."""
    from orbslam2_tpu.runtime import tracking as jtracking

    jeng = JaxSlamEngine(JCFG, enable_loop_closing=False)
    teng = TorchSlamEngine(TCFG, enable_loop_closing=False, device="cpu")
    rng = np.random.default_rng(5)
    n_true = 0
    for k in range(600):
        v = np.zeros(40, np.float32)
        v[32:39] = rng.integers(0, 400, 7)
        idle, queue = bool(k % 3), int(rng.integers(0, 5))
        override = int(rng.integers(0, 400)) if k % 4 == 0 else None
        frame_id, ordinal = int(rng.integers(0, 30)), 1 + k % 5
        decided = []
        for eng, sm in ((jeng, jtracking.Summary(v)),
                        (teng, ttracking.Summary(v))):
            eng.frame_id, eng.last_kf_frame_id = frame_id, 0
            eng.kf_ordinal = ordinal
            eng._mapper_idle = lambda: idle
            eng._mapping_queue_len = lambda: queue
            decided.append(eng._need_new_keyframe(sm, override))
        assert decided[0] == decided[1], (k, v[32:39], idle, queue, override)
        n_true += decided[0]
    assert 50 < n_true < 550, n_true


def test_base_engine_hooks():
    eng = TorchSlamEngine(TCFG, enable_loop_closing=False, device="cpu")
    assert eng._mapper_idle() is True
    assert eng._mapping_queue_len() == 0
    assert eng._interrupt_ba() is None
    vis, fnd = eng._counter_args()
    assert vis is eng._zeros_p and fnd is eng._zeros_p


# ----------------------------------------------- scripted windowed rules --

TINY = tconfig.SlamConfig(
    camera=tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                                bf=75.0, width=320, height=240, fps=10.0,
                                th_depth=60.0),
    orb=tconfig.OrbConfig(n_features=200),
    capacity=tconfig.CapacityConfig(max_keyframes=8, max_map_points=256,
                                    local_ba_keyframes=2,
                                    local_ba_points=64),
    sensor=STEREO)
W = 4
NI = 100                           # a tracked frame's map inliers
IMG = np.zeros((240, 320), np.uint8)


def _row(frame_id, n_inliers=NI, ref_tracked=400):
    v = np.zeros(40, np.float32)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.1 * frame_id
    v[0:16] = T.reshape(-1)
    v[16:32] = T.reshape(-1)
    v[32:35] = n_inliers
    v[37:39] = ref_tracked
    return v


class Script:
    """Stand-ins for the window tracker and the mapping step, and a log of
    what the engine asked of them."""

    def __init__(self, eng, rows=None, victims=None):
        self.eng = eng
        self.rows = rows or {}              # frame id → summary row
        self.victims = victims or {}        # insert's frame id → culled
        self.log = []
        self.maps = [eng.ms]
        self.outs = []
        self.inserts = []
        eng.f_track_window = self.track_window
        eng.f_window_kf = self.window_kf

    def version(self, ms):
        return next(i for i, m in enumerate(self.maps) if m is ms)

    def track_window(self, ms, pairs, state_T, assoc0, inlier0, ref_kf):
        k = len(self.outs)
        first = 1 + W * k                  # frame 0 initialised the map
        P, N = ms.P, ms.N
        sm = torch.from_numpy(np.stack(
            [self.rows.get(first + i, _row(first + i)) for i in range(W)]))
        out = SlamWindowOut(
            summaries=sm, fds=None, assocs=None, inliers=None, Tcws=None,
            state_T=torch.full((2, 4, 4), float(k)),
            last_assoc=torch.full((N,), k, dtype=torch.int32),
            last_inlier=torch.ones(N, dtype=torch.bool),
            counters=torch.full((2, P), k + 1, dtype=torch.int32))
        self.log.append(("track", k, self.version(ms)))
        self.outs.append((out, state_T, assoc0))
        return out

    def window_kf(self, ms, fds, assocs, Tcws, j, kf_slot, kf_ordinal,
                  parent, frame_id, timestamp, do_ba, do_cull, vis, fnd):
        pose = ms.kf_pose.clone()
        pose[kf_slot] = torch.eye(4)
        pose[kf_slot, 1, 3] = 100.0 + frame_id     # a new keyframe's pose
        ms2 = ms._replace(kf_pose=pose,
                          kf_parent=ms.kf_parent.clone().index_fill_(
                              0, torch.tensor([kf_slot]), parent))
        self.maps.append(ms2)
        self.log.append(("insert", frame_id, self.version(ms2)))
        self.inserts.append((frame_id, int(vis[0]), int(fnd[0])))
        culled = self.victims.get(frame_id, [])
        stats = torch.tensor([5, 1, 2, 3, 4, len(culled), 77]
                             + (culled + [-1, -1])[:2], dtype=torch.int32)
        return ms2, stats


def _engine(decide=None):
    """A windowed engine past initialisation (keyframe 0 at frame 0), its
    window tracker and mapping step scripted; ``decide(frame_id)`` stands
    in for NeedNewKeyFrame when given."""
    eng = WindowedSlamEngine(TINY, enable_loop_closing=False, device="cpu",
                             window=W)
    N = TINY.orb.n_features_padded
    eng.state = ttracking.OK
    eng.n_kfs = eng.kf_ordinal = 1
    eng._free_kf_slots.discard(0)
    eng.frame_id = eng.last_kf_frame_id = 1
    eng.last_Tcw = np.eye(4, dtype=np.float32)
    eng.last_assoc = torch.zeros(N, dtype=torch.int32)
    eng.last_inlier = torch.ones(N, dtype=torch.bool)
    if decide is not None:
        eng._need_new_keyframe = \
            lambda sm, ref_override=None: decide(eng.frame_id)
    return eng


def _push(eng, first, stop):
    """Frames first .. stop − 1 into the engine."""
    for f in range(first, stop):
        eng.track_stereo(IMG, IMG, 0.1 * f)


def test_window_is_dispatched_before_the_last_window_retires():
    """Window k+1 tracks on the map without window k's keyframes, from
    window k's carried outputs; window k+2 sees them."""
    eng = _engine(decide=lambda f: f == 2)
    s = Script(eng)
    _push(eng, 1, 3 * W + 1)
    assert s.log == [("track", 0, 0), ("track", 1, 0), ("insert", 2, 1),
                     ("track", 2, 1)], s.log
    out0 = s.outs[0][0]
    assert s.outs[1][1] is out0.state_T and s.outs[1][2] is out0.last_assoc
    eng.flush()
    assert len(eng.trajectory) == 3 * W


def test_counters_hand_off_to_the_next_insert():
    """A window's counters go to the first insert after it retires; a
    second insert in the same retire gets zeros, and a window whose retire
    inserts nothing has its counters overwritten by the next window's."""
    # windows (frames): A 1-4, B 5-8, C 9-12, D 13-16, E 17-20
    inserts = {2, 6, 7, 18}        # A: 2; B: 6, 7; C, D: none; E: 18
    eng = _engine(decide=lambda f: f in inserts)
    s = Script(eng)
    _push(eng, 1, 5 * W + 1)
    eng.flush()
    # counters of window k are k + 1; retired: A at B's dispatch, ...
    assert s.inserts == [(2, 0, 0), (6, 1, 1), (7, 0, 0), (18, 4, 4)], \
        s.inserts
    assert eng._pending_counters is not None
    assert int(eng._pending_counters[0, 0]) == 5


def test_ref_override_after_an_in_window_insert():
    """After an insert at frame j, later frames of the same window compare
    their inliers with frame j's, not with the stale reference count: with
    ref_tracked 400 and 100 inliers every frame, only the first frame of
    each window inserts."""
    eng = _engine()
    eng.kf_ordinal = 3
    s = Script(eng)
    _push(eng, 1, 3 * W + 1)
    eng.flush()
    assert [f for f, _, _ in s.inserts] == [1, 5, 9], s.inserts


def test_busy_mapper_blocks_c1b_and_interrupts_ba():
    class Ev:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    eng = _engine()
    eng.kf_ordinal = 3
    interrupts = []
    eng._interrupt_ba = lambda: interrupts.append(1)
    stats = torch.zeros(9, dtype=torch.int32)
    sm = ttracking.Summary(_row(3))          # c2 holds; c1b alone can fire
    eng.frame_id = eng.last_kf_frame_id + 1
    assert eng._mapper_idle() and eng._need_new_keyframe(sm)
    eng._deferred_stats = [(stats, Ev(True)), (stats, Ev(False))]
    assert not eng._mapper_idle() and eng._mapping_queue_len() == 1
    assert not eng._need_new_keyframe(sm) and not interrupts
    # c1a (a second since the last keyframe) fires while busy: the BA is
    # interrupted and the insert queued while fewer than 3 wait
    eng.frame_id = eng.last_kf_frame_id + 10
    assert eng._need_new_keyframe(sm) and interrupts == [1]
    eng._deferred_stats = [(stats, Ev(False))] * 3
    assert not eng._need_new_keyframe(sm) and interrupts == [1, 1]
    eng._deferred_stats = [(stats, None)] * 3          # the CPU: no events
    assert eng._mapper_idle() and eng._mapping_queue_len() == 0


def test_mapping_stats_are_read_at_the_next_retire():
    eng = _engine(decide=lambda f: f in (2, 3))
    Script(eng)
    _push(eng, 1, 2 * W + 1)                   # window A retired
    assert eng.stats["kf_inserted"] == 2
    assert len(eng._deferred_stats) == 2
    assert eng.stats["mp_created"] == 0 and eng.n_live_points == 0
    _push(eng, 2 * W + 1, 3 * W + 1)           # window B retired
    assert eng._deferred_stats == []
    assert eng.stats["mp_created"] == 2 * 7 and eng.n_live_points == 77
    assert eng.stats["mp_fused"] == 2 * 3


def test_loop_closing_runs_inside_the_retire():
    """Detection is dispatched at the insert and evaluated at the next
    retire, before its frames; a closure restarts the motion model from
    the reference keyframe's corrected pose."""
    calls = []

    class Gba:
        def poll_and_merge(self, ms):
            calls.append("merge")
            return ms, False

    class Closer:
        gba = Gba()

        def on_keyframe_deferred(self, ms, kf, kf_ordinal):
            calls.append(("detect", kf, kf_ordinal))

        def poll_deferred(self, ms):
            calls.append("poll")
            return ms, any(c[0] == "detect" for c in calls
                           if isinstance(c, tuple))

    seen = {}

    def decide(f):
        calls.append(("frame", f))
        seen.setdefault(f, (eng.velocity, eng._prev2_Tcw))
        return f == 2

    eng = _engine(decide)
    eng.loop_closer = Closer()
    Script(eng)
    _push(eng, 1, 2 * W + 1)                       # window A retires
    assert calls[:2] == ["poll", "merge"]
    i = calls.index(("detect", 1, 2))
    assert calls[i - 1] == ("frame", 2) and eng.stats["loops_closed"] == 0
    _push(eng, 2 * W + 1, 3 * W + 1)               # window B retires
    j = calls.index(("frame", 5))
    assert calls[j - 2:j] == ["poll", "merge"]
    assert eng.stats["loops_closed"] == 1
    # frame 5's motion model starts from reference keyframe 1's pose
    velocity, prev2 = seen[5]
    np.testing.assert_array_equal(prev2, eng.ms.kf_pose[1].numpy())
    assert prev2[1, 3] == 102.0               # inserted at frame 2
    np.testing.assert_allclose(
        velocity, _row(5)[:16].reshape(4, 4) @ np.linalg.inv(prev2),
        atol=1e-6)


def test_windows_after_a_loop_correction_keep_the_uncorrected_state():
    """JAX's rule, mirrored (ROADMAP Queue 3): a loop corrected inside
    window B's retire moves the map, but B's frames keep the poses tracked
    on the map before it (the re-anchored ``last_Tcw`` is overwritten by
    B's first frame), and window D, dispatched after the correction,
    starts from window C's carried device state, not from the corrected
    reference keyframe: C and D were tracked from pre-correction poses."""
    polls = []

    class Gba:
        def poll_and_merge(self, ms):
            return ms, False

    class Closer:
        gba = Gba()

        def on_keyframe_deferred(self, ms, kf, kf_ordinal):
            pass

        def poll_deferred(self, ms):
            polls.append(len(polls))
            if len(polls) != 2:                    # B's retire corrects
                return ms, False
            pose = ms.kf_pose.clone()
            pose[:, 0, 3] += 50.0
            sc.maps.append(ms._replace(kf_pose=pose))
            return sc.maps[-1], True

    eng = _engine(decide=lambda f: False)
    eng.loop_closer = Closer()
    sc = Script(eng)
    _push(eng, 1, 3 * W + 1)                       # windows A, B retire
    assert eng.stats["loops_closed"] == 1
    assert float(eng.ms.kf_pose[0, 0, 3]) == 50.0  # the map moved
    np.testing.assert_array_equal(eng.last_Tcw,
                                  _row(2 * W)[:16].reshape(4, 4))
    _push(eng, 3 * W + 1, 4 * W + 1)               # D dispatched, C retires
    assert len(sc.outs) == 4
    _, state_T, _ = sc.outs[3]
    assert torch.equal(state_T, sc.outs[2][0].state_T)   # C's, stale
    assert eng.trajectory[2 * W - 1].ref_kf == 0


def test_culled_reference_slot_waits_for_its_window():
    """Keyframe 1, the reference of window B (dispatched before window A
    inserted keyframe 2), is culled by that insert's mapping step; the
    cull is read when B retires, before B's own insert at frame 6. The
    insert must not reuse slot 1 while B's frames 7 and 8, measured
    against keyframe 1, are still to be appended: their poses come from
    keyframe 1's pose at the cull, rebased onto its parent."""
    eng = _engine(decide=lambda f: f in (2, 6))
    pose = torch.eye(4).repeat(TINY.capacity.max_keyframes, 1, 1)
    pose[:, 0, 3] = torch.arange(TINY.capacity.max_keyframes) + 10.0
    parent = torch.full((TINY.capacity.max_keyframes,), -1,
                        dtype=torch.int32)
    parent[1] = 0
    eng.ms = eng.ms._replace(kf_pose=pose, kf_parent=parent)
    eng.n_kfs, eng.kf_ordinal, eng.ref_kf = 2, 2, 1
    eng._free_kf_slots.discard(1)
    s = Script(eng, victims={2: [1]})
    _push(eng, 1, 3 * W + 1)
    eng.flush()
    assert [slot for slot in (2, 3)] == sorted(
        set(range(TINY.capacity.max_keyframes)) - eng._free_kf_slots
        - {0, 1})
    assert 1 in eng._free_kf_slots and not eng._held_slots
    poses = eng.frame_poses()
    for f in (7, 8):                    # frames of window B after frame 6
        np.testing.assert_allclose(
            poses[f - 1], _row(f)[16:32].reshape(4, 4) @ pose[1].numpy(),
            atol=1e-5)
    assert [e[0] for e in s.log].count("insert") == 2


def test_lost_frame_reruns_the_window_and_the_one_in_flight(monkeypatch):
    """Frame 2 of window A lost: frames 2-4 re-run through the per-frame
    path, and so does window B, which was tracked from A's junk pose."""
    reruns = []

    def per_frame(self, pair, ts):
        reruns.append(round(ts * 10))
        return None

    monkeypatch.setattr(TorchSlamEngine, "_track_common", per_frame)
    eng = _engine(decide=lambda f: False)
    s = Script(eng, rows={2: _row(2, n_inliers=10)})
    _push(eng, 1, 2 * W + 1)
    assert eng.state == ttracking.LOST and eng.velocity is None
    assert reruns == [2, 3, 4, 5, 6, 7, 8], reruns
    assert len(eng.trajectory) == 1 and eng._pending is None
    assert [e[0] for e in s.log] == ["track", "track"]


def test_in_window_fallback_rule(monkeypatch):
    """The fallback fires below the local-map threshold, matches against
    the reference keyframe from the WINDOW's carried pose, re-runs the
    WIDENED track from its result, and keeps the whole re-run only if the
    reference match held and it tracks more map inliers."""
    P, N = 8, 4
    # per frame: (first track's map inliers, reference-KF matches,
    # re-run's map inliers)
    plan = iter([(20, 40, 25),    # fallback, re-run kept (25 > 20)
                 (20, 40, 20),    # fallback, re-run not better
                 (20, 10, 90),    # fallback, reference match too weak
                 (30, 40, 90)])   # no fallback (30 is the threshold)
    calls, cur = [], {}

    def result(tag, n_mm, n_map):
        s = torch.zeros(40)
        s[32], s[34] = n_mm, n_map
        return ttracking.TrackResult(
            Tcw=torch.full((4, 4), float(tag)),
            assoc=torch.full((N,), tag, dtype=torch.int32),
            inlier=torch.ones(N, dtype=torch.bool), summary=s,
            visible_mask=torch.full((P,), tag == 2),
            found_mask=torch.full((P,), tag == 2))

    class Fns:
        def track_body(self, ms, fd, pred, assoc, ok, ref_kf, widen=True):
            calls.append(("body", widen, float(pred[0, 0]), int(assoc[0])))
            if int(assoc[0]) == 3:              # the re-run (tag 3 below)
                return result(2, 0, cur["plan"][2])
            cur["plan"] = next(plan)
            return result(1, 0, cur["plan"][0])

        def track_ref_kf(self, ms, fd, ref_kf, T_init):
            calls.append(("ref", float(T_init[0, 0])))
            return result(3, cur["plan"][1], 0)

    monkeypatch.setattr(ttracking, "make_tracking_fns", lambda cfg: Fns())
    monkeypatch.setattr(twindowed.frame_mod, "make_frontend_stereo",
                        lambda cfg: lambda left, right: (torch.zeros(1),))
    monkeypatch.setattr(twindowed.frame_mod, "FrameData", lambda *f: f)
    monkeypatch.setattr(twindowed, "constant_velocity_prediction",
                        lambda T1, T2: T1)
    tracker = twindowed.make_slam_window_tracker(TINY, 4)
    ms = type("MS", (), {"P": P, "mp_pos": torch.zeros(1)})()
    out = tracker(ms, [(None, None)] * 4, torch.full((2, 4, 4), 7.0),
                  torch.full((N,), 7, dtype=torch.int32),
                  torch.ones(N, dtype=torch.bool), 0)
    assert [int(t[0, 0]) for t in out.Tcws] == [2, 1, 1, 1]
    assert calls == [
        ("body", True, 7.0, 7), ("ref", 7.0), ("body", True, 3.0, 3),
        ("body", True, 2.0, 2), ("ref", 2.0), ("body", True, 3.0, 3),
        ("body", True, 1.0, 1), ("ref", 1.0),
        ("body", True, 1.0, 1)], calls
    # the kept re-run's visible/found masks, frame 0's only, are counted
    np.testing.assert_array_equal(out.counters.numpy(),
                                  np.ones((2, P), np.int32))
    assert int(out.last_assoc[0]) == 1 and float(out.state_T[1, 0, 0]) == 1


@pytest.mark.parametrize("case", ["localization mode", "window length",
                                  "map on another device"])
def test_windowed_entry_points_refuse(case):
    if case == "localization mode":
        # windows still track; the retire refuses every keyframe insert
        eng = _engine(decide=lambda f: True)
        eng.localization_only = True
        s = Script(eng)
        _push(eng, 1, 2 * W + 1)
        eng.flush()
        assert s.log == [("track", 0, 0), ("track", 1, 0)], s.log
        assert not s.inserts and len(eng.trajectory) == 2 * W
    elif case == "window length":
        ms = type("MS", (), {"P": 4, "mp_pos": torch.zeros(1)})()
        tracker = twindowed.make_slam_window_tracker(TINY, 4)
        with pytest.raises(ValueError, match="the window is 4"):
            tracker(ms, [(None, None)] * 3, None, None, None, 0)
    else:
        track = tstreaming.make_window_tracker(TINY, 1, device="cpu")
        ms = type("MS", (), {"mp_pos": torch.zeros(1, device="meta")})()
        with pytest.raises(ValueError, match="the map is on meta"):
            track(ms, np.zeros(2 * 240 * 320, np.uint8), None, None, 0)


def test_launch_sites_nest():
    with tk.launch_site("window"):
        with tk.launch_site("track_ref_kf"):
            assert tk._site.name == "window/track_ref_kf"
        assert tk._site.name == "window"
    assert tk._site.name is None


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
