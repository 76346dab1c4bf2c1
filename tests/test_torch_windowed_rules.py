"""Scripted checks of the port's windowed engine's own rules
(runtime/windowed.py), and the base engine's hooks against the JAX
package's NeedNewKeyFrame (moved from tests/test_torch_windowed.py, which
holds the parity runs against the JAX engine).

The scripted tests replace the window tracker and the mapping step with
stand-ins and pin the rules the per-frame engine does not have:
dispatch before retire, the counter hand-off, ``ref_override``, the busy
mapper, loop closing inside the retire, stats read at the next retire,
and the LOST re-runs.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu.config import STEREO
from orbslam2_tpu.runtime.slam import SlamEngine as JaxSlamEngine
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.ops import hamming_top2 as tk
from orbslam2_tpu_torch.runtime import streaming as tstreaming
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime import windowed as twindowed
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchSlamEngine
from orbslam2_tpu_torch.runtime.windowed import (SlamWindowOut,
                                                 WindowedSlamEngine)
from test_torch_windowed import JCFG, TCFG

torch.set_num_threads(2)


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
