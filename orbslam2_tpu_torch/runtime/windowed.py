"""Windowed SLAM engine: W tracked frames per window.

Port of ``orbslam2_tpu/runtime/windowed.py`` for the depth sensors
(stereo pairs, RGB-D gray and depth).  A window tracks W frames in a row
against one map: frontend,
constant-velocity prediction, the two-stage track with its ×2 widen
retry, and the TrackReferenceKeyFrame fallback, all inside the window.
The host then replays the keyframe decision (NeedNewKeyFrame) frame by
frame from the window's stacked summaries, and a frame that needs a
keyframe runs the mapping step on its row of the window's outputs.

Three rules of the JAX engine decide which map each frame sees and what
each keyframe folds in, and the port keeps them:

  * pipeline order: window k+1 is tracked (from window k's carried pose
    and associations) before window k is retired, so it sees the map
    without window k's keyframes;
  * the visible/found counters of a window are summed over its frames and
    handed to the next keyframe insert after the window retires; a
    window whose retire inserts nothing has them overwritten by the next
    window's;
  * the mapping stats stay on the device until the next retire.

One rule differs from the JAX engine: a keyframe culled while a tracked
window that measured its poses against it is not yet retired keeps its
slot until that window's frames are appended.  The JAX engine frees and
may reuse the slot at once, and those frames then take the new
keyframe's pose (ROADMAP.md, Queue 3).

The JAX version runs a window as one device program (``lax.scan``);
here the window is a Python loop over tensors on the device, and the
fallback is a host branch on the frame's inlier count.  Initialization,
LOST and relocalization go through the per-frame engine.  In
localization mode windows still track with ``track_body``; only the
keyframe decision at the retire is skipped (JAX ``windowed.py:415``).
Mono raises in the base engine.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.models import frame as frame_mod
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.ops.hamming_top2 import launch_site
from orbslam2_tpu_torch.runtime import local_mapping, tracking
from orbslam2_tpu_torch.runtime.slam import SlamEngine, TrajectoryEntry
from orbslam2_tpu_torch.runtime.streaming import constant_velocity_prediction


class SlamWindowOut(NamedTuple):
    summaries: torch.Tensor          # [W, 40]
    fds: frame_mod.FrameData         # stacked [W, ...]
    assocs: torch.Tensor             # [W, N]
    inliers: torch.Tensor            # [W, N]
    Tcws: torch.Tensor               # [W, 4, 4]
    state_T: torch.Tensor            # [2, 4, 4] (last, previous)
    last_assoc: torch.Tensor         # [N]
    last_inlier: torch.Tensor        # [N]
    counters: torch.Tensor           # [2, P] int32 (visible, found)


def make_slam_window_tracker(cfg: SlamConfig, window: int):
    """track_window(ms, pairs, state_T, assoc0, inlier0, ref_kf) →
    SlamWindowOut, for ``window`` frames, each the sensor's pair of
    float32 [H, W] tensors on the map's device: (left, right) for
    stereo, (gray, depth) for RGB-D."""
    fns = tracking.make_tracking_fns(cfg)
    frontend = frame_mod.make_frontend(cfg)
    th_local = cfg.tracking.local_map_tracking_threshold
    min_ref = cfg.tracking.min_matches_ref_keyframe

    def track_window(ms: M.MapState, pairs, state_T: torch.Tensor,
                     assoc0: torch.Tensor, inlier0: torch.Tensor,
                     ref_kf: int) -> SlamWindowOut:
        if len(pairs) != window:
            raise ValueError(f"track_window: {len(pairs)} pairs, the window "
                             f"is {window}")
        T_prev, T_prev2 = state_T[0], state_T[1]
        assoc, ok = assoc0, inlier0
        vis = torch.zeros(ms.P, dtype=torch.int32, device=ms.mp_pos.device)
        fnd = torch.zeros_like(vis)
        rows = []
        for pair in pairs:
            fd = frontend(*pair)
            pred = constant_velocity_prediction(T_prev, T_prev2)
            res = fns.track_body(ms, fd, pred, assoc, ok, ref_kf, widen=True)
            sm = res.summary.cpu()
            if float(sm[34]) < th_local:
                # TrackReferenceKeyFrame from the window's carried pose,
                # then the widened two-stage track from its result; the
                # re-run replaces the whole result only if the reference
                # match held and it tracks more map inliers
                # (windowed.py:104-118)
                with launch_site("window"):
                    ref = fns.track_ref_kf(ms, fd, ref_kf, T_prev)
                if float(ref.summary[32]) >= min_ref:
                    res2 = fns.track_body(ms, fd, ref.Tcw, ref.assoc,
                                          ref.inlier, ref_kf, widen=True)
                    if float(res2.summary[34]) > float(sm[34]):
                        res = res2
            vis = vis + res.visible_mask.to(torch.int32)
            fnd = fnd + res.found_mask.to(torch.int32)
            T_prev, T_prev2 = res.Tcw, T_prev
            assoc, ok = res.assoc, res.inlier
            rows.append((res.summary, fd, res.assoc, res.inlier, res.Tcw))
        summaries, fds, assocs, inliers, Tcws = zip(*rows)
        return SlamWindowOut(
            summaries=torch.stack(summaries),
            fds=frame_mod.FrameData(*(torch.stack(f) for f in zip(*fds))),
            assocs=torch.stack(assocs), inliers=torch.stack(inliers),
            Tcws=torch.stack(Tcws), state_T=torch.stack([T_prev, T_prev2]),
            last_assoc=assoc, last_inlier=ok,
            counters=torch.stack([vis, fnd]))

    return track_window


def make_window_mapping_step(cfg: SlamConfig):
    """The per-keyframe mapping step fed by row ``j`` of a window's
    stacked outputs."""
    mstep = local_mapping.make_mapping_step(cfg)

    def window_kf_step(ms, fds, assocs, Tcws, j: int, kf_slot: int,
                       kf_ordinal: int, parent: int, frame_id: int,
                       timestamp: float, do_ba: bool, do_cull: bool, vis,
                       fnd):
        fd = frame_mod.FrameData(*(f[j] for f in fds))
        return mstep(ms, fd, Tcws[j], assocs[j], kf_slot, kf_ordinal,
                     parent, frame_id, timestamp, do_ba, do_cull, vis, fnd)

    return window_kf_step


class WindowedSlamEngine(SlamEngine):
    """Stereo / RGB-D SLAM engine tracking in windows of ``window`` frames.

    ``track_stereo`` / ``track_rgbd`` buffer frames and return the most
    recently retired
    pose (up to 2·window − 1 frames behind; None until the first window
    retires).  :meth:`flush` retires what is in flight; ``frame_poses``
    and ``finish_gba`` flush first.  Runs on the CUDA card unless
    ``device`` names another (``device="cpu"``)."""

    def __init__(self, cfg: SlamConfig, enable_loop_closing: bool = True,
                 device=None, vocabulary=None, window: int = 4):
        super().__init__(cfg, enable_loop_closing=enable_loop_closing,
                         device=device, vocabulary=vocabulary)
        self.window = window
        self.f_track_window = make_slam_window_tracker(cfg, window)
        self.f_window_kf = make_window_mapping_step(cfg)
        self._buf: List[Tuple] = []          # (pair, timestamp)
        self._last_retired: Optional[np.ndarray] = None
        self._pending = None                 # the window in flight
        self._pending_counters = None        # [2, P] for the next insert
        self._deferred_stats: List[Tuple] = []   # (stats, event or None)
        self._prev2_Tcw: Optional[np.ndarray] = None
        self._window_refs: List[int] = []    # refs of unretired windows
        self._held_slots: Set[int] = set()   # culled, not yet reusable

    # --------------------------------------------------------- frame entry
    def track_stereo(self, left, right, timestamp: float):
        if self.state != tracking.OK:
            return super().track_stereo(left, right, timestamp)
        return self._push(self._upload_pair(left, right), timestamp)

    def track_rgbd(self, gray, depth, timestamp: float):
        if self.state != tracking.OK:
            return super().track_rgbd(gray, depth, timestamp)
        return self._push(self._upload_rgbd(gray, depth), timestamp)

    def _push(self, pair, timestamp: float):
        self._buf.append((pair, timestamp))
        if len(self._buf) >= self.window:
            buf, self._buf = self._buf, []
            # dispatch window k+1 from window k's carried outputs, THEN
            # retire window k: tracking runs against a map one window
            # stale, as the reference's tracking thread runs ahead of its
            # busy LocalMapping queue
            disp = self._dispatch_window(buf)
            self._retire_pending()
            if self.state == tracking.OK:
                self._pending = disp
            else:
                # the retired window lost tracking: the in-flight window
                # was predicted from a junk pose; re-run its frames
                # through the per-frame LOST/relocalization path
                self._window_done(disp["ref"])
                for pair2, ts2 in disp["buf"]:
                    self._last_retired = super()._track_common(pair2, ts2)
        return self._last_retired

    def flush(self) -> None:
        """Retire the window in flight, the deferred keyframe and loop
        work, and the partial buffer (through the per-frame path)."""
        self._retire_pending()
        self._retire_kf_stats()
        if self.loop_closer is not None:
            self.ms, closed = self.loop_closer.poll_deferred(self.ms)
            if closed:
                self.stats["loops_closed"] += 1
                self.velocity = None
        buf, self._buf = self._buf, []
        for pair, ts in buf:
            self._last_retired = super()._track_common(pair, ts)

    def finish_gba(self) -> bool:
        self.flush()
        return super().finish_gba()

    def _auto_reset(self) -> None:
        # in-flight state refers to the map being dropped
        self._deferred_stats = []
        self._pending = None
        self._pending_counters = None
        self._prev2_Tcw = None
        self._buf = []
        self._last_retired = None
        self._window_refs = []
        self._held_slots = set()
        super()._auto_reset()

    def frame_poses(self):
        self.flush()
        return super().frame_poses()

    # ------------------------------------------------------------- window
    def _dispatch_window(self, buf):
        """Track the window from the carried state; reads no result."""
        pend = self._pending
        if pend is not None:
            out = pend["out"]
            state_T, assoc0, inl0 = (out.state_T, out.last_assoc,
                                     out.last_inlier)
        else:
            prev2 = self._prev2_Tcw
            if self.velocity is not None and prev2 is not None:
                sT = np.stack([self.last_Tcw, prev2])
            else:
                sT = np.stack([self.last_Tcw, self.last_Tcw])
            state_T, assoc0, inl0 = (self._t(sT), self.last_assoc,
                                     self.last_inlier)
        out = self.f_track_window(self.ms, [p for p, _ in buf], state_T,
                                  assoc0, inl0, self.ref_kf)
        self._window_refs.append(self.ref_kf)
        return {"out": out, "buf": buf, "ref": self.ref_kf}

    def _on_kfs_culled(self, ms, victims: List[int]) -> None:
        """As the base, but a culled keyframe that a tracked, unretired
        window measured its poses against keeps its slot (and with it the
        rebasing entry) until that window's frames are appended: reused
        earlier, the slot would give those frames a new keyframe's pose."""
        super()._on_kfs_culled(ms, victims)
        held = set(victims) & set(self._window_refs)
        self._free_kf_slots -= held
        self._held_slots |= held

    def _window_done(self, ref: int) -> None:
        """A window's frames are appended (or dropped): release the culled
        slots no other unretired window refers to."""
        if ref in self._window_refs:        # not after an auto-reset
            self._window_refs.remove(ref)
        free = self._held_slots - set(self._window_refs)
        self._held_slots -= free
        self._free_kf_slots |= free

    def _retire_kf_stats(self) -> None:
        """Fold the mapping steps' stats, read now (one read per step)."""
        pending, self._deferred_stats = self._deferred_stats, []
        for stats_dev, _event in pending:
            stats = stats_dev.cpu().numpy()
            self.stats["mp_created"] += int(stats[0]) + int(stats[2])
            self.stats["mp_culled"] += int(stats[1])
            self.stats["mp_fused"] += int(stats[3])
            self.stats["ba_outliers"] += int(stats[4])
            self.stats["kf_culled"] += int(stats[5])
            self.n_live_points = int(stats[6])
            victims = [int(v) for v in stats[7:] if v >= 0]
            if victims:
                self._on_kfs_culled(self.ms, victims)

    def _retire_pending(self) -> None:
        pend = self._pending
        if pend is None:
            self._retire_kf_stats()
            return
        self._pending = None
        out, buf, ref_at_track = pend["out"], pend["buf"], pend["ref"]
        t = self.cfg.tracking
        sms = out.summaries.cpu().numpy()      # the one read per window
        self._retire_kf_stats()                # the last window's mapping
        if self.loop_closer is not None:
            self.ms, closed = self.loop_closer.poll_deferred(self.ms)
            self.ms, merged = self.loop_closer.gba.poll_and_merge(self.ms)
            if closed or merged:
                self.stats["loops_closed"] += int(closed)
                # poses moved wholesale: restart the motion model
                self.velocity = None
                self.last_Tcw = self.ms.kf_pose[self.ref_kf].cpu().numpy()

        # every frame of the window may insert; after an in-window insert,
        # later frames' c2 compares against the inserting frame's inliers
        ref_override = None
        for j, (pair, ts) in enumerate(buf):
            sm = tracking.Summary(sms[j])
            if sm.n_inliers_map < t.local_map_tracking_threshold:
                # frames from j on tracked from a junk pose: re-run them
                # through the per-frame LOST/relocalization path
                self.state = tracking.LOST
                self.velocity = None
                self._window_done(ref_at_track)
                for pair2, ts2 in buf[j:]:
                    self._last_retired = super()._track_common(pair2, ts2)
                return
            self._append_traj(TrajectoryEntry(ts, sm.Tcr, ref_at_track,
                                              False))
            if self.last_Tcw is not None:
                self.velocity = sm.Tcw @ np.linalg.inv(self.last_Tcw)
            self._prev2_Tcw = self.last_Tcw
            self.last_Tcw = sm.Tcw
            # keyframe decision before the frame id advances; none in
            # localization mode
            if (not self.localization_only
                    and self._need_new_keyframe(sm, ref_override)):
                self._create_window_keyframe(out, j, ts)
                ref_override = sm.n_inliers_map
            self.frame_id += 1
        self._window_done(ref_at_track)
        self.state = tracking.OK
        self.last_assoc = out.last_assoc
        self.last_inlier = out.last_inlier
        self._pending_counters = out.counters
        self._last_retired = self.last_Tcw

    # ------------------------------------------------- mapper bookkeeping
    def _mapper_idle(self) -> bool:
        """LocalMapping::AcceptKeyFrames: busy while a mapping step is
        still running on the card (its event not reached).  On the CPU
        torch runs synchronously, so the mapper is always idle here."""
        return all(ev is None or ev.query()
                   for _, ev in self._deferred_stats)

    def _mapping_queue_len(self) -> int:
        return sum(0 if ev is None or ev.query() else 1
                   for _, ev in self._deferred_stats)

    def _counter_args(self):
        c = self._pending_counters
        if c is None:
            return self._zeros_p, self._zeros_p
        self._pending_counters = None
        return c[0], c[1]

    def _create_window_keyframe(self, out: SlamWindowOut, j: int,
                                timestamp: float) -> None:
        kf_slot = self._take_kf_slot()
        vis, fnd = self._counter_args()
        ms, stats_dev = self.f_window_kf(
            self.ms, out.fds, out.assocs, out.Tcws, j, kf_slot,
            self.kf_ordinal, self.ref_kf, self.frame_id, timestamp,
            self.kf_ordinal >= 3, self.kf_ordinal >= 5, vis, fnd)
        # the stats are read at the next retire, not now
        event = None
        if stats_dev.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._deferred_stats.append((stats_dev, event))
        self.ms = ms
        self.kf_ordinal += 1
        self.n_kfs += 1
        self.stats["kf_inserted"] += 1
        self.ref_kf = kf_slot
        self.last_kf_frame_id = self.frame_id
        if self.loop_closer is not None:
            # detection prologue now, evaluation at the next retire
            self.loop_closer.on_keyframe_deferred(self.ms, kf_slot,
                                                  self.kf_ordinal)
