"""Host-side SLAM engine: frontend + tracking + local mapping + loop
closing.

Port of ``orbslam2_tpu/runtime/slam.py`` for stereo, RGB-D and mono:
the Tracking::Track state machine (motion model, the ×2 widen retry, the
TrackReferenceKeyFrame fallback, the keyframe decision, relocalization
when LOST) on the host, all array work in tensors on ``device``.  Mono
bootstraps from two frames (MonocularInitialization): a held reference
frame, SearchForInitialization, the H/F initializer with draws from the
engine's own generator, a two-keyframe map and one local BA.  With loop
closing on (the default) every new keyframe goes
through ``LoopCloser.on_keyframe`` and a finished background global BA
is merged after it; ``finish_gba`` drains the last one.  Keyframe and
map-point rows are reused after culling; trajectory entries whose
reference keyframe is culled are rebased onto its parent.

Localization mode (``localization_only = True``) tracks against a map
that does not grow: no keyframe decision, no auto-reset while LOST, and,
once a frame has been tracked, temporal VO points from the previous
frame's depth (depth sensors only: mono has none) with a relocalization
attempt on every VO-mode frame.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import List, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import MONOCULAR, SlamConfig
from orbslam2_tpu_torch.models import frame as frame_mod
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.models import vocabulary as voc_mod
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.runtime import local_mapping, tracking
from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser


@dataclasses.dataclass
class TrajectoryEntry:
    """Per-frame pose relative to its reference keyframe at track time."""

    timestamp: float
    Tcr: np.ndarray
    ref_kf: int
    lost: bool


class SlamEngine:
    """Single-process stereo / RGB-D / mono engine on one torch device: the
    CUDA card unless ``device`` says otherwise (``device="cpu"`` for the
    CPU)."""

    # the mono initializer's draws (JAX: PRNGKey(7), split per attempt)
    MONO_SEED = 7

    def __init__(self, cfg: SlamConfig, enable_loop_closing: bool = True,
                 device=None, vocabulary=None):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.frontend = frame_mod.make_frontend(cfg)
        self.fns = tracking.make_tracking_fns(cfg)
        self.f_mapping_step = local_mapping.make_mapping_step(cfg)
        self.mapping_fns = local_mapping.MappingFns(cfg)
        self.loop_closer: Optional[LoopCloser] = None
        if enable_loop_closing:
            voc = vocabulary if vocabulary is not None else \
                voc_mod.default_vocabulary(k=cfg.capacity.vocab_k,
                                           levels=cfg.capacity.vocab_levels,
                                           device=self.device)
            self.loop_closer = LoopCloser(cfg, voc, self.device)

        self.ms = M.empty_map(cfg, device=self.device)
        self.state = tracking.NO_IMAGES_YET
        self.n_kfs = 0                # LIVE keyframes
        self.kf_ordinal = 0           # keyframes ever inserted (monotonic)
        self.n_live_points = 0
        self.frame_id = 0
        self.last_kf_frame_id = 0
        self.ref_kf = 0
        self.velocity: Optional[np.ndarray] = None
        self.last_Tcw: Optional[np.ndarray] = None
        self.last_assoc = None        # device [N] int32
        self.last_inlier = None       # device [N] bool
        self.last_fd = None
        self._last_image = None       # the viewer's frame (mImGray), host
        self.trajectory: List[TrajectoryEntry] = []
        self.localization_only = False
        self._free_kf_slots = set(range(cfg.capacity.max_keyframes))
        self._capacity_warned = False
        self._zeros_p = torch.zeros(cfg.capacity.max_map_points,
                                    dtype=torch.int32, device=self.device)
        self._traj_lock = threading.Lock()
        self._culled_remap = {}       # victim slot → (parent slot, Tcp)
        self._mono_ref = None         # (FrameData, frame id, timestamp)
        self._mono_gen = torch.Generator(device=self.device)
        self._mono_gen.manual_seed(self.MONO_SEED)
        self.stats = {"kf_inserted": 0, "mp_created": 0, "mp_culled": 0,
                      "kf_culled": 0, "ba_outliers": 0, "reloc": 0,
                      "mp_fused": 0, "loops_closed": 0}

    # --------------------------------------------------------- frame entry
    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float) -> Optional[np.ndarray]:
        """One rectified uint8 stereo pair → Tcw [4, 4] or None (lost)."""
        self._last_image = left
        return self._track_common(self._upload_pair(left, right), timestamp)

    def _upload_pair(self, left: np.ndarray, right: np.ndarray):
        """uint8 images → a pair of float32 [H, W] tensors on the device."""
        def up(img):
            arr = np.ascontiguousarray(img, dtype=np.uint8)
            return torch.from_numpy(arr).to(self.device).to(torch.float32)

        return up(left), up(right)

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> Optional[np.ndarray]:
        """One uint8 gray image and its registered float32 depth image
        (the camera's units) → Tcw [4, 4] or None (lost)."""
        self._last_image = gray
        return self._track_common(self._upload_rgbd(gray, depth), timestamp)

    def track_monocular(self, gray: np.ndarray,
                        timestamp: float) -> Optional[np.ndarray]:
        """One uint8 gray image → Tcw [4, 4] or None (not initialized yet,
        or lost).  The scale is the bootstrap's: the median depth of the
        first two keyframes' points is 1."""
        self._last_image = gray
        return self._track_common(self._upload_mono(gray), timestamp)

    def _upload_mono(self, gray: np.ndarray):
        """uint8 gray → a 1-tuple holding a float32 [H, W] tensor on the
        device."""
        g = torch.from_numpy(np.ascontiguousarray(gray, dtype=np.uint8))
        return (g.to(self.device).to(torch.float32),)

    def _upload_rgbd(self, gray: np.ndarray, depth: np.ndarray):
        """uint8 gray → float32, depth kept float32 as given: a pair of
        [H, W] tensors on the device."""
        g = torch.from_numpy(np.ascontiguousarray(gray, dtype=np.uint8))
        d = torch.from_numpy(np.ascontiguousarray(depth, dtype=np.float32))
        return g.to(self.device).to(torch.float32), d.to(self.device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ----------------------------------------------------- frame overlay
    def _overlay_data(self):
        """(xy_raw [N,2], valid [N], matched [N]) of the latest tracked
        frame on the host, or None before the first frame."""
        fd = self.last_fd
        if fd is None or self.last_assoc is None:
            return None
        matched = self.last_assoc >= 0
        if self.last_inlier is not None:
            matched = matched & self.last_inlier
        return (fd.xy_raw.cpu().numpy(), fd.valid.cpu().numpy(),
                matched.cpu().numpy())

    def frame_overlay(self) -> Optional[bytes]:
        """FrameDrawer::DrawFrame analogue (src/FrameDrawer.cc:34-206):
        the current gray frame annotated with keypoints (green = tracked
        map-point inlier, red = unmatched) and the state text line,
        encoded as PNG by PIL.  Composed lazily — the live viewer calls
        this at its own poll rate, so the tracking hot path never pays for
        it."""
        import io

        from PIL import Image, ImageDraw
        img = self._last_image
        ov = self._overlay_data()
        if img is None or ov is None:
            return None
        xy, valid, matched = ov
        im = Image.fromarray(np.clip(np.asarray(img), 0,
                                     255).astype(np.uint8)).convert("RGB")
        d = ImageDraw.Draw(im)
        n_match = 0
        for i in range(len(xy)):
            if not valid[i]:
                continue
            x, y = float(xy[i, 0]), float(xy[i, 1])
            if matched[i]:
                n_match += 1
                d.rectangle([x - 3, y - 3, x + 3, y + 3],
                            outline=(0, 255, 0))
            else:
                d.ellipse([x - 1.5, y - 1.5, x + 1.5, y + 1.5],
                          outline=(255, 80, 80))
        if self.state == tracking.LOST:
            text = "TRYING TO RELOCALIZE"
        elif self.state != tracking.OK:
            text = "WAITING FOR IMAGES" if self.state < 1 \
                else "TRYING TO INITIALIZE"
        else:
            mode = ("LOCALIZATION" if self.localization_only else
                    "SLAM MODE")
            text = (f"{mode} | KFs: {self.n_kfs}, MPs: "
                    f"{self.n_live_points}, Matches: {n_match}")
        d.rectangle([0, im.height - 18, im.width, im.height],
                    fill=(30, 30, 30))
        d.text((6, im.height - 15), text, fill=(255, 255, 0))
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        return buf.getvalue()

    # ------------------------------------------------------------ tracking
    def _track_common(self, pair, timestamp: float) -> Optional[np.ndarray]:
        # LOST with ≤5 keyframes → full reset (Tracking.cc:571-580), not
        # in localization mode
        if (self.state == tracking.LOST and not self.localization_only
                and self.n_kfs <= 5):
            self._auto_reset()
        if self.state in (tracking.NO_IMAGES_YET, tracking.NOT_INITIALIZED):
            fd = self.frontend(*pair)
            ok = self._initialize(fd, timestamp)
            self.frame_id += 1
            return np.asarray(self.last_Tcw) if ok else None
        if self.state == tracking.LOST:
            return self._handle_lost(self.frontend(*pair), timestamp)

        t = self.cfg.tracking
        Tcw_pred = self._t(self._predict_pose())
        # one (map, reference keyframe) pair for the whole frame: the async
        # engine's worker publishes both while tracking runs
        ms, ref_at_track = self._map_and_ref()
        fd = self.frontend(*pair)
        if (self.localization_only and self.cfg.sensor != MONOCULAR
                and self.last_fd is not None):
            # temporal VO points + the mbVO dual path (Tracking.cc:393-520);
            # mono has no depth to place VO points from
            res = self.fns.track_loc_body(
                ms, fd, self.last_fd, self._t(self.last_Tcw), Tcw_pred,
                self.last_assoc, self.last_inlier, ref_at_track)
            return self._finish_loc_frame(ms, fd, res, ref_at_track,
                                          timestamp)
        res = self.fns.track_body(ms, fd, Tcw_pred, self.last_assoc,
                                  self.last_inlier, ref_at_track, widen=True)
        sm = tracking.Summary.of(res)
        if sm.n_inliers_map < t.local_map_tracking_threshold:
            # motion model failed → TrackReferenceKeyFrame, then re-run the
            # two-stage track from the recovered pose
            ref = self.fns.track_ref_kf(ms, fd, ref_at_track,
                                        self._t(self.last_Tcw))
            sm_ref = tracking.Summary.of(ref)
            if sm_ref.n_matches_mm >= t.min_matches_ref_keyframe:
                res2 = self.fns.track(ms, fd, ref.Tcw, ref.assoc, ref.inlier,
                                      ref_at_track)
                sm2 = tracking.Summary.of(res2)
                if sm2.n_inliers_map > sm.n_inliers_map:
                    res, sm = res2, sm2
        self._absorb_track(ms, res)
        if sm.n_inliers_map < t.local_map_tracking_threshold:
            return self._lost(timestamp)
        self._tracked(sm, res)
        if not self.localization_only and self._need_new_keyframe(sm):
            self._create_keyframe(fd, res, timestamp)
        return self._record_tracked(sm, fd, ref_at_track, timestamp)

    def _lost(self, timestamp: float) -> None:
        """A frame that lost tracking."""
        self.state = tracking.LOST
        self.velocity = None
        self._record_traj(timestamp, None)
        self.frame_id += 1

    def _tracked(self, sm: tracking.Summary, res) -> None:
        """Adopt a tracked frame's pose and associations."""
        self.state = tracking.OK
        if self.last_Tcw is not None:
            self.velocity = sm.Tcw @ np.linalg.inv(self.last_Tcw)
        self.last_Tcw = sm.Tcw
        self.last_assoc = res.assoc
        self.last_inlier = res.inlier

    def _record_tracked(self, sm: tracking.Summary, fd, ref_at_track: int,
                        timestamp: float) -> np.ndarray:
        self._append_traj(TrajectoryEntry(timestamp, sm.Tcr, ref_at_track,
                                          False))
        self.last_fd = fd
        self.frame_id += 1
        return sm.Tcw

    def _finish_loc_frame(self, ms, fd, res, ref_at_track: int,
                          timestamp: float) -> Optional[np.ndarray]:
        """Localization-mode frame epilogue: in VO mode a relocalization
        attempt, whose success overrides the VO pose (the reference
        computes both and prefers relocalization, Tracking.cc:450-489);
        otherwise the frame is tracked if the map or, in VO mode, the
        motion-model stage holds."""
        t = self.cfg.tracking
        sm = tracking.Summary.of(res)
        vo_mode = sm.n_real_mm < 10
        if vo_mode and self.loop_closer is not None:
            Tcw, assoc = self._relocalize(fd)
            if Tcw is not None:
                self.stats["reloc"] += 1
                self._relocalized(Tcw, assoc, fd, timestamp)
                self.frame_id += 1
                return Tcw
        if not (sm.n_inliers_map >= t.local_map_tracking_threshold
                or (vo_mode and sm.n_inliers_mm > 20)):
            return self._lost(timestamp)
        self._absorb_track(ms, res)
        self._tracked(sm, res)
        return self._record_tracked(sm, fd, ref_at_track, timestamp)

    def _initialize(self, fd, timestamp: float) -> bool:
        """StereoInitialization: needs ≥ 50 features with depth; mono
        bootstraps from two frames."""
        if self.cfg.sensor == MONOCULAR:
            return self._initialize_mono(fd, timestamp)
        if int(torch.sum((fd.depth > 0) & fd.valid)) < 50:
            return False
        self.ms, assoc, n_pts = self.fns.init_stereo(
            self.ms, fd, torch.eye(4, device=self.device), self.frame_id,
            timestamp)
        self.n_kfs = 1
        self.kf_ordinal = 1
        self._free_kf_slots.discard(0)
        self.last_Tcw = np.eye(4, dtype=np.float32)
        self.last_assoc = assoc
        self.last_inlier = torch.ones(fd.n, dtype=torch.bool,
                                      device=self.device)
        self.ref_kf = 0
        self.state = tracking.OK
        self.last_kf_frame_id = self.frame_id
        self.stats["kf_inserted"] += 1
        self.stats["mp_created"] += int(n_pts)
        self._record_traj(timestamp, self.last_Tcw)
        return True

    def _initialize_mono(self, fd, timestamp: float) -> bool:
        """MonocularInitialization (Tracking.cc:663): hold a reference
        frame with > 100 keypoints, match the next one against it (≥ 100
        matches, else the reference is dropped), run the H/F initializer,
        build the two-keyframe map and refine it with a local BA on
        keyframe 1 (CreateInitialMapMonocular's global BA, :784)."""
        n_kp = int(torch.sum(fd.valid))
        if self._mono_ref is None:
            if n_kp > 100:
                self._mono_ref = (fd, self.frame_id, timestamp)
            return False
        ref, ref_id, ref_ts = self._mono_ref
        if n_kp <= 100:
            self._mono_ref = None       # (:688-693: a weak reference frame)
            return False
        m, n_matches = self.fns.mono_match(ref, fd)
        if int(n_matches) < 100:        # (:698)
            self._mono_ref = None
            return False
        ms2, ok, T2, assoc_cur, n_pts = self.fns.mono_build(
            self.ms, ref, fd, m, ref_id, self.frame_id, ref_ts, timestamp,
            self._mono_gen)
        if not bool(ok):
            return False
        self.ms = ms2
        self.n_kfs = 2
        self.kf_ordinal = 2
        self._free_kf_slots -= {0, 1}
        self.last_assoc = assoc_cur
        self.last_inlier = torch.ones(fd.n, dtype=torch.bool,
                                      device=self.device)
        self.ref_kf = 1
        self.state = tracking.OK
        self.last_kf_frame_id = self.frame_id
        self.stats["kf_inserted"] += 2
        self.stats["mp_created"] += int(n_pts)
        self.ms, _ = self.mapping_fns.local_ba(self.ms, 1)
        self.last_Tcw = self.ms.kf_pose[1].cpu().numpy()
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(self.ms, 0)
            self.loop_closer.add_keyframe(self.ms, 1)
        self._record_traj(timestamp, self.last_Tcw)
        self._mono_ref = None
        return True

    def _map_and_ref(self):
        """The map and the reference keyframe a frame tracks against."""
        return self.ms, self.ref_kf

    def _absorb_track(self, ms, res) -> None:
        """Fold a tracked frame's visible/found counters into the map ``ms``
        it tracked against and adopt the result (JAX ``slam.py:470-479``).
        The async engine overrides this to accumulate them for its worker
        instead: there tracking never writes the map."""
        self.ms = self.fns.apply_counters(ms, res.visible_mask,
                                          res.found_mask)

    def _relocalize(self, fd):
        """Relocalization of frame ``fd`` against the map and the keyframe
        DB: (Tcw, assoc) or (None, None)."""
        return self.loop_closer.relocalize(self.ms, fd)

    def _predict_pose(self) -> np.ndarray:
        if self.velocity is not None:
            return (self.velocity @ self.last_Tcw).astype(np.float32)
        return self.last_Tcw.astype(np.float32)

    # -------------------------------------------------- keyframe decision
    def _mapper_idle(self) -> bool:
        """LocalMapping::AcceptKeyFrames: synchronous mapping is always
        idle between frames; the windowed engine overrides."""
        return True

    def _mapping_queue_len(self) -> int:
        return 0

    def _interrupt_ba(self) -> None:
        """LocalMapping::InterruptBA (Tracking.cc:1146): a no-op when
        mapping is synchronous."""

    def _need_new_keyframe(self, sm: tracking.Summary,
                           ref_override: Optional[int] = None) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1076-1160): c1b needs an idle
        mapper; when it is busy the decision interrupts the running BA and
        queues only for non-mono sensors with fewer than 3 waiting
        keyframes.

        ``ref_override``: the windowed engine replays decisions from
        summaries computed before an in-window insert; after one, the
        inserting frame's inlier count stands in for the new reference
        keyframe's tracked count."""
        t = self.cfg.tracking
        if not self._free_kf_slots and not self._evict_for_capacity():
            if not self._capacity_warned:
                warnings.warn(
                    "keyframe capacity exhausted "
                    f"(max_keyframes={self.cfg.capacity.max_keyframes}) "
                    "and no keyframe is evictable", RuntimeWarning)
                self._capacity_warned = True
            return False
        frames_since = self.frame_id - self.last_kf_frame_id
        n_inliers = sm.n_inliers_map
        ref_matches = max(
            sm.ref_tracked3 if self.kf_ordinal > 2 else sm.ref_tracked2, 1)
        if ref_override is not None:
            ref_matches = max(ref_override, 1)
        need_close = (sm.n_tracked_close < 100
                      and sm.n_nontracked_close > 70)
        th_ref_ratio = 0.75 if self.cfg.sensor != MONOCULAR else 0.9
        if self.kf_ordinal < 2:
            th_ref_ratio = 0.4
        idle = self._mapper_idle()
        c1a = frames_since >= int(self.cfg.camera.fps)
        c1b = frames_since >= t.min_frames and idle
        c1c = (self.cfg.sensor != MONOCULAR
               and (n_inliers < ref_matches * 0.25 or need_close))
        c2 = ((n_inliers < ref_matches * th_ref_ratio or need_close)
              and n_inliers > 15)
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        self._interrupt_ba()
        return (self.cfg.sensor != MONOCULAR
                and self._mapping_queue_len() < 3)

    # ---------------------------------------------------- keyframe insert
    def _evict_for_capacity(self) -> bool:
        """At keyframe-capacity exhaustion, evict the most redundant live
        keyframe.  Returns True when a slot was freed."""
        ms2, victim = self.mapping_fns.evict_keyframe(
            self.ms, self.ref_kf, self.frame_id)
        if victim < 0:
            return False
        self.ms = ms2
        self._on_kfs_culled(ms2, [victim])
        self.stats["kf_evicted"] = self.stats.get("kf_evicted", 0) + 1
        return True

    def _take_kf_slot(self) -> int:
        slot = min(self._free_kf_slots)
        self._free_kf_slots.discard(slot)
        self._culled_remap.pop(slot, None)
        return slot

    def _append_traj(self, e: TrajectoryEntry) -> None:
        """Append, rebasing through culled reference keyframes first."""
        with self._traj_lock:
            seen = set()
            while not e.lost and e.ref_kf in self._culled_remap \
                    and e.ref_kf not in seen:
                seen.add(e.ref_kf)
                p, Tcp = self._culled_remap[e.ref_kf]
                e.Tcr = e.Tcr @ Tcp
                e.ref_kf = p
            self.trajectory.append(e)

    def _counter_args(self):
        """(visible, found) int32 [P] accumulators folded at insertion.
        The per-frame path folds its counters every frame, so zeros; the
        windowed engine hands over (and resets) its window's sums."""
        return self._zeros_p, self._zeros_p

    def _run_mapping_step(self, ms, fd, Tcw, assoc, kf_slot: int,
                          parent: int, frame_id: int, timestamp: float,
                          ba_ok: bool, counters=None):
        """The fused keyframe insertion; local BA only when ``ba_ok`` (the
        async worker clears it while keyframes wait, mbAbortBA) and from
        the third keyframe on.  ``counters``: (visible, found) sums handed
        over with the job, else ``_counter_args()``."""
        vis, found = counters if counters is not None \
            else self._counter_args()
        ms, stats_dev = self.f_mapping_step(
            ms, fd, Tcw, assoc, kf_slot, self.kf_ordinal, parent, frame_id,
            timestamp, ba_ok and self.kf_ordinal >= 3, self.kf_ordinal >= 5,
            vis, found)
        stats = stats_dev.cpu().numpy()
        self.kf_ordinal += 1
        self.n_kfs += 1
        self.stats["kf_inserted"] += 1
        self.stats["mp_created"] += int(stats[0]) + int(stats[2])
        self.stats["mp_culled"] += int(stats[1])
        self.stats["mp_fused"] += int(stats[3])
        self.stats["ba_outliers"] += int(stats[4])
        self.stats["kf_culled"] += int(stats[5])
        self.n_live_points = int(stats[6])
        victims = [int(v) for v in stats[7:] if v >= 0]
        if victims:
            self._on_kfs_culled(ms, victims)
        return ms

    def _on_kfs_culled(self, ms, victims: List[int]) -> None:
        """Rebase trajectory entries off culled reference keyframes onto
        their spanning-tree parents, then free the slots."""
        pose = ms.kf_pose.cpu().numpy()
        parent = ms.kf_parent.cpu().numpy()
        self.n_kfs -= len(victims)
        vic = set(victims)
        remap = {}
        for v in victims:
            p = int(parent[v])
            seen = {v}
            while p in vic and p not in seen and p >= 0:
                seen.add(p)
                p = int(parent[p])
            p = max(p, 0)
            remap[v] = (p, (pose[v] @ np.linalg.inv(pose[p])).astype(
                np.float32))
        with self._traj_lock:
            self._culled_remap.update(remap)
            for e in self.trajectory:
                if not e.lost and e.ref_kf in remap:
                    p, Tcp = remap[e.ref_kf]
                    e.Tcr = e.Tcr @ Tcp
                    e.ref_kf = p
        if self.ref_kf in remap:
            self.ref_kf = remap[self.ref_kf][0]
        if self.loop_closer is not None:
            for v in victims:
                self.loop_closer.db = self.loop_closer.db.erase(v)
        self._free_kf_slots |= vic

    def _create_keyframe(self, fd, res, timestamp: float) -> None:
        kf_slot = self._take_kf_slot()
        self.ms = self._run_mapping_step(
            self.ms, fd, res.Tcw, res.assoc, kf_slot, self.ref_kf,
            self.frame_id, timestamp, ba_ok=True)
        self.ref_kf = kf_slot
        self.last_kf_frame_id = self.frame_id
        # new points take part in tracking at once
        self.last_assoc = self.ms.kf_mp[kf_slot]
        self.last_inlier = torch.ones_like(self.last_inlier)

        # loop closing (LoopClosing::Run per keyframe), then a finished
        # background GBA is merged (LoopClosing.cc:715-775)
        if self.loop_closer is not None:
            self.ms, closed = self.loop_closer.on_keyframe(
                self.ms, kf_slot, self.kf_ordinal)
            self.ms, merged = self.loop_closer.gba.poll_and_merge(self.ms)
            if closed or merged:
                self.stats["loops_closed"] += int(closed)
                # poses moved wholesale: rebase the motion model
                self.velocity = None
                self.last_Tcw = self.ms.kf_pose[kf_slot].cpu().numpy()

    def _auto_reset(self) -> None:
        """Tracking::Reset in place: clear map and trajectory."""
        cfg = self.cfg
        self.ms = M.empty_map(cfg, device=self.device)
        self.state = tracking.NO_IMAGES_YET
        self.n_kfs = 0
        self.kf_ordinal = 0
        self.n_live_points = 0
        self.last_kf_frame_id = self.frame_id
        self.ref_kf = 0
        self.velocity = None
        self.last_Tcw = None
        self.last_assoc = None
        self.last_inlier = None
        self.last_fd = None
        self._mono_ref = None
        self._free_kf_slots = set(range(cfg.capacity.max_keyframes))
        with self._traj_lock:
            self._culled_remap = {}
            self.trajectory = []
        if self.loop_closer is not None:
            self.loop_closer.reset()
        self.stats["resets"] = self.stats.get("resets", 0) + 1

    def _handle_lost(self, fd, timestamp: float) -> Optional[np.ndarray]:
        """Relocalization (Tracking.cc:434-449); without loop closing the
        frame is recorded lost."""
        self.frame_id += 1
        if self.loop_closer is None:
            self._record_traj(timestamp, None)
            return None
        Tcw, assoc = self._relocalize(fd)
        if Tcw is None:
            self._record_traj(timestamp, None)
            return None
        self.stats["reloc"] += 1
        self._relocalized(Tcw, assoc, fd, timestamp)
        return Tcw

    def _relocalized(self, Tcw: np.ndarray, assoc, fd,
                     timestamp: float) -> None:
        """Adopt a relocalization's pose and associations."""
        self.state = tracking.OK
        self.velocity = None
        self.last_Tcw = Tcw.astype(np.float32)
        self.last_assoc = assoc
        self.last_inlier = torch.ones_like(assoc >= 0)
        self.last_fd = fd
        self._record_traj(timestamp, Tcw)

    def finish_gba(self) -> bool:
        """Wait for a background global BA and merge its result (the
        shutdown handshake, System.cc:169-183)."""
        if self.loop_closer is None:
            return False
        self.loop_closer.gba.wait()
        self.ms, merged = self.loop_closer.gba.poll_and_merge(self.ms)
        if merged:
            self.velocity = None
        return merged

    def _record_traj(self, timestamp: float, Tcw: Optional[np.ndarray]):
        if Tcw is None:
            self._append_traj(TrajectoryEntry(
                timestamp, np.eye(4, dtype=np.float32), self.ref_kf, True))
            return
        Tref = self.ms.kf_pose[self.ref_kf].cpu().numpy()
        self._append_traj(TrajectoryEntry(
            timestamp, (Tcw @ np.linalg.inv(Tref)).astype(np.float32),
            self.ref_kf, False))

    # ------------------------------------------------------------- outputs
    def current_pose_covariance(self) -> Optional[np.ndarray]:
        """6×6 covariance of the last tracked pose (numpy float32), or None
        before a frame has been tracked (JAX ``slam.py:435-442``)."""
        if self.last_fd is None or self.last_Tcw is None:
            return None
        return self.fns.pose_covariance(
            self.ms, self.last_fd, self._t(self.last_Tcw),
            self.last_assoc).cpu().numpy()

    def frame_poses(self) -> List[Optional[np.ndarray]]:
        """Per-frame Tcw through the (BA-corrected) reference keyframes."""
        kf_pose = self.ms.kf_pose.cpu().numpy()
        return [None if e.lost else e.Tcr @ kf_pose[e.ref_kf]
                for e in self.trajectory]

    def map_points(self) -> np.ndarray:
        """Live map-point cloud [M, 3]."""
        return self.ms.mp_pos[self.ms.mp_valid].cpu().numpy()
