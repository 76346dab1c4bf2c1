"""Per-frame tracking steps: the numeric half of ``Tracking``.

Port of ``orbslam2_tpu/runtime/tracking.py``: ``init_stereo`` and the
mono bootstrap (``mono_match``, ``mono_build``), ``track_body``
(motion-model stage with the ×2 widen retry, then the local-map stage),
``track_loc_body`` (localization mode: temporal VO points and the mbVO
dual path),
``track_ref_kf`` (the TrackReferenceKeyFrame fallback, which reaches the
``hamming_top2`` kernel through ``match_descriptors``),
``insert_keyframe_body`` and ``apply_counters``.  Each step keeps the
40-float ``Summary`` layout, so the host state machine reads one small
tensor per call.

``pose_covariance`` waits for its ROADMAP item.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import MONOCULAR, SlamConfig
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.models.frame import FrameData
from orbslam2_tpu_torch.ops import initializer as init_mod
from orbslam2_tpu_torch.ops import matching, pose_opt
from orbslam2_tpu_torch.ops.hamming_top2 import launch_site
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie
from orbslam2_tpu_torch.utils.index import mask_of, scatter_set, topk

# Tracking states (Tracking.h:82-88)
SYSTEM_NOT_READY = -1
NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3


class TrackResult(NamedTuple):
    Tcw: torch.Tensor            # [4, 4]
    assoc: torch.Tensor          # [N] feature → map-point id (−1 none)
    inlier: torch.Tensor         # [N] bool pose-opt inliers
    summary: torch.Tensor        # [40] float32, layout below
    visible_mask: torch.Tensor   # [P] frustum-visible live points
    found_mask: torch.Tensor     # [P] matched-inlier points

    # summary layout
    # [0:16]  Tcw row-major
    # [16:32] Tcr = Tcw · kf_pose[ref]⁻¹ row-major
    # [32] n_matches_mm   [33] n_inliers_mm   [34] n_inliers_map
    # [35] n_tracked_close  [36] n_nontracked_close
    # [37] ref_tracked(minObs=2)  [38] ref_tracked(minObs=3)
    # [39] localization mode: inlier matches to real map points (mbVO
    #      datum), 0 elsewhere


def pack_summary(Tcw, Tcr, scalars) -> torch.Tensor:
    dev = Tcw.device
    vals = torch.stack([torch.as_tensor(x, device=dev).to(torch.float32)
                        for x in scalars])
    v = torch.cat([Tcw.reshape(16).to(torch.float32),
                   Tcr.reshape(16).to(torch.float32), vals])
    return torch.nn.functional.pad(v, (0, 40 - v.shape[0]))


class Summary:
    """Host-side view over the fetched summary vector."""

    def __init__(self, vec: np.ndarray):
        self.Tcw = np.asarray(vec[0:16], np.float32).reshape(4, 4)
        self.Tcr = np.asarray(vec[16:32], np.float32).reshape(4, 4)
        self.n_matches_mm = int(vec[32])
        self.n_inliers_mm = int(vec[33])
        self.n_inliers_map = int(vec[34])
        self.n_tracked_close = int(vec[35])
        self.n_nontracked_close = int(vec[36])
        self.ref_tracked2 = int(vec[37])
        self.ref_tracked3 = int(vec[38])
        self.n_real_mm = int(vec[39])

    @staticmethod
    def of(res: TrackResult) -> "Summary":
        return Summary(res.summary.cpu().numpy())


def sigma2_table(cfg: SlamConfig) -> np.ndarray:
    return np.array([cfg.orb.scale_factor ** (2 * l)
                     for l in range(cfg.orb.n_levels)], np.float32)


def _assoc_from_query_match(match: torch.Tensor, mp_ids: torch.Tensor,
                            n_kp: int) -> torch.Tensor:
    """Query-row → kp matches into a per-keypoint assoc array [N] int32."""
    ok = match >= 0
    assoc = torch.full((n_kp,), M.NO_MP, dtype=torch.int32,
                       device=match.device)
    return scatter_set(assoc, torch.where(ok, match, 0), mp_ids, ok)


def _pose_obs_from_assoc(ms: M.MapState, fd: FrameData, assoc: torch.Tensor,
                         inv_sigma2: torch.Tensor) -> pose_opt.PoseObs:
    ok = assoc >= 0
    idx = torch.where(ok, assoc, 0).long()
    return pose_opt.PoseObs(
        pts_w=ms.mp_pos[idx], uv=fd.xy, ur=fd.ur,
        inv_sigma2=inv_sigma2[fd.level.long()],
        valid=ok & ms.mp_valid[idx] & fd.valid)


class TrackingFns(NamedTuple):
    init_stereo: object
    mono_match: object
    mono_build: object
    track: object
    track_body: object
    track_loc_body: object
    track_ref_kf: object
    insert_keyframe_body: object
    apply_counters: object


def make_tracking_fns(cfg: SlamConfig) -> TrackingFns:
    """Tracking step functions for ``cfg``; they run on the device of the
    map and frame tensors they are given."""
    cam = cam_mod.Camera.from_config(cfg.camera)
    sigma2_np = sigma2_table(cfg)
    inv_sigma2_np = (1.0 / sigma2_np).astype(np.float32)
    sf, nl = cfg.orb.scale_factor, cfg.orb.n_levels
    tcfg = cfg.tracking
    depth_cutoff = (cfg.camera.baseline * cfg.camera.th_depth
                    if cfg.camera.bf > 0 else float("inf"))
    N = cfg.orb.n_features_padded
    mm_radius = (tcfg.stereo_searching_radius if cfg.sensor != MONOCULAR
                 else tcfg.searching_radius)

    def inv_sigma2(dev):
        return torch.as_tensor(inv_sigma2_np, device=dev)

    def count(mask):
        return torch.sum(mask.to(torch.int32))

    # ---------------------------------------------------------------- init
    def init_stereo(ms: M.MapState, fd: FrameData, Tcw, frame_id: int,
                    timestamp: float):
        """StereoInitialization (Tracking.cc:609): KF0 + a map point for
        every feature with positive depth.  Returns (ms, assoc, n_points)."""
        dev = fd.xy.device
        ok = fd.valid & (fd.depth > 0)
        slots, ok = M.alloc_mp_slots(ms, ok)
        pos_c = cam_mod.backproject(cam, fd.xy, fd.depth)
        pos_w = lie.transform_points(lie.se3_inv(Tcw), pos_c)
        ms = M.add_map_points(ms, slots, pos_w, ok, ref_kf=0)
        assoc = torch.where(ok, slots, M.NO_MP).to(torch.int32)
        ms = M.add_keyframe(ms, 0, Tcw, frame_id, timestamp, fd.xy, fd.level,
                            fd.angle, fd.desc, fd.valid, fd.ur, fd.depth,
                            assoc, parent=-1)
        feat_idx = torch.arange(N, device=dev)
        ms = M.add_observations(ms, 0, feat_idx, assoc, ok, sf, nl)
        return ms, assoc, count(ok)

    # ------------------------------------------------------ mono bootstrap
    def mono_match(ref: FrameData, cur: FrameData):
        """SearchForInitialization between the held reference frame and the
        current one (Tracking.cc:695).  Returns (ref → cur index [N],
        number of matches)."""
        m, _ = matching.search_for_initialization(
            ref.xy, ref.desc, ref.valid, ref.level,
            cur.xy, cur.desc, cur.valid, cur.level,
            ref.angle, cur.angle, window=100.0, nn_ratio=0.9)
        return m, count(m >= 0)

    def mono_build(ms: M.MapState, ref: FrameData, cur: FrameData,
                   m: torch.Tensor, frame_id_ref: int, frame_id_cur: int,
                   ts_ref: float, ts_cur: float,
                   generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None):
        """The H/F initializer and, when it succeeds, the two-keyframe map
        at the median-depth scale (CreateInitialMapMonocular,
        Tracking.cc:736-811): KF0 at identity, KF1 at the recovered pose,
        a point for every good triangulation.  ``idx`` [200, 8] replaces
        the generator's draws.  Returns (ms, ok, Tcw2, assoc_cur,
        n_points), all tensors."""
        dev = ref.xy.device
        ok_m = m >= 0
        msafe = torch.where(ok_m, m, 0).long()
        res = init_mod.initialize_mono(cam, ref.xy, cur.xy[msafe], ok_m,
                                       generator, idx=idx)
        # median-depth normalisation, with jnp.nanmedian's even-count mean
        med = init_mod.nanmedian(torch.where(res.good, res.points[:, 2],
                                             float("nan")))
        scale = 1.0 / torch.clamp(torch.where(torch.isnan(med), 1.0, med),
                                  min=1e-6)
        pts = res.points * scale
        T2 = res.Tcw2.clone()
        T2[:3, 3] = T2[:3, 3] * scale

        good = res.good & res.ok
        slots = torch.where(good, torch.cumsum(good.to(torch.int32), 0) - 1,
                            0).to(torch.int32)
        ms = M.add_map_points(ms, slots, pts, good,
                              ref_kf=torch.zeros(N, dtype=torch.int32,
                                                 device=dev))
        assoc_ref = torch.where(good, slots, M.NO_MP).to(torch.int32)
        feat_idx = torch.arange(N, device=dev)
        ms = M.add_keyframe(ms, 0, torch.eye(4, device=dev), frame_id_ref,
                            ts_ref, ref.xy, ref.level, ref.angle, ref.desc,
                            ref.valid, ref.ur, ref.depth, assoc_ref,
                            parent=-1)
        ms = M.add_observations(ms, 0, feat_idx, assoc_ref, good, sf, nl)
        # KF1: the reference's points through the match indices
        assoc_cur = scatter_set(
            torch.full((N,), M.NO_MP, dtype=torch.int32, device=dev), msafe,
            assoc_ref, good)
        ms = M.add_keyframe(ms, 1, T2, frame_id_cur, ts_cur, cur.xy,
                            cur.level, cur.angle, cur.desc, cur.valid,
                            cur.ur, cur.depth, assoc_cur, parent=0)
        ms = M.add_observations(ms, 1, feat_idx, assoc_cur, assoc_cur >= 0,
                                sf, nl)
        n_pts = count(good)
        return ms, res.ok & (n_pts > 0), T2, assoc_cur, n_pts

    # --------------------------------------------------------------- track
    def _ref_tracked(ms, ref_kf, min_obs):
        mp = ms.kf_mp[ref_kf]
        okk = (mp >= 0) & ms.kf_kp_valid[ref_kf]
        idxk = torch.where(okk, mp, 0).long()
        return count(okk & ms.mp_valid[idxk] & (ms.mp_n_obs[idxk] >= min_obs))

    def _stage1(ms, fd, Tcw_pred, last_assoc, last_ok, wide_scale: float):
        """TrackWithMotionModel (Tracking.cc:967)."""
        lq_ok = (last_assoc >= 0) & last_ok
        idx = torch.where(lq_ok, last_assoc, 0).long()
        normals = ms.mp_normal()
        q1 = matching.ProjectionQuery(
            pos_w=ms.mp_pos[idx], normal=normals[idx],
            min_dist=ms.mp_min_dist[idx], max_dist=ms.mp_max_dist[idx],
            desc=ms.mp_desc[idx], valid=lq_ok & ms.mp_valid[idx])
        m1, d1, _ = matching.search_by_projection(
            cam, Tcw_pred, q1, fd.xy, fd.level, fd.desc, fd.valid, fd.ur,
            sf, nl, radius=mm_radius * wide_scale,
            nn_ratio=tcfg.motion_model_nn_ratio, view_cos_limit=-1.0,
            check_ur=True)
        m1 = matching.resolve_duplicates(m1, d1, N)
        n_mm_matches = count(m1 >= 0)
        assoc1 = _assoc_from_query_match(m1, last_assoc, N)
        obs1 = _pose_obs_from_assoc(ms, fd, assoc1, inv_sigma2(fd.xy.device))
        pose1, _inl1, n1 = pose_opt.pose_optimization(cam, Tcw_pred, obs1)
        return pose1, assoc1, n_mm_matches, n1

    def _stage2(ms, fd, pose1, assoc1, ref_kf, n_mm_matches, n1):
        """TrackLocalMap (Tracking.cc:1030) over the local keyframes'
        points, candidates compacted to track_candidates."""
        dev = fd.xy.device
        Cc = min(cfg.capacity.track_candidates, ms.P)
        matched_mask = mask_of(assoc1, assoc1 >= 0, ms.P)
        share = M.kf_share_counts(ms, matched_mask)
        topw, topi = topk(share, min(tcfg.keyframes_limit, ms.K))
        local_kf = mask_of(topi, topw > 0, ms.K)
        local_pt = M.points_of_kfs(ms, local_kf)
        normals = ms.mp_normal()
        vis_all, _, _, _, _ = cam_mod.in_frustum(
            cam, pose1, ms.mp_pos, 0.8 * ms.mp_min_dist,
            1.2 * ms.mp_max_dist, normals)
        cand = local_pt & ms.mp_valid & vis_all & (~matched_mask)
        ids, sel_ok = M.compact_mask(cand, Cc)
        q2 = matching.ProjectionQuery(
            pos_w=ms.mp_pos[ids], normal=normals[ids],
            min_dist=ms.mp_min_dist[ids], max_dist=ms.mp_max_dist[ids],
            desc=ms.mp_desc[ids], valid=sel_ok)
        m2, d2, _ = matching.search_by_projection(
            cam, pose1, q2, fd.xy, fd.level, fd.desc, fd.valid, fd.ur,
            sf, nl, radius=4.0 * tcfg.searching_by_projection_threshold / 5.0,
            nn_ratio=tcfg.search_local_points_nn_ratio)
        m2 = matching.resolve_duplicates(m2, d2, N)
        assoc2 = _assoc_from_query_match(m2, ids, N)
        assoc = torch.where(assoc1 >= 0, assoc1, assoc2)

        obs2 = _pose_obs_from_assoc(ms, fd, assoc, inv_sigma2(dev))
        pose2, inl2, n2 = pose_opt.pose_optimization(cam, pose1, obs2)

        visible, _, _, _, _ = cam_mod.in_frustum(
            cam, pose2, ms.mp_pos, 0.8 * ms.mp_min_dist,
            1.2 * ms.mp_max_dist, normals)
        visible_mask = visible & ms.mp_valid
        found_mask = mask_of(assoc, (assoc >= 0) & inl2, ms.P)

        assoc_final = torch.where(inl2, assoc, M.NO_MP)
        close = fd.valid & (fd.depth > 0) & (fd.depth < depth_cutoff)
        Tcr = pose2 @ lie.se3_inv(ms.kf_pose[ref_kf])
        summary = pack_summary(pose2, Tcr, [
            n_mm_matches, n1, n2, count(close & (assoc_final >= 0)),
            count(close & (assoc_final < 0)),
            _ref_tracked(ms, ref_kf, 2), _ref_tracked(ms, ref_kf, 3), 0])
        return TrackResult(Tcw=pose2, assoc=assoc_final, inlier=inl2,
                           summary=summary, visible_mask=visible_mask,
                           found_mask=found_mask)

    def track_body(ms: M.MapState, fd: FrameData, Tcw_pred, last_assoc,
                   last_ok, ref_kf: int, widen: bool = True) -> TrackResult:
        """Motion-model + local-map track.  ``widen`` retries stage 1 with
        a ×2 window when the narrow pass is weak (Tracking.cc:985-996)."""
        s1 = _stage1(ms, fd, Tcw_pred, last_assoc, last_ok, 1.0)
        if widen:
            _, _, n_mm, n1 = s1
            need_wide = ((n_mm < tcfg.speedup_matches_threshold)
                         | (n1 < tcfg.motion_model_threshold))
            if bool(need_wide):
                s1 = _stage1(ms, fd, Tcw_pred, last_assoc, last_ok, 2.0)
        pose1, assoc1, n_mm, n1 = s1
        return _stage2(ms, fd, pose1, assoc1, ref_kf, n_mm, n1)

    def track(ms, fd, Tcw_pred, last_assoc, last_ok, ref_kf: int
              ) -> TrackResult:
        """The un-widened two-stage track (the fallback's re-run)."""
        return track_body(ms, fd, Tcw_pred, last_assoc, last_ok, ref_kf,
                          widen=False)

    # ------------------------------------------- localization-mode VO track
    def track_loc_body(ms: M.MapState, fd: FrameData, prev_fd: FrameData,
                       prev_Tcw, Tcw_pred, last_assoc, last_ok,
                       ref_kf: int) -> TrackResult:
        """Localization-mode tracking with temporal visual-odometry points
        (UpdateLastFrame, Tracking.cc:901-965, and the mbVO dual path,
        :393-520): the previous frame's depth spawns one-shot VO points
        that join the motion-model search (VO ids are P + feature index).
        Summary slot 39 holds the mbVO datum, the inlier matches to real
        map points with ≥ 1 observation; below 10 the frame is in VO mode
        and keeps the stage-1 pose.  The local-map stage is always
        computed and the result selected on the device, as in JAX."""
        dev = fd.xy.device
        P = ms.P
        # temporal VO points: close depth, or the nearest
        # points_closer_threshold (a stable ranking, as jnp.argsort's)
        can = prev_fd.valid & (prev_fd.depth > 0)
        close = can & (prev_fd.depth <= depth_cutoff)
        order = torch.argsort(
            torch.where(can, prev_fd.depth,
                        torch.full_like(prev_fd.depth, float("inf"))),
            stable=True)
        rank_of = torch.empty(N, dtype=torch.int64, device=dev)
        rank_of[order] = torch.arange(N, device=dev)
        keep = can & (close | (rank_of < tcfg.points_closer_threshold))
        la_ok = last_assoc >= 0
        la_safe = torch.where(la_ok, last_assoc, 0).long()
        has_mp = la_ok & ms.mp_valid[la_safe] & (ms.mp_n_obs[la_safe] >= 1)
        vo_valid = keep & ~has_mp
        pos_c = cam_mod.backproject(cam, prev_fd.xy, prev_fd.depth)
        Twc_prev = lie.se3_inv(prev_Tcw)
        vo_pos = lie.transform_points(Twc_prev, pos_c)
        dist = torch.linalg.norm(pos_c, dim=-1)
        ray_w = vo_pos - Twc_prev[:3, 3]
        vo_normal = ray_w / torch.clamp(
            torch.linalg.norm(ray_w, dim=-1, keepdim=True), min=1e-9)

        # stage 1 over the union query (map points ∪ VO points)
        lq_ok = la_ok & last_ok
        idx = torch.where(lq_ok, last_assoc, 0).long()
        normals = ms.mp_normal()
        q_union = matching.ProjectionQuery(
            pos_w=torch.cat([ms.mp_pos[idx], vo_pos]),
            normal=torch.cat([normals[idx], vo_normal]),
            min_dist=torch.cat([ms.mp_min_dist[idx], 0.5 * dist]),
            max_dist=torch.cat([ms.mp_max_dist[idx], 2.0 * dist]),
            desc=torch.cat([ms.mp_desc[idx], prev_fd.desc]),
            valid=torch.cat([lq_ok & ms.mp_valid[idx], vo_valid]))
        m1, d1, _ = matching.search_by_projection(
            cam, Tcw_pred, q_union, fd.xy, fd.level, fd.desc, fd.valid,
            fd.ur, sf, nl, radius=mm_radius,
            nn_ratio=tcfg.motion_model_nn_ratio, view_cos_limit=-1.0,
            check_ur=True)
        m1 = matching.resolve_duplicates(m1, d1, N)
        n_mm = count(m1 >= 0)
        union_ids = torch.cat([
            last_assoc.to(torch.int32),
            P + torch.arange(N, dtype=torch.int32, device=dev)])
        assoc_u = _assoc_from_query_match(m1, union_ids, N)
        is_real = (assoc_u >= 0) & (assoc_u < P)
        real_safe = torch.where(is_real, assoc_u, 0).long()
        vo_i = torch.clamp(assoc_u.long() - P, 0, N - 1)
        obs1 = pose_opt.PoseObs(
            pts_w=torch.where(is_real[:, None], ms.mp_pos[real_safe],
                              vo_pos[vo_i]),
            uv=fd.xy, ur=fd.ur, inv_sigma2=inv_sigma2(dev)[fd.level.long()],
            valid=(assoc_u >= 0) & fd.valid)
        pose1, inl1, n1 = pose_opt.pose_optimization(cam, Tcw_pred, obs1)
        n_real = count(is_real & inl1 & (ms.mp_n_obs[real_safe] >= 1))
        vo_mode = n_real < 10

        # stage 2 on the real map points, kept unless in VO mode
        assoc1 = torch.where(is_real & inl1, assoc_u, M.NO_MP)
        res2 = _stage2(ms, fd, pose1, assoc1, ref_kf, n_mm, n1)
        pose_f = torch.where(vo_mode, pose1, res2.Tcw)
        assoc_f = torch.where(vo_mode, assoc1, res2.assoc)
        inlier = torch.where(vo_mode, inl1, res2.inlier)
        close_f = fd.valid & (fd.depth > 0) & (fd.depth < depth_cutoff)
        Tcr = pose_f @ lie.se3_inv(ms.kf_pose[ref_kf])
        summary = pack_summary(pose_f, Tcr, [
            n_mm, n1, res2.summary[34], count(close_f & (assoc_f >= 0)),
            count(close_f & (assoc_f < 0)), _ref_tracked(ms, ref_kf, 2),
            _ref_tracked(ms, ref_kf, 3), n_real])
        return TrackResult(Tcw=pose_f, assoc=assoc_f, inlier=inlier,
                           summary=summary,
                           visible_mask=res2.visible_mask,
                           found_mask=res2.found_mask)

    # ------------------------------------------------ reference-KF fallback
    def track_ref_kf(ms: M.MapState, fd: FrameData, ref_kf: int,
                     Tcw_init) -> TrackResult:
        """TrackReferenceKeyFrame (Tracking.cc:855): brute-force descriptor
        matching against one keyframe (the ``hamming_top2`` kernel on
        CUDA) + pose optimization from the last frame's pose."""
        dev = fd.xy.device
        kf_mp = ms.kf_mp[ref_kf]
        kvalid = ms.kf_kp_valid[ref_kf] & (kf_mp >= 0)
        with launch_site("track_ref_kf"):
            m, _d = matching.match_descriptors(
                fd.desc, fd.valid, ms.kf_desc[ref_kf], kvalid,
                nn_ratio=tcfg.reference_keyframe_nn_ratio,
                th=matching.TH_LOW, angle_a=fd.angle,
                angle_b=ms.kf_angle[ref_kf])
        assoc = torch.where(m >= 0, kf_mp[torch.where(m >= 0, m, 0)],
                            M.NO_MP).to(torch.int32)
        obs = _pose_obs_from_assoc(ms, fd, assoc, inv_sigma2(dev))
        pose, inl, n = pose_opt.pose_optimization(cam, Tcw_init, obs)
        assoc_final = torch.where(inl, assoc, M.NO_MP)
        close = fd.valid & (fd.depth > 0) & (fd.depth < depth_cutoff)
        nofp = torch.zeros(ms.P, dtype=torch.bool, device=dev)
        Tcr = pose @ lie.se3_inv(ms.kf_pose[ref_kf])
        summary = pack_summary(pose, Tcr, [
            count(assoc >= 0), n, n, count(close & (assoc_final >= 0)),
            count(close & (assoc_final < 0)),
            _ref_tracked(ms, ref_kf, 2), _ref_tracked(ms, ref_kf, 3), 0])
        return TrackResult(Tcw=pose, assoc=assoc_final, inlier=inl,
                           summary=summary, visible_mask=nofp,
                           found_mask=nofp)

    # ------------------------------------------------------ keyframe insert
    def insert_keyframe_body(ms: M.MapState, fd: FrameData, Tcw, assoc,
                             kf_slot: int, kf_ordinal: int, parent: int,
                             frame_id: int, timestamp: float):
        """CreateNewKeyFrame (Tracking.cc:1162): write the KF, keep the live
        associations, create points from close stereo depth for unmatched
        features.  Returns (ms, n_new_points)."""
        dev = fd.xy.device
        live = (assoc >= 0) & ms.mp_valid[torch.where(assoc >= 0, assoc, 0
                                                      ).long()]
        assoc = torch.where(live, assoc, M.NO_MP)
        can = fd.valid & (fd.depth > 0) & (assoc < 0)
        close = can & (fd.depth <= depth_cutoff)
        depth_rank = torch.argsort(
            torch.where(can, fd.depth, torch.full_like(fd.depth,
                                                       float("inf"))),
            stable=True)
        rank_of = torch.empty(N, dtype=torch.int64, device=dev)
        rank_of[depth_rank] = torch.arange(N, device=dev)
        need_fill = count(close) < tcfg.new_keyframe_threshold
        ok_new = torch.where(need_fill,
                             can & (rank_of < tcfg.new_keyframe_threshold),
                             close)
        slots, ok_new = M.alloc_mp_slots(ms, ok_new)

        pos_c = cam_mod.backproject(cam, fd.xy, fd.depth)
        pos_w = lie.transform_points(lie.se3_inv(Tcw), pos_c)
        ms = M.add_map_points(ms, slots, pos_w, ok_new, ref_kf=kf_slot,
                              first_kf=kf_ordinal)
        assoc_full = torch.where(ok_new, slots, assoc.long()).to(torch.int32)
        ms = M.add_keyframe(ms, kf_slot, Tcw, frame_id, timestamp, fd.xy,
                            fd.level, fd.angle, fd.desc, fd.valid, fd.ur,
                            fd.depth, assoc_full, parent)
        ms = M.add_observations(ms, kf_slot, torch.arange(N, device=dev),
                                assoc_full, assoc_full >= 0, sf, nl)
        return ms, count(ok_new)

    def apply_counters(ms: M.MapState, visible_mask, found_mask):
        """Fold per-frame visible/found masks into the map counters."""
        return ms._replace(
            mp_visible=ms.mp_visible + visible_mask.to(torch.int32),
            mp_found=ms.mp_found + found_mask.to(torch.int32))

    return TrackingFns(init_stereo=init_stereo, mono_match=mono_match,
                       mono_build=mono_build, track=track,
                       track_body=track_body, track_loc_body=track_loc_body,
                       track_ref_kf=track_ref_kf,
                       insert_keyframe_body=insert_keyframe_body,
                       apply_counters=apply_counters)
