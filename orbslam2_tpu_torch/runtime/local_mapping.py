"""Local mapping: the tensor analogue of ``LocalMapping``.

Port of ``orbslam2_tpu/runtime/local_mapping.py``: the mapping bodies
(local BA, map-point culling, keyframe culling, two-way fuse, capacity
eviction) and ``make_mapping_step``, the whole keyframe-insertion
pipeline: counter fold → insert → point cull → triangulation over the
top covisible neighbours → fuse → local BA → keyframe cull.

The JAX ``cond``/``fori_loop`` branches become Python control flow on
values read back from the device; a branch the JAX version evaluates
but masks to a no-op (a neighbour below the covisibility threshold, a
cull candidate that is not cullable) is skipped here.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_tpu_torch.config import MONOCULAR, SlamConfig
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.ops import bundle, matching
from orbslam2_tpu_torch.ops import triangulate as tri_mod
from orbslam2_tpu_torch.runtime import tracking as tracking_mod
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils.index import mask_of, scatter_set, topk

MIN_COVIS_WEIGHT = 15  # covisibility edge threshold (KeyFrame.cc:325)


def fuse_points_into_kf(ms: M.MapState, kf, pt_mask, cam, cfg):
    """ORBmatcher::Fuse against keyframe ``kf`` for the points in
    ``pt_mask``: on a conflicting association keep the better-observed
    point, attach where the keypoint is unassociated.  Returns
    (ms, n_merged)."""
    N, P = ms.N, ms.P
    C = min(cfg.capacity.fuse_candidates, P)
    Tcw = ms.kf_pose[kf]
    normals = ms.mp_normal()
    vis, _, _, _, _ = cam_mod.in_frustum(
        cam, Tcw, ms.mp_pos, 0.8 * ms.mp_min_dist, 1.2 * ms.mp_max_dist,
        normals)
    ids, sel_ok = M.compact_mask(pt_mask & ms.mp_valid & vis, C)
    q = matching.ProjectionQuery(
        pos_w=ms.mp_pos[ids], normal=normals[ids],
        min_dist=ms.mp_min_dist[ids], max_dist=ms.mp_max_dist[ids],
        desc=ms.mp_desc[ids], valid=sel_ok)
    m, d, _ = matching.search_by_projection(
        cam, Tcw, q, ms.kf_xy[kf], ms.kf_level[kf], ms.kf_desc[kf],
        ms.kf_kp_valid[kf], ms.kf_ur[kf], cfg.orb.scale_factor,
        cfg.orb.n_levels, radius=3.0, nn_ratio=2.0, check_ur=True,
        th_dist=matching.TH_LOW)
    m = matching.resolve_duplicates(m, d, N)
    pids = ids
    f_safe = torch.where(m >= 0, m, 0)
    existing = torch.where(m >= 0, ms.kf_mp[kf][f_safe].long(), -2)

    merge = (m >= 0) & (existing >= 0) & (existing != pids)
    ex_safe = torch.where(merge, existing, 0)
    p_wins = ms.mp_n_obs[pids] > ms.mp_n_obs[ex_safe]
    old = torch.where(p_wins, ex_safe, pids)
    new = torch.where(p_wins, pids, ex_safe)
    old_to_new = scatter_set(torch.full((P,), -1, dtype=torch.int64,
                                        device=pids.device), old, new, merge)
    y_safe = torch.where(old_to_new >= 0, old_to_new, 0)
    chain = (old_to_new >= 0) & (old_to_new[y_safe] >= 0)
    old_to_new = torch.where(chain, -1, old_to_new)
    n_merged = torch.sum((old_to_new >= 0).to(torch.int32))
    ms = M.replace_map_points(ms, old_to_new)

    attach = (m >= 0) & (existing == M.NO_MP) & sel_ok & ms.mp_valid[pids]
    ms = M.add_observations(ms, kf, f_safe, pids, attach,
                            cfg.orb.scale_factor, cfg.orb.n_levels)
    return ms, n_merged


def _redundancy(ms: M.MapState, n_levels: int):
    """Per keyframe: (ok [K, N] live associations, fraction of them seen
    by ≥3 other keyframes at the same or finer level [K])."""
    ok = M.kf_obs_ok(ms)
    mp_safe = torch.where(ok, ms.kf_mp, 0).long()
    lvl = torch.clamp(ms.kf_level.long(), 0, n_levels - 1)
    hist = torch.zeros(ms.P * n_levels, dtype=torch.int32,
                       device=ok.device)
    hist.index_add_(0, (mp_safe * n_levels + lvl).reshape(-1),
                    ok.to(torch.int32).reshape(-1))
    cum = torch.cumsum(hist.reshape(ms.P, n_levels), dim=1)
    lvl_cap = torch.clamp(ms.kf_level.long() + 1, 0, n_levels - 1)
    total = cum[mp_safe, lvl_cap]
    redundant = ok & (total - 1 >= 3)
    n_tracked = torch.sum(ok.to(torch.int32), dim=1)
    n_red = torch.sum(redundant.to(torch.int32), dim=1)
    frac = n_red.to(torch.float32) / torch.clamp(
        n_tracked.to(torch.float32), min=1.0)
    return ok, frac


def _drop_keyframe(ms: M.MapState, victim: int, out: torch.Tensor
                   ) -> M.MapState:
    """Remove one keyframe: erase its associations in ``out``, hand its
    children to its parent, mark it invalid."""
    N = ms.N
    ms2 = M.remove_observations(ms, victim, torch.arange(N, device=out.device),
                                out)
    children = ms.kf_parent == victim
    kf_parent = torch.where(children, ms.kf_parent[victim], ms2.kf_parent)
    kf_valid = ms2.kf_valid.clone()
    kf_valid[victim] = False
    return ms2._replace(kf_valid=kf_valid, kf_parent=kf_parent)


class MappingFns:
    """Mapping step bodies for one config."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.cam = cam_mod.Camera.from_config(cfg.camera)
        L = cfg.capacity.local_ba_keyframes
        self.L = L
        self.F = min(max(8, L // 2), cfg.capacity.max_keyframes)
        self.P_loc = cfg.capacity.local_ba_points
        sigma2 = np.array([cfg.orb.scale_factor ** (2 * l)
                           for l in range(cfg.orb.n_levels)], np.float32)
        self.inv_sigma2 = (1.0 / sigma2).astype(np.float32)

    def local_ba(self, ms: M.MapState, current_kf: int):
        """LocalBundleAdjustment (Optimizer.cc:497): covisibility window,
        dense-Schur BA, outlier-observation erasure.
        Returns (ms, n_outlier_obs_removed)."""
        cfg, L, F, P_loc = self.cfg, self.L, self.F, self.P_loc
        K, N, dev = ms.K, ms.N, ms.kf_xy.device
        w_cur = M.covisibility_row(ms, current_kf).clone()
        w_cur[current_kf] = 1 << 28
        kidx = torch.arange(K, device=dev)
        w_free = torch.where((kidx == 0) | ~ms.kf_valid, 0, w_cur)
        topw, free_ids = topk(w_free, L)
        free_ok = (topw >= MIN_COVIS_WEIGHT) | (free_ids == current_kf)
        free_mask_k = mask_of(free_ids, free_ok, K)

        pt_mask = M.points_of_kfs(ms, free_mask_k) & ms.mp_valid
        pt_ids, pt_sel = M.compact_mask(pt_mask, P_loc)
        local_of = scatter_set(torch.full((ms.P,), -1, dtype=torch.int64,
                                          device=dev), pt_ids,
                               torch.arange(P_loc, device=dev), pt_sel)

        sees_sel = M.kf_share_counts(ms, pt_mask) > 0
        fixed_cand = sees_sel & (~free_mask_k) & ms.kf_valid
        fixed_score = torch.where(fixed_cand, w_cur + 1, 0)
        fixed_score[0] = torch.where(fixed_cand[0], 1 << 28, 0)
        topf, fixed_ids = topk(fixed_score, F)
        fixed_ok = topf > 0

        window_ids = torch.cat([free_ids, fixed_ids])
        window_ok = torch.cat([free_ok, fixed_ok])
        kfm = ms.kf_mp[window_ids].long()
        lidx = local_of[torch.where(kfm >= 0, kfm, 0)]
        obs_ok = ((kfm >= 0) & (lidx >= 0) & ms.kf_kp_valid[window_ids]
                  & window_ok[:, None])
        cam_i = torch.arange(L + F, device=dev)[:, None].expand(L + F, N)
        inv_s2 = torch.as_tensor(self.inv_sigma2, device=dev)
        prob = bundle.BAProblem(
            poses=ms.kf_pose[window_ids], points=ms.mp_pos[pt_ids],
            point_valid=pt_sel, cam_i=cam_i.reshape(-1),
            pt_i=torch.where(obs_ok, lidx, 0).reshape(-1),
            uv=ms.kf_xy[window_ids].reshape(-1, 2),
            ur=ms.kf_ur[window_ids].reshape(-1),
            inv_sigma2=inv_s2[ms.kf_level[window_ids].long()].reshape(-1),
            valid=obs_ok.reshape(-1))
        poses, points, inlier = bundle.bundle_adjust(
            self.cam, prob, n_free=L,
            iters_a=cfg.optimizer.additional_iterations_no_outliers,
            iters_b=cfg.optimizer.additional_iterations)

        ms = ms._replace(
            kf_pose=scatter_set(ms.kf_pose, free_ids, poses[:L], free_ok),
            mp_pos=scatter_set(ms.mp_pos, pt_ids, points, pt_sel))
        outlier = prob.valid & (~inlier)
        ms = M.remove_observations_batch(ms, window_ids,
                                         outlier.reshape(L + F, N))
        return ms, torch.sum(outlier.to(torch.int32))

    def fuse_into_kf(self, ms: M.MapState, kf: int):
        """SearchInNeighbors (LocalMapping.cc:454), two-way: the covisible
        neighbourhood's points into ``kf``, then ``kf``'s points into its
        strongest covisible neighbour.  Returns (ms, n_merged)."""
        neigh = (M.covisibility_row(ms, kf) >= MIN_COVIS_WEIGHT).clone()
        neigh[kf] = True
        ms, n1 = fuse_points_into_kf(ms, kf, M.points_of_kfs(ms, neigh),
                                     self.cam, self.cfg)
        w2 = M.covisibility_row(ms, kf)
        best_nb = int(torch.argmax(w2))
        if int(w2[best_nb]) < MIN_COVIS_WEIGHT:
            return ms, n1
        ms, n2 = fuse_points_into_kf(ms, best_nb, M.points_of_kf(ms, kf),
                                     self.cam, self.cfg)
        return ms, n1 + n2

    def cull_map_points(self, ms: M.MapState, current_kf_count: int):
        """MapPointCulling (LocalMapping.cc:170).  Returns (ms, n_culled)."""
        age = current_kf_count - ms.mp_first_kf
        ratio = ms.mp_found.to(torch.float32) / torch.clamp(
            ms.mp_visible.to(torch.float32), min=1.0)
        th_obs = 2 if self.cfg.sensor == MONOCULAR else 3
        bad = ms.mp_valid & (age <= 3) & (
            (ratio < 0.25) | ((age >= 2) & (ms.mp_n_obs <= th_obs)))
        return M.invalidate_map_points(ms, bad), torch.sum(
            bad.to(torch.int32))

    def cull_keyframes(self, ms: M.MapState, current_kf: int):
        """KeyFrameCulling (LocalMapping.cc:629): cull up to
        ``kf_cull_victims`` covisible keyframes whose points are ≥90%
        redundant.  Returns (ms, n_culled, victims [V] with −1 = none)."""
        K, dev = ms.K, ms.kf_xy.device
        ok, frac = _redundancy(ms, self.cfg.orb.n_levels)
        kidx = torch.arange(K, device=dev)
        is_local = M.covisibility_row(ms, current_kf) >= MIN_COVIS_WEIGHT
        cullable = (ms.kf_valid & is_local & (frac > 0.9)
                    & (kidx != 0) & (kidx != current_kf))
        V = max(1, self.cfg.capacity.kf_cull_victims)
        _, victims = topk(torch.where(cullable, frac, -1.0), V)
        cullable_h = cullable.tolist()
        out = []
        for v in victims.tolist():
            if cullable_h[v] and bool(ms.kf_valid[v]):
                ms = _drop_keyframe(ms, v, ok[v])
                out.append(v)
            else:
                out.append(-1)
        n = sum(v >= 0 for v in out)
        return ms, n, torch.tensor(out, dtype=torch.int32, device=dev)

    def evict_keyframe(self, ms: M.MapState, current_kf: int,
                       newest_frame_id: int):
        """Capacity-pressure eviction of the most redundant live keyframe
        (protected: slot 0, the current reference, the last second of
        video; older breaks ties).  Returns (ms, victim or −1)."""
        K, dev = ms.K, ms.kf_xy.device
        ok, frac = _redundancy(ms, self.cfg.orb.n_levels)
        recent = ms.kf_frame_id >= newest_frame_id - max(
            int(self.cfg.camera.fps), 1)
        kidx = torch.arange(K, device=dev)
        cullable = (ms.kf_valid & (kidx != 0) & (kidx != current_kf)
                    & ~recent)
        score = torch.where(
            cullable,
            1.0 + frac - 1e-9 * ms.kf_frame_id.to(torch.float32), -1.0)
        victim = int(torch.argmax(score))
        if not float(score[victim]) > 0.0:
            return ms, -1
        return _drop_keyframe(ms, victim, ok[victim]), victim


def make_mapping_step(cfg: SlamConfig):
    """The keyframe-insertion pipeline (LocalMapping::Run order):

        counter fold → CreateNewKeyFrame → MapPointCulling →
        CreateNewMapPoints over the top covisible neighbours →
        SearchInNeighbors → LocalBundleAdjustment (do_ba) →
        KeyFrameCulling (do_cull)

    Returns mapping_step(...) → (ms, stats [7 + V] int32) with stats =
    [n_new_points, n_culled_points, n_triangulated, n_fused,
    n_ba_outliers, n_kfs_culled, n_live_points, victim_0..V−1 (−1)]."""
    tfns = tracking_mod.make_tracking_fns(cfg)
    mfns = MappingFns(cfg)
    tri_between, insert_tri = tri_mod.make_triangulation_bodies(cfg)
    nb_default = 20 if cfg.sensor == MONOCULAR else 10
    TRI_NB = min(cfg.capacity.triangulation_neighbors or nb_default,
                 cfg.capacity.max_keyframes - 1)
    V = max(1, cfg.capacity.kf_cull_victims)

    def mapping_step(ms: M.MapState, fd, Tcw, assoc, kf_slot: int,
                     kf_ordinal: int, parent: int, frame_id: int,
                     timestamp: float, do_ba: bool, do_cull: bool,
                     vis_acc, found_acc):
        dev = ms.kf_xy.device
        ms = ms._replace(mp_visible=ms.mp_visible + vis_acc,
                         mp_found=ms.mp_found + found_acc)
        ms, n_new = tfns.insert_keyframe_body(
            ms, fd, Tcw, assoc, kf_slot, kf_ordinal, parent, frame_id,
            timestamp)
        ms, n_culled = mfns.cull_map_points(ms, kf_ordinal)

        # CreateNewMapPoints: every neighbour's candidates come from the
        # same pre-insert map; inserts are sequential and re-check the
        # live map so a feature matched by several neighbours is inserted
        # once
        topw, topi = topk(M.covisibility_row(ms, kf_slot), TRI_NB)
        nbs = [nb for w, nb in zip(topw.tolist(), topi.tolist())
               if w >= MIN_COVIS_WEIGHT]
        tris = [tri_between(ms, kf_slot, nb) for nb in nbs]
        n_tri = torch.zeros((), dtype=torch.int32, device=dev)
        for nb, tri in zip(nbs, tris):
            free1 = ms.kf_mp[kf_slot] < 0
            ms, n_ins = insert_tri(ms, kf_slot, nb,
                                   tri._replace(ok=tri.ok & free1),
                                   kf_ordinal)
            n_tri = n_tri + n_ins

        ms, n_fused = mfns.fuse_into_kf(ms, kf_slot)
        n_out = torch.zeros((), dtype=torch.int32, device=dev)
        if do_ba:
            ms, n_out = mfns.local_ba(ms, kf_slot)
        n_kf_culled = 0
        victims = torch.full((V,), -1, dtype=torch.int32, device=dev)
        if do_cull:
            ms, n_kf_culled, victims = mfns.cull_keyframes(ms, kf_slot)
        n_live = torch.sum(ms.mp_valid.to(torch.int32))
        head = torch.stack([torch.as_tensor(x, device=dev).to(torch.int32)
                            for x in (n_new, n_culled, n_tri, n_fused,
                                      n_out, n_kf_culled, n_live)])
        return ms, torch.cat([head, victims])

    return mapping_step
