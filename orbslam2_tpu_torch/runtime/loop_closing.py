"""Loop closing and relocalization: the tensor analogue of ``LoopClosing``.

Port of ``orbslam2_tpu/runtime/loop_closing.py``.  Per keyframe:

  detect   — BoW vector, DB registration, min-neighbour score, candidate
             query and the candidates' covisibility rows in one step; the
             host keeps the consecutive-group bookkeeping
             (LoopClosing.cc:139-248);
  compute  — KF↔KF descriptor matching (the ``hamming_top2`` kernel on
             CUDA) → batched Sim3 RANSAC → SearchBySim3 + OptimizeSim3 →
             projection recount against the loop KF's neighbourhood;
  correct  — Sim3 essential-graph optimization with the loop edge, point
             correction through reference keyframes, SearchAndFuse, then a
             global BA on a background thread (runtime/gba.py).

Relocalization (Tracking::Relocalization) shares the keyframe DB: a BoW
query, then per candidate descriptor matching (the kernel again), EPnP
RANSAC, pose optimization and the two-stage projection rescue.

The JAX ``lax.cond`` branches are host ``if``s on values read back from
the device.  RANSAC draws come from the closer's ``torch.Generator``,
seeded 42 as the JAX closer's ``PRNGKey(42)``.  ``global_ba`` is the
one-shot full-map BA of RunGlobalBundleAdjustment through the CG solver
(the engine runs the chunked background GBA of runtime/gba.py instead).

With a mesh (``parallel/mesh.py``: given as ``mesh=``, or made where the
closer's device is one of several local CUDA devices, JAX's
``device_count() > 1``) the keyframe DB is sharded by rows over it
(``parallel/db_shard.py``; every reader of ``db`` takes either form) and
the closer's ``GbaManager`` solves on it.  Not ported: the JIT
``prewarm*``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import MONOCULAR, SlamConfig
from orbslam2_tpu_torch.models import keyframe_db as db_mod
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.models.vocabulary import Vocabulary
from orbslam2_tpu_torch.ops import (bow, bundle, matching, pnp, pose_graph,
                                    pose_opt, sim3opt, sim3solver)
from orbslam2_tpu_torch.ops.hamming_top2 import launch_site
from orbslam2_tpu_torch.parallel import db_shard
from orbslam2_tpu_torch.parallel import mesh as mesh_mod
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.runtime import gba as gba_mod
from orbslam2_tpu_torch.runtime.gba import GbaManager
from orbslam2_tpu_torch.runtime.local_mapping import (MIN_COVIS_WEIGHT,
                                                      fuse_points_into_kf)
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie
from orbslam2_tpu_torch.utils.index import mask_of, scatter_set, topk

EDGE_COVIS_CAP = 16   # top covisibility edges per KF in the essential graph
PREV_LOOP_CAP = 8     # previous-loop edges carried into each correction
RELOC_MIN_INLIERS = 50   # Tracking.cc:1589


class LoopFns(NamedTuple):
    kf_bow_vector: object
    min_neighbor_score: object
    detect: object
    detect_step: object
    match_for_sim3: object
    refine_sim3: object
    recount_matches: object
    correct_loop: object
    fuse_after_loop: object
    global_ba: object
    frame_bow_vector: object
    reloc_attempt: object


def _neighbourhood(ms: M.MapState, kf: int) -> torch.Tensor:
    """[K] bool: ``kf`` and its covisible (≥ 15) keyframes."""
    n = M.covisibility_row(ms, kf) >= MIN_COVIS_WEIGHT
    n[kf] = True
    return n


def make_loop_fns(cfg: SlamConfig, voc: Vocabulary) -> LoopFns:
    """Loop-closing and relocalization steps for ``cfg``; they run on the
    device of the map tensors they are given."""
    cam = cam_mod.Camera.from_config(cfg.camera)
    N = cfg.orb.n_features_padded
    K = cfg.capacity.max_keyframes
    lcfg = cfg.loop
    sf, nl = cfg.orb.scale_factor, cfg.orb.n_levels
    fix_scale = cfg.sensor != MONOCULAR
    sigma2_np = np.array([sf ** (2 * l) for l in range(nl)], np.float32)

    def sigma2(dev):
        return torch.as_tensor(sigma2_np, device=dev)

    def kf_bow_vector(ms: M.MapState, kf: int) -> torch.Tensor:
        return bow.bow_vector(voc, ms.kf_desc[kf], ms.kf_kp_valid[kf])

    def min_neighbor_score(ms, db, kf: int, vec):
        """Lowest BoW similarity to the query's covisible neighbours
        (LoopClosing.cc:160-174) — candidates must beat it."""
        neigh = ((M.covisibility_row(ms, kf) >= MIN_COVIS_WEIGHT)
                 & ms.kf_valid & db.valid)
        return torch.amin(torch.where(neigh, db.scores(vec), float("inf")))

    def detect(ms, db, kf: int, vec, min_score):
        return db_mod.detect_candidates(db, ms, vec, kf, min_score,
                                        cfg.capacity.loop_candidates)

    def detect_step(ms: M.MapState, db: db_mod.KeyFrameDB, kf: int):
        """The per-keyframe detection prologue: BoW vector, DB
        registration, min-neighbour score, candidate query and the
        candidates' covisibility rows, packed as cand_info [C, 1 + K] for
        one host fetch.  Returns (db2, vec, cand_info)."""
        vec = kf_bow_vector(ms, kf)
        db2 = db.add(kf, vec)
        min_score = min_neighbor_score(ms, db2, kf, vec)
        cands, _ = detect(ms, db2, kf, vec, min_score)
        cov_rows = M.covisibility_rows(ms, torch.where(cands >= 0, cands, 0))
        return db2, vec, torch.cat([cands[:, None].to(cov_rows.dtype),
                                    cov_rows], dim=1)

    def match_for_sim3(ms: M.MapState, kf1: int, kf2: int,
                       generator: Optional[torch.Generator],
                       idx: Optional[torch.Tensor] = None):
        """KF↔KF descriptor matching + Sim3 RANSAC (LoopClosing.cc:
        294-360).  ``idx`` [128, 3] replaces the generator's draws.
        Returns (Sim3Result, kf1 → kf2 feature matches [N])."""
        v1 = ms.kf_kp_valid[kf1] & (ms.kf_mp[kf1] >= 0)
        v2 = ms.kf_kp_valid[kf2] & (ms.kf_mp[kf2] >= 0)
        with launch_site("match_for_sim3"):
            m, _ = matching.match_descriptors(
                ms.kf_desc[kf1], v1, ms.kf_desc[kf2], v2,
                nn_ratio=lcfg.sim3_nn_ratio, th=matching.TH_LOW,
                angle_a=ms.kf_angle[kf1], angle_b=ms.kf_angle[kf2])
        ok = m >= 0
        mp1 = ms.kf_mp[kf1].long()
        mp2 = ms.kf_mp[kf2][torch.where(ok, m, 0)].long()
        ok = (ok & (mp1 >= 0) & (mp2 >= 0)
              & ms.mp_valid[torch.where(mp1 >= 0, mp1, 0)]
              & ms.mp_valid[torch.where(mp2 >= 0, mp2, 0)])
        p1c = lie.transform_points(ms.kf_pose[kf1],
                                   ms.mp_pos[torch.where(ok, mp1, 0)])
        p2c = lie.transform_points(ms.kf_pose[kf2],
                                   ms.mp_pos[torch.where(ok, mp2, 0)])
        res = sim3solver.sim3_ransac(
            cam, p1c, p2c, ok, generator, fix_scale=fix_scale,
            n_hypotheses=128, min_inliers=lcfg.ransac_threshold_trigger,
            idx=idx)
        return res, m

    def refine_sim3(ms: M.MapState, kf1: int, kf2: int, s12, R12, t12):
        """SearchBySim3 + OptimizeSim3 (LoopClosing.cc:359-370).  Returns
        (s, R, t, n_inliers)."""
        dev = ms.kf_xy.device

        def feat_mp(kf):
            mp = ms.kf_mp[kf].long()
            ok = ((mp >= 0) & ms.kf_kp_valid[kf]
                  & ms.mp_valid[torch.where(mp >= 0, mp, 0)])
            idx = torch.where(ok, mp, 0)
            return ok, idx, lie.transform_points(ms.kf_pose[kf],
                                                 ms.mp_pos[idx])

        ok1, mp1, p1c_all = feat_mp(kf1)
        ok2, mp2, p2c_all = feat_mp(kf2)
        m12, _ = sim3opt.search_by_sim3(
            cam,
            ms.kf_xy[kf1], ms.kf_level[kf1], ms.kf_desc[kf1],
            ms.kf_kp_valid[kf1], p1c_all, ok1,
            ms.kf_xy[kf2], ms.kf_level[kf2], ms.kf_desc[kf2],
            ms.kf_kp_valid[kf2], p2c_all, ok2,
            ms.mp_min_dist[mp1], ms.mp_max_dist[mp1],
            ms.mp_min_dist[mp2], ms.mp_max_dist[mp2],
            s12, R12, t12, sf, nl,
            width=float(cfg.camera.width), height=float(cfg.camera.height))
        pair_ok = (m12 >= 0) & ok1
        j = torch.where(pair_ok, m12, 0)
        pair_ok = pair_ok & ok2[j]
        inv_s2 = 1.0 / sigma2(dev)
        res = sim3opt.optimize_sim3(
            cam, p1c_all, p2c_all[j], ms.kf_xy[kf1], ms.kf_xy[kf2][j],
            inv_s2[ms.kf_level[kf1].long()],
            inv_s2[ms.kf_level[kf2][j].long()],
            pair_ok, s12, R12, t12, fix_scale=fix_scale,
            iters_a=cfg.optimizer.sim3_iterations,
            iters_b=2 * cfg.optimizer.sim3_iterations)
        return res.s12, res.R12, res.t12, res.n_inliers

    def recount_matches(ms: M.MapState, kf1: int, kf2: int, s12, R12, t12):
        """SearchByProjection of the loop KF's neighbourhood points through
        the corrected pose (LoopClosing.cc:411-421)."""
        R2, t2 = lie.mat_to_rt(ms.kf_pose[kf2])
        sc, Rc, tc = lie.sim3_mul(s12, R12, t12, torch.ones_like(s12),
                                  R2, t2)
        Tcw = lie.rt_to_mat(Rc, tc / torch.clamp(sc, min=1e-9))
        neigh = ((M.covisibility_row(ms, kf2) >= MIN_COVIS_WEIGHT)
                 | (torch.arange(K, device=Tcw.device) == kf2))
        q = M.mp_projection_query(ms)
        q = q._replace(valid=q.valid & M.points_of_kfs(ms, neigh))
        m, d, _ = matching.search_by_projection(
            cam, Tcw, q, ms.kf_xy[kf1], ms.kf_level[kf1], ms.kf_desc[kf1],
            ms.kf_kp_valid[kf1], ms.kf_ur[kf1], sf, nl, radius=10.0,
            nn_ratio=2.0, th_dist=matching.TH_LOW)
        m = matching.resolve_duplicates(m, d, N)
        return torch.sum((m >= 0).to(torch.int32))

    def correct_loop(ms: M.MapState, kf_cur: int, kf_loop: int,
                     s12, R12, t12, prev_loop_i, prev_loop_j, prev_loop_ok
                     ) -> M.MapState:
        """Essential-graph optimization + map-point correction
        (LoopClosing::CorrectLoop + OptimizeEssentialGraph)."""
        dev = ms.kf_xy.device
        s0, R0, t0 = pose_graph.sim3_from_se3(ms.kf_pose)
        C = min(EDGE_COVIS_CAP, K)
        W = M.covisibility(ms)
        covw, covi = topk(torch.where(ms.kf_valid[None, :], W, 0), C)
        rows = torch.arange(K, device=dev)[:, None].expand(K, C)
        cov_ok = ((covw >= cfg.optimizer.covisible_keyframes)
                  & ms.kf_valid[rows] & (covi > rows))
        par = ms.kf_parent.long()
        par_ok = (par >= 0) & ms.kf_valid
        loop_i = torch.tensor([kf_cur], device=dev)
        loop_j = torch.tensor([kf_loop], device=dev)
        e_i = torch.cat([rows.reshape(-1), torch.arange(K, device=dev),
                         prev_loop_i.long(), loop_i])
        e_j = torch.cat([covi.reshape(-1), torch.where(par_ok, par, 0),
                         prev_loop_j.long(), loop_j])
        e_w = torch.cat([cov_ok.reshape(-1).float(), par_ok.float(),
                         prev_loop_ok.float(),
                         torch.ones(1, device=dev)])
        # measurements: the current relative poses; the loop edge carries
        # the Sim3-computed correction instead
        m_s, m_R, m_t = lie.sim3_mul(s0[e_i], R0[e_i], t0[e_i],
                                     *lie.sim3_inv(s0[e_j], R0[e_j],
                                                   t0[e_j]))
        m_s = torch.cat([m_s[:-1], s12.reshape(1).to(m_s.dtype)])
        m_R = torch.cat([m_R[:-1], R12[None].to(m_R.dtype)])
        m_t = torch.cat([m_t[:-1], t12[None].to(m_t.dtype)])
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[kf_loop] = True
        prob = pose_graph.PoseGraphProblem(
            s=s0, R=R0, t=t0, fixed=fixed, vertex_valid=ms.kf_valid,
            e_i=e_i, e_j=e_j, m_s=m_s, m_R=m_R, m_t=m_t, e_weight=e_w)
        s1, R1, t1 = pose_graph.optimize_pose_graph(
            prob, n_iters=cfg.optimizer.essential_graph_iterations,
            cg_iters=64, fix_scale=fix_scale)
        # map points follow their reference KF (Optimizer.cc:1057-1087)
        ref = torch.clamp(ms.mp_ref_kf, 0, K - 1).long()
        new_pos = pose_graph.correct_points(
            ms.mp_pos, s0[ref], R0[ref], t0[ref], s1[ref], R1[ref], t1[ref])
        return ms._replace(
            kf_pose=torch.where(ms.kf_valid[:, None, None],
                                pose_graph.se3_from_sim3(s1, R1, t1),
                                ms.kf_pose),
            mp_pos=torch.where(ms.mp_valid[:, None], new_pos, ms.mp_pos))

    def fuse_after_loop(ms: M.MapState, kf_cur: int, kf_loop: int):
        """SearchAndFuse (LoopClosing.cc:553-577, 621): loop-region points
        into the current KF, then the current region's into the loop KF.
        Returns (ms, n_merged)."""
        loop_pts = M.points_of_kfs(ms, _neighbourhood(ms, kf_loop))
        ms, n1 = fuse_points_into_kf(ms, kf_cur, loop_pts, cam, cfg)
        cur_pts = M.points_of_kfs(ms, _neighbourhood(ms, kf_cur))
        ms, n2 = fuse_points_into_kf(ms, kf_loop, cur_pts, cam, cfg)
        return ms, n1 + n2

    def global_ba(ms: M.MapState) -> M.MapState:
        """RunGlobalBundleAdjustment (LoopClosing.cc:679): every keyframe
        free except the gauge anchor, every live point and observation,
        5 robust + 5 plain LM iterations through the CG solver."""
        poses, points, _ = bundle.bundle_adjust(
            cam, gba_mod.full_map_problem(cfg, ms, M.kf_obs_ok(ms)),
            n_free=K, iters_a=5, iters_b=5, fix_first_free=True,
            solver="cg")
        return gba_mod.with_ba_result(ms, poses, points)

    def frame_bow_vector(desc, valid):
        return bow.bow_vector(voc, desc, valid)

    def reloc_attempt(ms: M.MapState, fd_desc, fd_valid, fd_xy, fd_level,
                      fd_ur, fd_angle, kf: int,
                      generator: Optional[torch.Generator],
                      idx: Optional[torch.Tensor] = None):
        """One relocalization candidate (Tracking.cc:1440-1603):
        descriptor match against the candidate KF's map points → EPnP
        RANSAC → pose optimization → the two-stage SearchByProjection
        rescue for 10–49 inliers.  ``idx`` [128, 4] replaces the
        generator's draws.  Returns (Tcw, n_inliers, assoc)."""
        dev = fd_xy.device
        n_kp = fd_xy.shape[0]
        kmp = ms.kf_mp[kf].long()
        kvalid = ms.kf_kp_valid[kf] & (kmp >= 0)
        with launch_site("reloc_attempt"):
            m, _ = matching.match_descriptors(
                fd_desc, fd_valid, ms.kf_desc[kf], kvalid,
                nn_ratio=cfg.tracking.relocalization_nn_ratio,
                th=matching.TH_LOW, angle_a=fd_angle,
                angle_b=ms.kf_angle[kf])
        ok = m >= 0
        mp = kmp[torch.where(ok, m, 0)]
        ok = ok & (mp >= 0) & ms.mp_valid[torch.where(mp >= 0, mp, 0)]
        assoc = torch.where(ok, mp, M.NO_MP)
        pts_w = ms.mp_pos[torch.where(ok, mp, 0)]
        s2 = sigma2(dev)
        inv_s2 = (1.0 / s2)[fd_level.long()]
        res = pnp.pnp_ransac(
            cam, pts_w, fd_xy, s2[fd_level.long()], ok, generator,
            n_hypotheses=128, chi2_th=cfg.tracking.pnp_ransac_th2,
            min_inliers=cfg.tracking.pnp_ransac_min_inliers, idx=idx)
        obs = pose_opt.PoseObs(pts_w=pts_w, uv=fd_xy, ur=fd_ur,
                               inv_sigma2=inv_s2, valid=ok)
        Tcw, inl, n = pose_opt.pose_optimization(cam, res.Tcw, obs)
        assoc = torch.where(inl, assoc, M.NO_MP)
        n = torch.where(res.ok, n, 0)

        # the rescue matches against the candidate KF's map points
        kmp_safe = torch.where(kvalid, kmp, 0)
        normals = ms.mp_normal()

        def rescue(Tcw, assoc, radius: float, th_dist: float):
            """SearchByProjection(frame, candidate, sFound, radius, th) +
            re-optimization; already-associated points are excluded."""
            found = mask_of(assoc, assoc >= 0, ms.P)
            q = matching.ProjectionQuery(
                pos_w=ms.mp_pos[kmp_safe], normal=normals[kmp_safe],
                min_dist=ms.mp_min_dist[kmp_safe],
                max_dist=ms.mp_max_dist[kmp_safe],
                desc=ms.mp_desc[kmp_safe],
                valid=kvalid & ms.mp_valid[kmp_safe] & ~found[kmp_safe])
            m2, d2, _ = matching.search_by_projection(
                cam, Tcw, q, fd_xy, fd_level, fd_desc, fd_valid, fd_ur,
                sf, nl, radius=radius, nn_ratio=2.0, th_dist=th_dist)
            m2 = matching.resolve_duplicates(m2, d2, n_kp)
            add = scatter_set(torch.full((n_kp,), M.NO_MP, dtype=torch.int64,
                                         device=dev),
                              torch.where(m2 >= 0, m2, 0), kmp_safe, m2 >= 0)
            merged = torch.where(assoc >= 0, assoc, add)
            ok3 = merged >= 0
            obs3 = pose_opt.PoseObs(
                pts_w=ms.mp_pos[torch.where(ok3, merged, 0)], uv=fd_xy,
                ur=fd_ur, inv_sigma2=inv_s2, valid=ok3)
            Tcw3, inl3, n3 = pose_opt.pose_optimization(cam, Tcw, obs3)
            return (Tcw3, torch.where(inl3, merged, M.NO_MP), n3,
                    int(torch.sum((add >= 0).to(torch.int32))))

        n_h = int(n)
        if 10 <= n_h < RELOC_MIN_INLIERS:
            Tcw2, assoc2, n2, n_add = rescue(Tcw, assoc, 10.0,
                                             float(matching.TH_HIGH))
            if n_add + n_h >= RELOC_MIN_INLIERS:           # Tracking.cc:1555
                n2_h = int(n2)
                if 30 < n2_h < RELOC_MIN_INLIERS:
                    Tcw4, assoc4, n4, n_add2 = rescue(Tcw2, assoc2, 3.0, 64.0)
                    if n2_h + n_add2 >= RELOC_MIN_INLIERS:  # :1569
                        Tcw2, assoc2, n2 = Tcw4, assoc4, n4
                Tcw, assoc, n = Tcw2, assoc2, n2
        return Tcw, n, assoc.to(torch.int32)

    return LoopFns(
        kf_bow_vector=kf_bow_vector, min_neighbor_score=min_neighbor_score,
        detect=detect, detect_step=detect_step,
        match_for_sim3=match_for_sim3, refine_sim3=refine_sim3,
        recount_matches=recount_matches, correct_loop=correct_loop,
        fuse_after_loop=fuse_after_loop, global_ba=global_ba,
        frame_bow_vector=frame_bow_vector, reloc_attempt=reloc_attempt)


class LoopCloser:
    """Host-side orchestration with the consistency-group bookkeeping of
    DetectLoop (LoopClosing.cc:188-248)."""

    def __init__(self, cfg: SlamConfig, voc: Vocabulary, device=None,
                 mesh=None):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.voc = voc.to(self.device)
        self.fns = make_loop_fns(cfg, self.voc)
        self.mesh = (mesh if mesh is not None
                     else mesh_mod.auto_mesh(self.device))
        self.gba = GbaManager(cfg, mesh=self.mesh)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(42)
        self.reset_db()
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.prev_loops: List[Tuple[int, int]] = []
        self.last_loop_kf = -1
        self._deferred: List[Tuple[int, int, torch.Tensor]] = []
        self.last_loop: Optional[Tuple[int, int]] = None

    def reset_db(self) -> None:
        """A fresh empty DB, sharded over the mesh where there is one."""
        db = db_mod.KeyFrameDB.empty(self.cfg.capacity.max_keyframes,
                                     self.voc.n_words, self.device)
        self.db = db if self.mesh is None else db_shard.shard_db(self.mesh,
                                                                 db)

    def reset(self) -> None:
        """Tracking::Reset's share of loop closing: no GBA, an empty DB,
        no loop history."""
        self.gba.abort()
        self.reset_db()
        self.consistent_groups = []
        self.prev_loops = []
        self.last_loop_kf = -1
        self._deferred = []

    def add_keyframe(self, ms: M.MapState, kf: int) -> None:
        self.db = self.db.add(kf, self.fns.kf_bow_vector(ms, kf))

    def _too_soon(self, kf_ordinal: int) -> bool:
        n = self.cfg.loop.minimum_keyframes
        return kf_ordinal < n or kf_ordinal - self.last_loop_kf < n

    def on_keyframe(self, ms: M.MapState, kf: int, kf_ordinal: int
                    ) -> Tuple[M.MapState, bool]:
        """DB registration + loop detection (+ correction on success) for
        keyframe slot ``kf``: the whole LoopClosing::Run iteration."""
        self.db, _, cand_info = self.fns.detect_step(ms, self.db, kf)
        if self._too_soon(kf_ordinal):
            return ms, False
        return self._detected(ms, kf, kf_ordinal, cand_info)

    def process(self, ms: M.MapState, kf: int, kf_ordinal: int
                ) -> Tuple[M.MapState, bool]:
        """Detection for an already-registered keyframe (add is
        idempotent)."""
        return self.on_keyframe(ms, kf, kf_ordinal)

    # ------------------------------------------- deferred (pipelined) API
    def on_keyframe_deferred(self, ms: M.MapState, kf: int,
                             kf_ordinal: int) -> None:
        """Run the detection prologue now, evaluate it at the next
        :meth:`poll_deferred` (the loop closer trails tracking by its
        queue, LoopClosing.cc:126)."""
        self.db, _, cand_info = self.fns.detect_step(ms, self.db, kf)
        self._deferred.append((kf, kf_ordinal, cand_info))

    def poll_deferred(self, ms: M.MapState) -> Tuple[M.MapState, bool]:
        """Evaluate the pending detections against the CURRENT map."""
        pend, self._deferred = self._deferred, []
        any_closed = False
        for kf, kf_ordinal, cand_info in pend:
            if self._too_soon(kf_ordinal):
                continue
            ms, closed = self._detected(ms, kf, kf_ordinal, cand_info)
            any_closed = any_closed or closed
        return ms, any_closed

    def _detected(self, ms, kf: int, kf_ordinal: int, cand_info
                  ) -> Tuple[M.MapState, bool]:
        info = cand_info.cpu().numpy()             # the one fetch
        cands = [int(c) for c in info[:, 0] if c >= 0]
        if not cands:
            self.consistent_groups = []
            return ms, False
        rows = {int(r[0]): r[1:] for r in info if r[0] >= 0}
        return self._evaluate_candidates(ms, kf, kf_ordinal, cands, rows)

    def _evaluate_candidates(self, ms, kf: int, kf_ordinal: int,
                             cands: List[int], rows
                             ) -> Tuple[M.MapState, bool]:
        lcfg = self.cfg.loop
        # covisibility-consistency accumulation (LoopClosing.cc:188-248)
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for c in cands:
            group = set(np.where(rows[c] >= MIN_COVIS_WEIGHT)[0].tolist()) \
                | {c}
            best = 0
            for prev_set, count in self.consistent_groups:
                if group & prev_set:
                    best = max(best, count + 1)
            new_groups.append((group, best))
            if best >= lcfg.covisibility_consistency_threshold:
                enough.append(c)
        self.consistent_groups = new_groups
        if not enough:
            return ms, False

        f = self.fns
        for cand in enough:
            res, _ = f.match_for_sim3(ms, kf, cand, self.generator)
            if not bool(res.ok):
                continue
            s12, R12, t12, n_opt = f.refine_sim3(ms, kf, cand, res.s12,
                                                 res.R12, res.t12)
            if int(n_opt) < lcfg.ransac_minimal_inliers:
                continue
            if int(f.recount_matches(ms, kf, cand, s12, R12, t12)) \
                    < lcfg.detection_threshold:
                continue
            loops = self.prev_loops[-PREV_LOOP_CAP:]
            pad = PREV_LOOP_CAP - len(loops)
            pl_i = torch.tensor([i for i, _ in loops] + [0] * pad,
                                device=self.device)
            pl_j = torch.tensor([j for _, j in loops] + [0] * pad,
                                device=self.device)
            pl_ok = torch.tensor([True] * len(loops) + [False] * pad,
                                 device=self.device)
            # a new loop supersedes a running GBA (LoopClosing.cc:446-459)
            self.gba.abort()
            ms = f.correct_loop(ms, kf, cand, s12, R12, t12, pl_i, pl_j,
                                pl_ok)
            ms, _ = f.fuse_after_loop(ms, kf, cand)
            # GBA on the corrected snapshot, merged at a later poll
            # (LoopClosing.cc:613)
            self.gba.launch(ms)
            self.prev_loops.append((kf, cand))
            self.last_loop = (kf, cand)
            self.last_loop_kf = kf_ordinal
            self.consistent_groups = []
            return ms, True
        return ms, False

    # ---------------------------------------------------- relocalization --
    def relocalize(self, ms: M.MapState, fd,
                   db: Optional[db_mod.KeyFrameDB] = None
                   ) -> Tuple[Optional[np.ndarray], Optional[torch.Tensor]]:
        """Tracking::Relocalization: BoW query of the DB (``db``, by default
        the loop closer's own) → per-candidate EPnP RANSAC + pose
        optimization; success at ≥ 50 inliers.  Returns (Tcw, assoc) or
        (None, None)."""
        f = self.fns
        vec = f.frame_bow_vector(fd.desc, fd.valid)
        cands, _ = f.detect(ms, self.db if db is None else db, -1, vec, 0.0)
        for c in cands.tolist():
            if c < 0:
                continue
            Tcw, n, assoc = f.reloc_attempt(
                ms, fd.desc, fd.valid, fd.xy, fd.level, fd.ur, fd.angle, c,
                self.generator)
            if int(n) >= RELOC_MIN_INLIERS:
                return Tcw.cpu().numpy(), assoc
        return None, None
