"""Two-view triangulation + new-map-point creation between keyframes.

Port of ``orbslam2_tpu/ops/triangulate.py`` (LocalMapping::
CreateNewMapPoints): epipolar matching of unassociated features, linear
triangulation, and the parallax / cheirality / reprojection / scale
acceptance gates, batched over the feature set.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.ops import matching
from orbslam2_tpu_torch.ops.bundle import inv3x3
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie
from orbslam2_tpu_torch.utils.index import scatter_set


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous linear triangulation: P1/P2 [..., 3, 4], uv [N, 2] →
    [..., N, 3] world points via the 3×3 normal equations (w = 1); the
    leading dimensions of P1 and P2 broadcast (the mono initializer
    triangulates under 12 motion hypotheses at once)."""
    def rows(P, uv):
        p0, p1, p2 = (P[..., r, None, :] for r in range(3))
        return uv[:, 0:1] * p2 - p0, uv[:, 1:2] * p2 - p1

    A = torch.stack(torch.broadcast_tensors(*rows(P1, uv1), *rows(P2, uv2)),
                    dim=-2)                                    # [..., N, 4, 4]
    B = A[..., :3]
    b = -A[..., 3]
    BtB = torch.sum(B[..., :, None] * B[..., None, :], dim=-3)
    Btb = torch.sum(B * b[..., None], dim=-2)
    return torch.sum(inv3x3(BtB) * Btb[..., None, :], dim=-1)


class TriangulationResult(NamedTuple):
    pos_w: torch.Tensor     # [N, 3] candidate new points
    ok: torch.Tensor        # [N] acceptance
    match2: torch.Tensor    # [N] matched feature in KF2 (−1)


def make_triangulation_bodies(cfg: SlamConfig):
    """(triangulate_between, insert_triangulated) for ``cfg``."""
    cam = cam_mod.Camera.from_config(cfg.camera)
    sigma2_np = np.array([cfg.orb.scale_factor ** (2 * l)
                          for l in range(cfg.orb.n_levels)], np.float32)
    sf = cfg.orb.scale_factor
    ratio_factor = 1.5 * sf

    def triangulate_between(ms: M.MapState, kf1, kf2) -> TriangulationResult:
        """Candidate points between keyframes kf1/kf2 from features not yet
        associated; the kf1 side is compacted to its free features."""
        N = ms.N
        dev = ms.kf_xy.device
        sigma2 = torch.as_tensor(sigma2_np, device=dev)
        R1 = max(256, N // 2)
        T1, T2 = ms.kf_pose[kf1], ms.kf_pose[kf2]
        free1_full = ms.kf_kp_valid[kf1] & (ms.kf_mp[kf1] < 0)
        free2 = ms.kf_kp_valid[kf2] & (ms.kf_mp[kf2] < 0)
        rows, free1 = M.compact_mask(free1_full, R1)
        m_c, _ = matching.search_for_triangulation(
            cam, T1, T2,
            ms.kf_xy[kf1][rows], ms.kf_level[kf1][rows],
            ms.kf_desc[kf1][rows], free1,
            ms.kf_xy[kf2], ms.kf_level[kf2], ms.kf_desc[kf2], free2,
            ms.kf_angle[kf1][rows], ms.kf_angle[kf2], sigma2)
        m = scatter_set(torch.full((N,), -1, dtype=torch.int64, device=dev),
                        rows, m_c, free1)
        ok = m >= 0
        msafe = torch.where(ok, m, 0)
        uv1 = ms.kf_xy[kf1]
        uv2 = ms.kf_xy[kf2][msafe]
        K_mat = cam.K(dev)
        Xw = triangulate_dlt(K_mat @ T1[:3, :], K_mat @ T2[:3, :], uv1, uv2)

        C1 = -T1[:3, :3].T @ T1[:3, 3]
        C2 = -T2[:3, :3].T @ T2[:3, 3]
        r1 = Xw - C1
        r2 = Xw - C2
        d1 = torch.linalg.vector_norm(r1, dim=-1)
        d2 = torch.linalg.vector_norm(r2, dim=-1)
        cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(d1 * d2, min=1e-9)

        pc1 = lie.transform_points(T1, Xw)
        pc2 = lie.transform_points(T2, Xw)
        lvl1 = ms.kf_level[kf1].long()
        lvl2 = ms.kf_level[kf2][msafe].long()
        e1 = torch.sum((cam_mod.project(cam, pc1) - uv1) ** 2, dim=-1) \
            / sigma2[lvl1]
        e2 = torch.sum((cam_mod.project(cam, pc2) - uv2) ** 2, dim=-1) \
            / sigma2[lvl2]

        ratio_dist = d2 / torch.clamp(d1, min=1e-9)
        ratio_octave = (torch.pow(sf, lvl1.to(torch.float32))
                        / torch.pow(sf, lvl2.to(torch.float32)))
        scale_ok = ((ratio_dist * ratio_factor > ratio_octave)
                    & (ratio_dist < ratio_octave * ratio_factor))
        ok = (ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (cos_par < 0.9998)
              & (e1 < 5.991) & (e2 < 5.991) & scale_ok
              & (d1 > 1e-3) & (d2 > 1e-3))
        return TriangulationResult(pos_w=Xw, ok=ok, match2=m)

    def insert_triangulated(ms: M.MapState, kf1, kf2,
                            tri: TriangulationResult, kf_ordinal: int):
        """Allocate slots for accepted candidates and add observations in
        both keyframes.  Returns (ms, n_inserted)."""
        N = ms.N
        dev = ms.kf_xy.device
        slots, ok = M.alloc_mp_slots(ms, tri.ok)
        ms = M.add_map_points(ms, slots, tri.pos_w, ok, ref_kf=kf1,
                              first_kf=kf_ordinal)
        ids = torch.where(ok, slots, M.NO_MP)
        ms = M.add_observations(ms, kf1, torch.arange(N, device=dev), ids,
                                ok, sf, cfg.orb.n_levels)
        ms = M.add_observations(ms, kf2, torch.where(ok, tri.match2, 0), ids,
                                ok, sf, cfg.orb.n_levels)
        return ms, torch.sum(ok.to(torch.int32))

    return triangulate_between, insert_triangulated
