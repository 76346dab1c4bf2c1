"""Data association: the dense matchers of ``ORBmatcher``.

Port of ``orbslam2_tpu/ops/matching.py``: full masked Hamming matrices
with window / level / epipolar gates as elementwise masks, best and
second best, ratio test, rotation histogram, one-source-per-target.
Match outputs are [n] int64 tensors with −1 sentinels.

``match_descriptors`` reaches the hand-written kernel through
``ops/hamming_top2.hamming_top2`` on CUDA tensors, with no cap on the
bank size (the JAX version's B ≤ 4096 guard was a TPU VMEM limit).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from orbslam2_tpu_torch.ops import hamming
from orbslam2_tpu_torch.ops.hamming_top2 import hamming_top2
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie
from orbslam2_tpu_torch.utils.index import scatter_min, topk

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
NO_MATCH = -1
# query points a block in search_by_projection's [P, N] pass: an int64
# [8192, 1024] temporary of the Hamming popcount is 64 MiB
PROJECTION_BLOCK = 8192


def _log_f32(x: float) -> float:
    """log of the float32-rounded scalar, in float32 (as jnp.log does)."""
    return torch.log(torch.tensor(x, dtype=torch.float32)).item()


def predict_scale(dist: torch.Tensor, max_dist: torch.Tensor,
                  scale_factor: float, n_levels: int) -> torch.Tensor:
    """MapPoint::PredictScale: log-ratio → pyramid level (int64)."""
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                     / _log_f32(scale_factor))
    return torch.clamp(lvl.to(torch.int32), 0, n_levels - 1).long()


def best_and_second(dist: torch.Tensor):
    """Per row: (best distance, first best index, second best excluding
    the best column)."""
    best = torch.amin(dist, dim=-1)
    best_idx = torch.argmin(dist, dim=-1)
    masked = dist.clone()
    masked.scatter_(-1, best_idx[..., None], hamming.MAX_DIST)
    return best, best_idx, torch.amin(masked, dim=-1)


def rotation_consistency_mask(angle_a: torch.Tensor,
                              angle_b_matched: torch.Tensor,
                              match_ok: torch.Tensor) -> torch.Tensor:
    """Keep matches whose orientation difference falls in the 3 dominant
    bins of a 30-bin histogram (ORBmatcher::ComputeThreeMaxima)."""
    two_pi = 2.0 * torch.pi
    # floor-mod as jnp.remainder computes it: an exact fmod, then a shift
    # into [0, 2π) (torch.remainder's a − b·floor(a/b) rounds differently)
    dtheta = torch.fmod(angle_a - angle_b_matched, two_pi)
    dtheta = torch.where(dtheta < 0, dtheta + two_pi, dtheta)
    bins = (dtheta * (HISTO_LENGTH / two_pi)).to(torch.int32)
    bins = torch.clamp(bins, 0, HISTO_LENGTH - 1).long()
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=bins.device)
    hist.index_add_(0, bins, match_ok.to(torch.int32))
    top3_vals, top3_idx = topk(hist, 3)
    keep2 = top3_vals[1] > 0.1 * top3_vals[0]
    keep3 = top3_vals[2] > 0.1 * top3_vals[0]
    ok_bin = ((bins == top3_idx[0])
              | ((bins == top3_idx[1]) & keep2)
              | ((bins == top3_idx[2]) & keep3))
    return match_ok & ok_bin


def resolve_duplicates(match_idx: torch.Tensor, match_dist: torch.Tensor,
                       n_targets: int) -> torch.Tensor:
    """One source per target: the lowest-distance source survives, ties to
    the lowest source index."""
    ok = match_idx >= 0
    tgt = torch.where(ok, match_idx, 0).long()
    big = hamming.MAX_DIST + 1
    dist = match_dist.to(torch.int32)
    best_per_tgt = scatter_min(
        torch.full((n_targets,), big, dtype=torch.int32,
                   device=tgt.device), tgt,
        torch.where(ok, dist, torch.full_like(dist, big)))
    attains = ok & (dist == best_per_tgt[tgt])
    n_src = match_idx.shape[0]
    src_ids = torch.arange(n_src, device=tgt.device)
    first_src = scatter_min(
        torch.full((n_targets,), n_src, dtype=torch.long, device=tgt.device),
        tgt, torch.where(attains, src_ids, n_src))
    survives = attains & (first_src[tgt] == src_ids)
    return torch.where(survives, match_idx.long(), NO_MATCH)


class ProjectionQuery(NamedTuple):
    """3D points to match into a frame by projection (raw scale bands)."""

    pos_w: torch.Tensor       # [P, 3]
    normal: torch.Tensor      # [P, 3]
    min_dist: torch.Tensor    # [P]
    max_dist: torch.Tensor    # [P]
    desc: torch.Tensor        # [P, 8] int32
    valid: torch.Tensor       # [P] bool


def _gated_best(uv: torch.Tensor, ur: torch.Tensor, win: torch.Tensor,
                pred_lvl: torch.Tensor, visible: torch.Tensor,
                desc: torch.Tensor, kp_xy: torch.Tensor,
                kp_level: torch.Tensor, kp_desc: torch.Tensor,
                kp_valid: torch.Tensor, kp_ur: torch.Tensor,
                check_ur: bool):
    """The [P, N] part of ``search_by_projection`` for a block of query
    rows: the gates and the gated Hamming best and second best.  Each row
    depends on its own point alone."""
    gate = torch.abs(uv[:, 0:1] - kp_xy[None, :, 0]) < win
    gate &= torch.abs(uv[:, 1:2] - kp_xy[None, :, 1]) < win
    lvl = kp_level.long()[None, :]
    gate &= ((lvl >= pred_lvl[:, None] - 1) & (lvl <= pred_lvl[:, None] + 1)
             & kp_valid[None, :] & visible[:, None])
    if check_ur:
        gate &= ((kp_ur[None, :] < 0)
                 | (torch.abs(ur[:, None] - kp_ur[None, :]) < win))
    d = hamming.hamming_matrix(desc, kp_desc)
    d.masked_fill_(~gate, hamming.MAX_DIST)
    return best_and_second(d)


def search_by_projection(
    cam: cam_mod.Camera, Tcw: torch.Tensor, query: ProjectionQuery,
    kp_xy: torch.Tensor, kp_level: torch.Tensor, kp_desc: torch.Tensor,
    kp_valid: torch.Tensor, kp_ur: torch.Tensor,
    scale_factor: float, n_levels: int, radius: float, nn_ratio: float,
    view_cos_limit: float = 0.5, check_ur: bool = False,
    th_dist: int = TH_HIGH,
):
    """ORBmatcher::SearchByProjection (frame ↔ points).  Returns
    (point→kp index [P], distance [P], projected uv [P, 2]); duplicates
    are not resolved here.

    The per-point projection runs over all P points at once; the [P, N]
    gates and distances run over blocks of ``PROJECTION_BLOCK`` points
    (one block where P is no larger), so a whole-map query
    (``recount_matches``: 131,072 points at 1024 keyframe slots) holds
    [PROJECTION_BLOCK, N] temporaries, not [P, N].  Every row depends on
    its own point alone, so the blocks give the single pass's bits."""
    visible, uv, ur, dist, view_cos = cam_mod.in_frustum(
        cam, Tcw, query.pos_w, 0.8 * query.min_dist, 1.2 * query.max_dist,
        query.normal, view_cos_limit)
    visible = visible & query.valid
    pred_lvl = predict_scale(dist, query.max_dist, scale_factor, n_levels)
    scale_of = torch.pow(scale_factor, pred_lvl.to(torch.float32))
    r = torch.where(view_cos > 0.998, 2.5, 4.0) * (radius / 4.0)
    win = (r * scale_of)[:, None]                            # [P, 1]

    kp = (kp_xy, kp_level, kp_desc, kp_valid, kp_ur, check_ur)
    P, B = uv.shape[0], PROJECTION_BLOCK
    parts = [_gated_best(uv[s:s + B], ur[s:s + B], win[s:s + B],
                         pred_lvl[s:s + B], visible[s:s + B],
                         query.desc[s:s + B], *kp)
             for s in range(0, max(P, 1), B)]
    if len(parts) == 1:
        best, best_idx, second = parts[0]
    else:
        best, best_idx, second = (torch.cat(x) for x in zip(*parts))
    ok = (best <= th_dist) & (best < nn_ratio * second.to(torch.float32))
    return torch.where(ok, best_idx, NO_MATCH), best, uv


def match_descriptors(
    desc_a: torch.Tensor, valid_a: torch.Tensor,
    desc_b: torch.Tensor, valid_b: torch.Tensor,
    nn_ratio: float = 0.7, th: int = TH_LOW,
    angle_a: Optional[torch.Tensor] = None,
    angle_b: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force a→b matching with ratio test, plus the rotation
    histogram check when angles are given.
    The distance/top-2 pass is ``hamming_top2`` (the Hopper kernel on
    CUDA tensors).  Returns (a→b index [A], distance [A])."""
    best, best_idx, second = hamming_top2(desc_a, valid_a, desc_b, valid_b)
    best_idx = best_idx.long()
    ok = ((best <= th) & (best < nn_ratio * second.to(torch.float32))
          & valid_a)
    if angle_a is not None:
        ok = rotation_consistency_mask(angle_a, angle_b[best_idx], ok)
    match = torch.where(ok, best_idx, NO_MATCH)
    return resolve_duplicates(match, best, desc_b.shape[0]), best


def search_for_initialization(
    xy_a: torch.Tensor, desc_a: torch.Tensor, valid_a: torch.Tensor,
    level_a: torch.Tensor, xy_b: torch.Tensor, desc_b: torch.Tensor,
    valid_b: torch.Tensor, level_b: torch.Tensor, angle_a: torch.Tensor,
    angle_b: torch.Tensor, window: float = 100.0, nn_ratio: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ORBmatcher::SearchForInitialization (ORBmatcher.cc:400): level-0
    features of the two bootstrap frames within ``window`` px in u and v,
    best and second best, ratio test, rotation histogram, one source per
    target.  Plain PyTorch over the full [A, B] matrix: the pairwise
    window gate keeps it off ``hamming_top2``.  Returns (a→b index [A],
    distance [A])."""
    d = hamming.masked_hamming_matrix(desc_a, valid_a, desc_b, valid_b)
    du = torch.abs(xy_a[:, 0:1] - xy_b[None, :, 0])
    dv = torch.abs(xy_a[:, 1:2] - xy_b[None, :, 1])
    gate = ((du < window) & (dv < window)
            & (level_a[:, None] == 0) & (level_b[None, :] == 0))
    d = torch.where(gate, d, torch.full_like(d, hamming.MAX_DIST))
    best, best_idx, second = best_and_second(d)
    ok = (best <= TH_LOW) & (best < nn_ratio * second.to(torch.float32))
    ok = rotation_consistency_mask(angle_a, angle_b[best_idx], ok)
    match = torch.where(ok, best_idx, NO_MATCH)
    return resolve_duplicates(match, best, desc_b.shape[0]), best


def search_for_triangulation(
    cam: cam_mod.Camera, T1w: torch.Tensor, T2w: torch.Tensor,
    kp1_xy, kp1_level, kp1_desc, kp1_free,
    kp2_xy, kp2_level, kp2_desc, kp2_free,
    angle1, angle2, sigma2: torch.Tensor,
):
    """ORBmatcher::SearchForTriangulation: match unassociated features of
    two keyframes under the epipolar constraint, skipping kp2 near the
    epipole.  Returns (kp1→kp2 index [N1], distance [N1])."""
    T21 = T2w @ lie.se3_inv(T1w)
    R21, t21 = lie.mat_to_rt(T21)
    Kinv = torch.linalg.inv(cam.K(T1w.device))
    F12 = Kinv.T @ lie.hat(t21) @ R21 @ Kinv

    p1 = torch.cat([kp1_xy, torch.ones_like(kp1_xy[:, :1])], dim=-1)
    lines = p1 @ F12.T                                       # [N1, 3]
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * kp2_xy[None, :, 0] + b * kp2_xy[None, :, 1] + c
    den = a * a + b * b
    dsq = (num * num) / torch.clamp(den, min=1e-12)
    lvl2_s2 = sigma2[kp2_level.long()]
    ep_ok = dsq < 3.84 * lvl2_s2[None, :]

    C1 = -T1w[:3, :3].T @ T1w[:3, 3]
    e2_uv, _ = cam_mod.project_world(cam, T2w, C1)
    de = torch.sum((kp2_xy - e2_uv) ** 2, dim=-1)
    epipole_ok = de >= 100.0 * lvl2_s2

    d = hamming.masked_hamming_matrix(kp1_desc, kp1_free, kp2_desc, kp2_free)
    d = torch.where(ep_ok & epipole_ok[None, :], d,
                    torch.full_like(d, hamming.MAX_DIST))
    best, best_idx, _ = best_and_second(d)
    ok = rotation_consistency_mask(angle1, angle2[best_idx], best <= TH_LOW)
    match = torch.where(ok, best_idx, NO_MATCH)
    return resolve_duplicates(match, best, kp2_desc.shape[0]), best
