"""Stereo depth association: left↔right matching + SAD sub-pixel.

Port of ``orbslam2_tpu/ops/stereo.py``: row-band / level / disparity
gates over one dense masked Hamming matrix, then SAD refinement on each
keypoint's own pyramid level with the JAX version's common-centre
brightness normalisation (``stereo.py:93-100``, which deliberately differs
from Frame.cc:567).  Patches are gathered directly from the concatenated
pyramid instead of the JAX version's per-level one-hot matmuls.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from orbslam2_tpu_torch.ops import hamming
from orbslam2_tpu_torch.ops.extractor import Features
from orbslam2_tpu_torch.ops.matching import TH_HIGH, TH_LOW, best_and_second

SAD_W = 5      # half window (11×11 patches)
SAD_L = 5      # slide range ±5


class StereoMatches(NamedTuple):
    u_right: torch.Tensor   # [N] float32, −1 where unmatched
    depth: torch.Tensor     # [N] float32, −1 where unmatched


def masked_median(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Median (lower middle) of x[ok]; +inf when nothing is valid."""
    n = x.shape[0]
    vals = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf"))
                                  )).values
    n_ok = torch.sum(ok.to(torch.int64))
    mid = torch.clamp(n_ok - 1, min=0) // 2
    return vals[torch.clamp(mid, 0, n - 1)]


class _FlatPyramid:
    """All levels of a pyramid in one flat buffer, for per-keypoint
    gathers on the keypoint's own level."""

    def __init__(self, pyr: List[torch.Tensor]):
        dev = pyr[0].device
        self.flat = torch.cat([p.reshape(-1) for p in pyr])
        sizes = [p.shape for p in pyr]
        offs = [0]
        for h, w in sizes[:-1]:
            offs.append(offs[-1] + h * w)
        self.off = torch.tensor(offs, dtype=torch.long, device=dev)
        self.h = torch.tensor([s[0] for s in sizes], dtype=torch.long,
                              device=dev)
        self.w = torch.tensor([s[1] for s in sizes], dtype=torch.long,
                              device=dev)

    def patches(self, level, cx, cy, half_h: int, half_w: int):
        """[n] level/centres → [n, 2·half_h+1, 2·half_w+1] windows, centres
        clamped into each level's image (``sampling.extract_patches``)."""
        dev = cx.device
        h, w = self.h[level], self.w[level]
        cyc = torch.minimum(torch.clamp(cy, min=half_h), h - 1 - half_h)
        cxc = torch.minimum(torch.clamp(cx, min=half_w), w - 1 - half_w)
        rows = cyc[:, None] + torch.arange(-half_h, half_h + 1, device=dev)
        cols = cxc[:, None] + torch.arange(-half_w, half_w + 1, device=dev)
        idx = (self.off[level][:, None, None] + rows[:, :, None]
               * w[:, None, None] + cols[:, None, :])
        return self.flat[idx]


def match_stereo(feats_l: Features, feats_r: Features,
                 pyr_l: List[torch.Tensor], pyr_r: List[torch.Tensor],
                 bf: float, fx: float, scale_factor: float) -> StereoMatches:
    """Full stereo pipeline for one rectified frame pair."""
    scales = torch.pow(scale_factor, feats_r.level.to(torch.float32))
    uL, vL = feats_l.xy[:, 0], feats_l.xy[:, 1]
    uR, vR = feats_r.xy[:, 0], feats_r.xy[:, 1]

    max_disp = fx
    row_ok = torch.abs(vR[None, :] - vL[:, None]) <= 2.0 * scales[None, :]
    lvl_ok = torch.abs(feats_r.level[None, :] - feats_l.level[:, None]) <= 1
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp >= -1.0) & (disp <= max_disp)

    d = hamming.masked_hamming_matrix(feats_l.desc, feats_l.valid,
                                      feats_r.desc, feats_r.valid)
    d = torch.where(row_ok & lvl_ok & disp_ok, d,
                    torch.full_like(d, hamming.MAX_DIST))
    best, best_idx, _ = best_and_second(d)
    coarse_ok = best < (TH_HIGH + TH_LOW) // 2

    # ---- SAD sub-pixel refinement on the keypoint's own pyramid level ----
    lvl = feats_l.level.long()
    inv_scale_l = torch.pow(scale_factor, -feats_l.level.to(torch.float32))
    suL = torch.round(uL * inv_scale_l).to(torch.int32).long()
    svL = torch.round(vL * inv_scale_l).to(torch.int32).long()
    suR0 = torch.round(uR[best_idx] * inv_scale_l).to(torch.int32).long()

    n_shifts = 2 * SAD_L + 1
    patch_l = _FlatPyramid(pyr_l).patches(lvl, suL, svL, SAD_W, SAD_W)
    wide = _FlatPyramid(pyr_r).patches(lvl, suR0, svL, SAD_W, SAD_W + SAD_L)
    patch_l = patch_l - patch_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    # common-centre normalisation: the value at suR0 (centre of the middle
    # window) offsets every shifted window
    center = wide[:, SAD_W:SAD_W + 1, SAD_W + SAD_L:SAD_W + SAD_L + 1]
    win_r = wide.unfold(2, 2 * SAD_W + 1, 1)           # [N, 11, 11 shifts, 11]
    win_r = win_r.permute(0, 2, 1, 3)                  # [N, shift, row, col]
    diff = patch_l[:, None] - (win_r - center[:, None])
    sad = torch.sum(torch.abs(diff), dim=(2, 3))       # [N, 11]

    best_inc = torch.argmin(sad, dim=-1)
    best_sad = torch.amin(sad, dim=-1)
    interior = (best_inc > 0) & (best_inc < 2 * SAD_L)
    d_m1 = torch.gather(sad, 1, torch.clamp(best_inc - 1, 0, 2 * SAD_L
                                            )[:, None])[:, 0]
    d_p1 = torch.gather(sad, 1, torch.clamp(best_inc + 1, 0, 2 * SAD_L
                                            )[:, None])[:, 0]
    denom = torch.clamp(2.0 * (d_m1 + d_p1 - 2.0 * best_sad), min=1e-6)
    delta = (d_m1 - d_p1) / denom
    delta = torch.clamp(torch.where(interior, delta, torch.zeros_like(delta)),
                        -1.0, 1.0)

    scale_l = torch.pow(scale_factor, feats_l.level.to(torch.float32))
    u_right = scale_l * (suR0.to(torch.float32)
                         + (best_inc - SAD_L).to(torch.float32) + delta)
    disparity = uL - u_right
    disparity_c = torch.where(disparity <= 0.0,
                              torch.full_like(disparity, 0.01), disparity)
    u_right = torch.where(disparity <= 0.0, uL - 0.01, u_right)

    ok = (coarse_ok & interior & feats_l.valid
          & (disparity < max_disp) & (disparity >= -1.0))
    med = masked_median(best_sad, ok)
    ok = ok & (best_sad <= 2.1 * med)

    neg = torch.full_like(u_right, -1.0)
    return StereoMatches(u_right=torch.where(ok, u_right, neg),
                         depth=torch.where(ok, bf / disparity_c, neg))
