"""RANSAC Sim(3)/SE(3) between two keyframes' matched 3D points.

Port of ``orbslam2_tpu/ops/sim3solver.py``: all hypotheses' minimal sets
of 3 correspondences are solved in one batched Horn alignment, inliers by
symmetric reprojection, the winner re-solved on its inlier set.

Sampling draws from an explicit ``torch.Generator``; ``idx`` [H, 3] may be
given instead, which is how the tests replay JAX's hypotheses.  When no
correspondence is valid the weights are uniform, on the device:
``torch.multinomial`` rejects an all-zero weight vector (an error on the
CPU, a device assert on CUDA), where JAX samples anyway and returns
``ok=False`` — as the port then does, since no hypothesis has inliers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orbslam2_tpu_torch.ops import horn
from orbslam2_tpu_torch.utils import camera as cam_mod


class Sim3Result(NamedTuple):
    s12: torch.Tensor       # scale
    R12: torch.Tensor       # [3, 3]
    t12: torch.Tensor       # [3]
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def sample_minimal_sets(valid: torch.Tensor, n_hypotheses: int, size: int,
                        generator: Optional[torch.Generator]
                        ) -> torch.Tensor:
    """[H, size] indices drawn with replacement, uniformly over the valid
    entries (over all entries when none is valid)."""
    p = valid.to(torch.float32)
    p = torch.where(torch.sum(p) > 0, p, torch.ones_like(p))
    return torch.multinomial(p, n_hypotheses * size, replacement=True,
                             generator=generator).reshape(n_hypotheses, size)


def sim3_ransac(cam: cam_mod.Camera, pts1_c: torch.Tensor,
                pts2_c: torch.Tensor, valid: torch.Tensor,
                generator: Optional[torch.Generator], fix_scale: bool,
                n_hypotheses: int = 128, th2_1: float = 9.210,
                th2_2: float = 9.210, min_inliers: int = 20,
                idx: Optional[torch.Tensor] = None) -> Sim3Result:
    """Find S12 with X1 ≈ s·R·X2 + t.  Inliers by symmetric reprojection
    (CheckInliers, Sim3Solver.cc:341)."""
    if idx is None:
        idx = sample_minimal_sets(valid, n_hypotheses, 3, generator)
    idx = idx.long()
    H = idx.shape[0]
    s, R, t = horn.align(pts2_c[idx], pts1_c[idx], with_scale=not fix_scale)

    X2_in1 = horn.apply(s, R, t, pts2_c[None].expand(H, -1, -1))
    s_inv = 1.0 / s
    R_inv = R.transpose(-1, -2)
    t_inv = -s_inv[:, None] * torch.einsum("hij,hj->hi", R_inv, t)
    X1_in2 = horn.apply(s_inv, R_inv, t_inv, pts1_c[None].expand(H, -1, -1))
    e1 = torch.sum((cam_mod.project(cam, X2_in1)
                    - cam_mod.project(cam, pts1_c)[None]) ** 2, dim=-1)
    e2 = torch.sum((cam_mod.project(cam, X1_in2)
                    - cam_mod.project(cam, pts2_c)[None]) ** 2, dim=-1)
    inl = ((e1 < th2_1) & (e2 < th2_2) & (X2_in1[..., 2] > 0)
           & (X1_in2[..., 2] > 0) & valid[None])
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts)

    w = inl[best].to(torch.float32)
    s_r, R_r, t_r = horn.align(pts2_c[None], pts1_c[None], w[None],
                               with_scale=not fix_scale)
    return Sim3Result(s12=s_r[0], R12=R_r[0], t12=t_r[0], inliers=inl[best],
                      n_inliers=counts[best],
                      ok=counts[best] >= min_inliers)
