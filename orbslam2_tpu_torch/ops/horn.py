"""Closed-form 3D-3D alignment (Horn 1987 / Kabsch), batched.

Port of ``orbslam2_tpu/ops/horn.py``: weighted centroids, the 3×3
cross-covariance, its SVD with the determinant sign fix.  A minimal set of
3 points has a rank-2 covariance, so its third singular vectors are
defined only up to sign; R = U·diag(1, 1, det(UVᵀ))·Vᵀ is unique all the
same, and so are s and t (U and V themselves are not, and differ between
LAPACK, cuSOLVER and XLA).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def align(src: torch.Tensor, dst: torch.Tensor,
          weights: Optional[torch.Tensor] = None, with_scale: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve dst ≈ s·R·src + t.  src/dst [..., N, 3], weights [..., N].
    Returns (s [...], R [..., 3, 3], t [..., 3])."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1e-9)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = torch.einsum("...ni,...nj,...n->...ij", xd, xs, w)
    # a non-finite covariance (a degenerate hypothesis) gives NaN, as in
    # JAX, where LAPACK's SVD on the CPU would raise instead
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    U, D, Vt = torch.linalg.svd(torch.where(finite[..., None, None], cov,
                                            0.0))
    det = torch.linalg.det(U @ Vt)
    S = torch.ones(cov.shape[:-2] + (3,), dtype=cov.dtype, device=cov.device)
    S = torch.cat([S[..., :2], det[..., None]], dim=-1)
    R = torch.where(finite[..., None, None], U @ (S[..., :, None] * Vt),
                    float("nan"))
    var_s = torch.einsum("...ni,...ni,...n->...", xs, xs, w)
    if with_scale:
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones_like(var_s)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return s, R, t


def apply(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
          pts: torch.Tensor) -> torch.Tensor:
    return (s[..., None, None] * torch.einsum("...ij,...nj->...ni", R, pts)
            + t[..., None, :])
