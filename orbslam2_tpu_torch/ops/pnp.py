"""EPnP + RANSAC for relocalization, batched over hypotheses.

Port of ``orbslam2_tpu/ops/pnp.py`` (PnPsolver): Lepetit's EPnP — 4
control points by PCA, barycentric coordinates, the 12×12 MᵀM null space,
the β cases N = 1/2/3 from the 6-pair distance system, 5 Gauss-Newton
steps on β, R|t by 3D-3D alignment — with every RANSAC hypothesis solved
in one batch (the JAX ``vmap`` is a leading batch dimension here), 4-point
minimal sets, and the winner re-solved on its inlier set.

``torch.linalg.eigh`` and ``jnp.linalg.eigh`` may return eigenvectors of
opposite sign, so the control points and null-space vectors differ
between the two; the pose they give does not.  A non-finite matrix (a
degenerate hypothesis or inlier set) gives NaN eigenvectors, as in JAX,
where ``torch.linalg.eigh`` would raise.  Minimal sets come from an
explicit ``torch.Generator`` or are given as ``idx`` [H, 4].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orbslam2_tpu_torch.ops import horn
from orbslam2_tpu_torch.ops.sim3solver import sample_minimal_sets
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie

MIN_SET = 4       # reference minimal set (PnPsolver.cc:122)
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _solve_psd(A, b, eps=1e-9):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A + eps * eye, b[..., None])[0][..., 0]


def _eigh(A: torch.Tensor):
    """``torch.linalg.eigh`` that gives NaN for a non-finite matrix."""
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    ev, V = torch.linalg.eigh(torch.where(ok[..., None, None], A, 0.0))
    return (torch.where(ok[..., None], ev, float("nan")),
            torch.where(ok[..., None, None], V, float("nan")))


def _epnp_solve(Xw: torch.Tensor, xy_norm: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EPnP over a batch: Xw [..., S, 3] world points, xy_norm [..., S, 2]
    normalised image coords, w [..., S] weights (zero rows ignored).
    Returns Tcw [..., 4, 4]."""
    dtype, dev = Xw.dtype, Xw.device
    S = Xw.shape[-2]
    if w is None:
        w = torch.ones(Xw.shape[:-1], dtype=dtype, device=dev)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)

    # control points: weighted centroid + principal axes
    mu = torch.sum(Xw * wn[..., None], dim=-2)                  # [..., 3]
    Xc = Xw - mu[..., None, :]
    cov = torch.einsum("...si,...sj,...s->...ij", Xc, Xc, wn)
    ev, V = _eigh(cov)                                          # ascending
    scale = torch.sqrt(torch.clamp(ev, min=1e-9))
    axes = V.transpose(-1, -2) * scale[..., None]
    ctrl = torch.cat([mu[..., None, :], mu[..., None, :] + axes],
                     dim=-2)                                    # [..., 4, 3]

    # barycentric coordinates: X = alpha · ctrl
    ones4 = torch.ones(ctrl.shape[:-2] + (1, 4), dtype=dtype, device=dev)
    CT = torch.cat([ctrl.transpose(-1, -2), ones4], dim=-2)     # [..., 4, 4]
    onesS = torch.ones(Xw.shape[:-2] + (1, S), dtype=dtype, device=dev)
    Xh = torch.cat([Xw.transpose(-1, -2), onesS], dim=-2)       # [..., 4, S]
    alpha = torch.linalg.solve_ex(CT, Xh)[0].transpose(-1, -2)  # [..., S, 4]

    # M (rows scaled by √w so MᵀM is the weighted form)
    u, v = xy_norm[..., 0:1], xy_norm[..., 1:2]
    zeros = torch.zeros_like(alpha)
    row_u = torch.stack([alpha, zeros, -alpha * u], dim=-1)  # [.., S, 4, 3]
    row_v = torch.stack([zeros, alpha, -alpha * v], dim=-1)
    sw = torch.sqrt(w)[..., None]
    Mm = torch.cat([row_u.reshape(row_u.shape[:-2] + (12,)) * sw,
                    row_v.reshape(row_v.shape[:-2] + (12,)) * sw], dim=-2)
    MtM = Mm.transpose(-1, -2) @ Mm
    _, VV = _eigh(MtM)
    vk = VV[..., :, :4].transpose(-1, -2).reshape(
        VV.shape[:-2] + (4, 4, 3))                           # [.., 4, 4, 3]

    pi = torch.tensor([p[0] for p in _PAIRS], device=dev)
    pj = torch.tensor([p[1] for p in _PAIRS], device=dev)
    dv = vk[..., :, pi, :] - vk[..., :, pj, :]               # [.., 4, 6, 3]
    dw_pairs = ctrl[..., pi, :] - ctrl[..., pj, :]              # [..., 6, 3]
    rho = torch.sum(dw_pairs * dw_pairs, dim=-1)                # [..., 6]
    G = torch.einsum("...kpi,...lpi->...pkl", dv, dv)        # [.., 6, 4, 4]

    g00, g01, g11 = G[..., 0, 0], G[..., 0, 1], G[..., 1, 1]
    g02, g12 = G[..., 0, 2], G[..., 1, 2]
    z = torch.zeros_like(rho[..., 0])
    # N=1
    b1 = torch.sqrt(torch.clamp(torch.sum(rho, -1) / torch.clamp(
        torch.sum(g00, -1), min=1e-12), min=0.0))
    init1 = torch.stack([b1, z, z, z], dim=-1)
    # N=2: lstsq for (β₁², β₁β₂, β₂²)
    A2 = torch.stack([g00, 2.0 * g01, g11], dim=-1)             # [..., 6, 3]
    A2t = A2.transpose(-1, -2)
    x2 = _solve_psd(A2t @ A2, (A2t @ rho[..., None])[..., 0])
    b2a = torch.sqrt(torch.abs(x2[..., 0]))
    b2b = (torch.sqrt(torch.abs(x2[..., 2])) * torch.sign(x2[..., 1])
           * torch.sign(x2[..., 0]))
    init2 = torch.stack([b2a, b2b, z, z], dim=-1)
    # N=3: lstsq for (β₁², β₁β₂, β₂², β₁β₃, β₂β₃)
    A3 = torch.stack([g00, 2.0 * g01, g11, 2.0 * g02, 2.0 * g12], dim=-1)
    A3t = A3.transpose(-1, -2)
    x3 = _solve_psd(A3t @ A3, (A3t @ rho[..., None])[..., 0])
    b3a = torch.sqrt(torch.abs(x3[..., 0]))
    b3b = (torch.sqrt(torch.abs(x3[..., 2])) * torch.sign(x3[..., 1])
           * torch.sign(x3[..., 0]))
    b3c = x3[..., 3] / torch.where(torch.abs(b3a) < 1e-12,
                                   torch.full_like(b3a, 1e-12), b3a)
    init3 = torch.stack([b3a, b3b, b3c, z], dim=-1)

    # Gauss-Newton on the full β vector, the three cases at once
    b = torch.stack([init1, init2, init3], dim=-2)              # [..., 3, 4]
    G3 = G[..., None, :, :, :]                            # [.., 1, 6, 4, 4]
    rho3 = rho[..., None, :]
    for _ in range(5):
        Gb = (G3 @ b[..., None, :, None])[..., 0]            # [.., 3, 6, 4]
        e = torch.sum(Gb * b[..., None, :], dim=-1) - rho3      # [..., 3, 6]
        J = 2.0 * Gb
        Jt = J.transpose(-1, -2)
        b = b - _solve_psd(Jt @ J, (Jt @ e[..., None])[..., 0])

    # pose of each case, then the lowest reprojection error
    ctrl_cam = torch.einsum("...ck,...kij->...cij", b, vk)     # [..., 3, 4, 3]
    Xcam = alpha[..., None, :, :] @ ctrl_cam                 # [.., 3, S, 3]
    wn3 = wn[..., None, :]
    sign = torch.where(torch.sum(Xcam[..., 2] * wn3, -1) < 0, -1.0, 1.0)
    Xcam = Xcam * sign[..., None, None]
    Xw3 = Xw[..., None, :, :].expand(Xcam.shape)
    _, R, t = horn.align(Xw3, Xcam, weights=w[..., None, :].expand(
        Xcam.shape[:-1]), with_scale=False)
    pc = Xw3 @ R.transpose(-1, -2) + t[..., None, :]
    zc = torch.where(pc[..., 2] < 1e-6, torch.full_like(pc[..., 2], 1e-6),
                     pc[..., 2])
    proj = pc[..., :2] / zc[..., None]
    err = torch.sum(torch.sum((proj - xy_norm[..., None, :, :]) ** 2, -1)
                    * wn3, -1)
    err = err + 1e3 * torch.sum((pc[..., 2] <= 0).to(dtype) * wn3, -1)
    best = torch.argmin(err, dim=-1)                            # [...]
    Ts = lie.rt_to_mat(R, t)                                 # [.., 3, 4, 4]
    return torch.gather(Ts, -3, best[..., None, None, None].expand(
        best.shape + (1, 4, 4)))[..., 0, :, :]


class PnPResult(NamedTuple):
    Tcw: torch.Tensor        # [4, 4] best hypothesis pose
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # int32
    ok: torch.Tensor         # bool — enough inliers found


def pnp_ransac(cam: cam_mod.Camera, pts_w: torch.Tensor, uv: torch.Tensor,
               level_sigma2: torch.Tensor, valid: torch.Tensor,
               generator: Optional[torch.Generator],
               n_hypotheses: int = 64, chi2_th: float = 5.991,
               min_inliers: int = 10,
               idx: Optional[torch.Tensor] = None) -> PnPResult:
    """Batched RANSAC (PnPsolver::iterate): all hypotheses from 4-point
    minimal sets at once, inliers by the per-level χ² reprojection gate,
    the winner re-solved on its inlier set (Refine) and kept when it
    scores at least as many inliers."""
    xy_norm = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                           (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    if idx is None:
        idx = sample_minimal_sets(valid, n_hypotheses, MIN_SET, generator)
    idx = idx.long()
    Ts = _epnp_solve(pts_w[idx], xy_norm[idx])                  # [H, 4, 4]

    def score(T):   # T [..., 4, 4] → inliers [..., N]
        pc = (torch.einsum("...ij,nj->...ni", T[..., :3, :3], pts_w)
              + T[..., None, :3, 3])
        err2 = torch.sum((cam_mod.project(cam, pc) - uv) ** 2, -1) \
            / level_sigma2
        return (err2 < chi2_th) & (pc[..., 2] > 0) & valid

    inl = score(Ts)                                              # [H, N]
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts)
    ok0 = counts[best] >= min_inliers

    T_ref = _epnp_solve(pts_w, xy_norm, inl[best].to(pts_w.dtype))
    inl_ref = score(T_ref)
    n_ref = torch.sum(inl_ref.to(torch.int32))
    take = n_ref >= counts[best]
    n_fin = torch.where(take, n_ref, counts[best])
    return PnPResult(Tcw=torch.where(take, T_ref, Ts[best]),
                     inliers=torch.where(take, inl_ref, inl[best]),
                     n_inliers=n_fin, ok=ok0 | (n_fin >= min_inliers))
