"""Monocular map bootstrap: parallel H/F RANSAC, model selection and
reconstruction.

Port of ``orbslam2_tpu/ops/initializer.py`` (``Initializer``,
src/Initializer.cc): 200 minimal sets of 8 matches; the homography by
normalized DLT and the fundamental matrix by the 8-point algorithm, each
solved for all 200 sets in one batched SVD; each model refit on its best
set's inliers; selection by RH = SH / (SH + SF) > 0.40; reconstruction by
a cheirality vote over the 4 (R, t) of E = KᵀFK and the 8 of the Faugeras
homography decomposition, all 12 triangulated at once.

Sampling draws from an explicit ``torch.Generator`` through
``sim3solver.sample_minimal_sets`` (uniform when no match is valid); ``idx``
[200, 8] may be given instead, which is how the tests replay JAX's draws.

Null vectors from SVD and ``eigh`` (the models, E's and H's
decompositions) are defined up to sign, and LAPACK, cuSOLVER and XLA may
return either; every score and the set of 12 hypotheses are invariant to
it, so only the winner is comparable between packages.  Nothing here
reads a value back to the host: inverses go through ``inv_ex``, and a
non-finite matrix reaches no decomposition (torch raises on the CPU where
JAX returns NaN), its factors read NaN instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from orbslam2_tpu_torch.ops.sim3solver import sample_minimal_sets
from orbslam2_tpu_torch.ops.triangulate import triangulate_dlt
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie

N_SETS = 200          # mMaxIterations (Initializer.cc:84)
TH_H = 5.991          # symmetric-transfer chi² gate (CheckHomography)
TH_F = 3.841          # epipolar chi² gate (CheckFundamental)
TH_SCORE = 5.991


class MonoInit(NamedTuple):
    ok: torch.Tensor        # bool
    Tcw2: torch.Tensor      # [4, 4] second-frame pose (first = identity)
    points: torch.Tensor    # [N, 3] triangulated points (per match row)
    good: torch.Tensor      # [N] triangulation validity
    used_h: torch.Tensor    # bool: which model reconstructed


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1).long())[0]


def _finite(A: torch.Tensor):
    """(A with non-finite matrices zeroed, [...] mask of finite ones)."""
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], A, 0.0), ok


def _svd(A: torch.Tensor, full_matrices: bool = False):
    """``torch.linalg.svd`` that gives NaN factors for a non-finite matrix,
    as JAX does, instead of raising."""
    A0, ok = _finite(A)
    U, D, Vt = torch.linalg.svd(A0, full_matrices=full_matrices)
    return (torch.where(ok[..., None, None], U, float("nan")),
            torch.where(ok[..., None], D, float("nan")),
            torch.where(ok[..., None, None], Vt, float("nan")))


def _null_vector_eigh(AtA: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the least eigenvalue of a symmetric 9×9 (NaN for
    a non-finite matrix)."""
    A0, ok = _finite(AtA)
    _, V = torch.linalg.eigh(A0)
    return torch.where(ok, V[:, 0], float("nan"))


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A).inverse


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Initializer::Normalize (:748): zero mean, unit mean absolute
    deviation, over the valid rows."""
    w = valid.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(pts - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (pts - mean) * s, T


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _h_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    return r1, r2


def _f_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        o], -1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, D, Vt = _svd(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return U @ (D[..., :, None] * Vt)


def _solve_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """[S, 8, 2] × 2 → [S, 3, 3] homographies by DLT (ComputeH21, :225)."""
    A = torch.cat(_h_rows(p1, p2), dim=-2)                  # [S, 16, 9]
    _, _, Vt = _svd(A, full_matrices=True)
    return Vt[..., -1, :].reshape(A.shape[0], 3, 3)


def _solve_f(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental with rank-2 projection (ComputeF21, :267).  A is
    [S, 8, 9]: its null vector is the 9th row of Vᵀ, which only the full
    decomposition returns."""
    A = _f_rows(p1, p2)
    _, _, Vt = _svd(A, full_matrices=True)
    return _rank2(Vt[..., -1, :].reshape(A.shape[0], 3, 3))


def _refit_h(p1, p2, w):
    """Weighted DLT over all inliers via the 9×9 normal matrix."""
    r1, r2 = _h_rows(p1, p2)
    wf = w.to(p1.dtype)
    AtA = (torch.einsum("ni,nj,n->ij", r1, r1, wf)
           + torch.einsum("ni,nj,n->ij", r2, r2, wf))
    return _null_vector_eigh(AtA).reshape(3, 3)


def _refit_f(p1, p2, w):
    a = _f_rows(p1, p2)
    AtA = torch.einsum("ni,nj,n->ij", a, a, w.to(p1.dtype))
    return _rank2(_null_vector_eigh(AtA).reshape(3, 3))


def _dehomog(q: torch.Tensor) -> torch.Tensor:
    z = q[..., 2:]
    return q[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)


def _score_h(H21, p1, p2, valid):
    """Symmetric transfer score (CheckHomography, :304), batched over the
    leading dimensions of H21."""
    H12 = _inv(H21)
    q2 = _dehomog(_homog(p1) @ H21.transpose(-1, -2))
    q1 = _dehomog(_homog(p2) @ H12.transpose(-1, -2))
    c2 = torch.sum((q2 - p2) ** 2, -1)
    c1 = torch.sum((q1 - p1) ** 2, -1)
    sc = (torch.where(c2 < TH_H, TH_SCORE - c2, 0.0)
          + torch.where(c1 < TH_H, TH_SCORE - c1, 0.0))
    inl = (c1 < TH_H) & (c2 < TH_H) & valid
    return torch.sum(sc * valid, -1), inl


def _score_f(F21, p1, p2, valid):
    """Epipolar-distance score (CheckFundamental, :389), batched."""
    l2 = _homog(p1) @ F21.transpose(-1, -2)          # lines in image 2
    num2 = torch.sum(l2 * _homog(p2), -1)
    d2 = num2 ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2,
                                 min=1e-12)
    l1 = _homog(p2) @ F21
    num1 = torch.sum(l1 * _homog(p1), -1)
    d1 = num1 ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2,
                                 min=1e-12)
    sc = (torch.where(d2 < TH_F, TH_SCORE - d2, 0.0)
          + torch.where(d1 < TH_F, TH_SCORE - d1, 0.0))
    inl = (d1 < TH_F) & (d2 < TH_F) & valid
    return torch.sum(sc * valid, -1), inl


def _check_rt(K, R, t, p1, p2, valid, sigma2_th=16.0):
    """Cheirality / parallax / reprojection vote (CheckRT, :797) for the
    hypotheses R [H, 3, 3], t [H, 3].  Returns (n_good [H], good [H, N],
    parallax in degrees [H], points [H, N, 3])."""
    P1 = K @ torch.eye(4, dtype=K.dtype, device=K.device)[:3, :]
    P2 = K @ lie.rt_to_mat(R, t)[:, :3, :]
    X = triangulate_dlt(P1, P2, p1, p2)                      # [H, N, 3]
    finite = torch.all(torch.isfinite(X), -1)
    z1 = X[..., 2]
    pc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = pc2[..., 2]
    # parallax between the two rays
    C2 = -torch.einsum("hji,hj->hi", R, t)
    r2 = X - C2[:, None, :]
    cosp = torch.sum(X * r2, -1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)
    e1 = torch.sum((_dehomog(X @ K.T) - p1) ** 2, -1)
    e2 = torch.sum((_dehomog(pc2 @ K.T) - p2) ** 2, -1)
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < sigma2_th) & (e2 < sigma2_th))
    # the ~50th-smallest parallax cosine of the good points (:857-866)
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0), dim=-1).values
    n_good = torch.sum(good.to(torch.int32), -1)
    idx = torch.clamp(torch.clamp(n_good - 1, min=0), max=50).long()
    cos_pick = torch.gather(cos_sorted, 1, idx[:, None])[:, 0]
    par = torch.arccos(torch.clamp(cos_pick, -1.0, 1.0)) * (180.0 / math.pi)
    return n_good, good, par, X


def _decompose_e(E):
    """DecomposeE (:908): 4 (R, t) candidates."""
    U, _, Vt = _svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H, K):
    """Faugeras SVD homography decomposition (ReconstructH, :571): 8
    motion hypotheses."""
    A = _inv(K) @ H @ K
    U, D, Vt = _svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    d2sq = d2 * d2
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2sq) / torch.clamp(
        d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2sq - d3 * d3) / torch.clamp(
        d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    dev = H.device
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev) * aux3
    # eps = sign(x1·x3), with JAX's 1e-30 nudge off zero
    eps = torch.sign(x1s * x3s + 1e-30)
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2sq) * (d2sq - d3 * d3),
                                  min=0.0))
    # case d' = +d2 (:619-652)
    sin_t = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2sq + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    st, ct = eps * sin_t, cos_t * one
    Rp_a = torch.stack([torch.stack([ct, zero, -st], -1),
                        torch.stack([zero, one, zero], -1),
                        torch.stack([st, zero, ct], -1)], -2)
    tp_a = torch.stack([x1s, zero, -x3s], -1) * (d1 - d3)
    # case d' = −d2 (:655-688)
    sin_p = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2sq) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sp, cp = eps * sin_p, cos_p * one
    Rp_b = torch.stack([torch.stack([cp, zero, sp], -1),
                        torch.stack([zero, -one, zero], -1),
                        torch.stack([sp, zero, -cp], -1)], -2)
    tp_b = torch.stack([x1s, zero, x3s], -1) * (d1 + d3)
    Rp = torch.cat([Rp_a, Rp_b])                             # [8, 3, 3]
    tp = torch.cat([tp_a, tp_b])                             # [8, 3]
    R = s * U @ Rp @ Vt
    t = tp @ U.T
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                        min=1e-12)
    return R, t


def initialize_mono(cam: cam_mod.Camera, p1: torch.Tensor, p2: torch.Tensor,
                    valid: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    min_triangulated: int = 50,
                    idx: Optional[torch.Tensor] = None) -> MonoInit:
    """Initializer::Initialize (:77-121) for matched keypoints p1/p2
    [N, 2] (undistorted) with ``valid`` [N]: the second frame's pose with
    the first at identity, the triangulated points and which model won.
    ``idx`` [200, 8] replaces the generator's draws."""
    dev = p1.device
    n1, T1 = _normalize(p1, valid)
    n2, T2 = _normalize(p2, valid)
    T2inv = _inv(T2)
    if idx is None:
        idx = sample_minimal_sets(valid, N_SETS, 8, generator)
    idx = idx.long().to(dev)

    H21 = T2inv @ _solve_h(n1[idx], n2[idx]) @ T1
    sh, ih = _score_h(H21, p1, p2, valid)
    # refit on the winning inlier set (one 9×9 eigensolve)
    H_best = T2inv @ _refit_h(n1, n2, _at(ih, torch.argmax(sh))) @ T1
    SH, _ = _score_h(H_best, p1, p2, valid)

    F21 = T2.T @ _solve_f(n1[idx], n2[idx]) @ T1
    sf, if_ = _score_f(F21, p1, p2, valid)
    F_best = T2.T @ _refit_f(n1, n2, _at(if_, torch.argmax(sf))) @ T1
    SF, _ = _score_f(F_best, p1, p2, valid)

    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40      # (:110-117)

    # F path: E = KᵀFK → 4 hypotheses; H path: 8; all 12 are voted on and
    # the selected model's mask decides
    K = cam.K(dev)
    Rf, tf = _decompose_e(K.T @ F_best @ K)
    Rh, th = _decompose_h(H_best, K)
    R_all = torch.cat([Rf, Rh])                              # [12, 3, 3]
    t_all = torch.cat([tf, th])
    is_h = torch.arange(12, device=dev) >= 4
    n_good, good, par, X = _check_rt(K, R_all, t_all, p1, p2, valid)
    model_mask = torch.where(use_h, is_h, ~is_h)
    n_eff = torch.where(model_mask, n_good, -1)
    best = torch.argmax(n_eff)
    n_best = _at(n_eff, best)
    # the runner-up must be clearly worse (ReconstructF:529)
    n_second = torch.sort(n_eff).values[-2]
    n_valid = torch.sum(valid.to(torch.int32))
    ok = ((n_best > min_triangulated)
          & (n_best.to(torch.float32) >= 0.5 * n_valid.to(torch.float32))
          & (n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
          & (_at(par, best) > 1.0))
    return MonoInit(ok=ok, Tcw2=lie.rt_to_mat(_at(R_all, best),
                                              _at(t_all, best)),
                    points=_at(X, best), good=_at(good, best), used_h=use_h)


def nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.nanmedian`` along ``dim``: the mean of the two middle finite
    values when their count is even (``torch.nanmedian`` returns the lower
    one), NaN when there is none."""
    s = torch.sort(x, dim=dim).values              # NaN sorts last
    n = torch.sum(~torch.isnan(x), dim=dim, keepdim=True).to(x.dtype)
    q = 0.5 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    low = torch.clamp(torch.minimum(low, n - 1.0), min=0.0).long()
    high = torch.clamp(torch.minimum(high, n - 1.0), min=0.0).long()
    return (torch.gather(s, dim, low) * w_low
            + torch.gather(s, dim, high) * w_high).squeeze(dim)
