"""Sim3 guided matching + bidirectional Sim3 refinement for loop closing.

Port of ``orbslam2_tpu/ops/sim3opt.py``:

  * ``search_by_sim3`` (ORBmatcher::SearchBySim3) — each keyframe's map
    points projected through the candidate Sim3 into the other image,
    window/level-gated dense Hamming matching, two-way agreement only;
  * ``optimize_sim3`` (Optimizer::OptimizeSim3) — LM on one Sim3 with
    bidirectional reprojection edges, Huber √10, an outlier pass at
    χ² > 10 in either direction, re-optimization, inlier count.

The tangent is the left-composed chart S ← (e^σ, exp(ω), υ) ∘ S; its
Jacobian is forward-mode autodiff of the residual (``torch.func.jacfwd``),
as the JAX version takes ``jax.jacfwd``.  The LM scans have fixed
lengths and carry accept/reject with ``torch.where``: no host read.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orbslam2_tpu_torch.ops import hamming, matching
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie

TH2_SIM3 = 10.0   # chi² threshold (Optimizer.cc deltaHuber² = th2 = 10)


def _project(cam, p):
    z = torch.where(torch.abs(p[..., 2]) < 1e-9,
                    torch.full_like(p[..., 2], 1e-9), p[..., 2])
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx,
                        cam.fy * p[..., 1] / z + cam.cy], dim=-1)


def search_by_sim3(cam: cam_mod.Camera,
                   xy1, level1, desc1, valid1, mp1_pos_c1, mp1_ok,
                   xy2, level2, desc2, valid2, mp2_pos_c2, mp2_ok,
                   min_dist1, max_dist1, min_dist2, max_dist2,
                   s12, R12, t12, scale_factor: float, n_levels: int,
                   th: float = 7.5, width: float = 640.0,
                   height: float = 480.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-way Sim3-guided matching between two keyframes' map points.
    Returns (match12 [N1] feature1 → feature2 or −1, n_matches)."""
    s21, R21, t21 = lie.sim3_inv(s12, R12, t12)

    def one_direction(pos_src_c, src_ok, desc_src, dmin, dmax,
                      s, R, t, xy_t, lvl_t, desc_t, val_t):
        p_t = s * (pos_src_c @ R.T) + t                      # [N, 3]
        z_ok = p_t[:, 2] > 0
        uv = _project(cam, p_t)
        in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < width)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < height))
        dist = torch.linalg.vector_norm(p_t, dim=-1)
        band_ok = (dist >= dmin) & (dist <= dmax)
        pred = matching.predict_scale(dist, dmax, scale_factor, n_levels)
        radius = th * torch.pow(scale_factor, pred.to(torch.float32))
        du = torch.abs(uv[:, 0:1] - xy_t[None, :, 0])
        dv = torch.abs(uv[:, 1:2] - xy_t[None, :, 1])
        in_win = (du < radius[:, None]) & (dv < radius[:, None])
        lvl = lvl_t.long()[None, :]
        lvl_ok = (lvl >= pred[:, None] - 1) & (lvl <= pred[:, None])
        gate = (in_win & lvl_ok & val_t[None, :]
                & (src_ok & z_ok & in_img & band_ok)[:, None])
        d = hamming.hamming_matrix(desc_src, desc_t)
        d = torch.where(gate, d, torch.full_like(d, hamming.MAX_DIST))
        best = torch.amin(d, dim=1)
        best_idx = torch.argmin(d, dim=1)
        return torch.where(best <= matching.TH_HIGH, best_idx, -1)

    m12 = one_direction(mp1_pos_c1, mp1_ok & valid1, desc1,
                        min_dist1, max_dist1, s21, R21, t21,
                        xy2, level2, desc2, valid2 & mp2_ok)
    m21 = one_direction(mp2_pos_c2, mp2_ok & valid2, desc2,
                        min_dist2, max_dist2, s12, R12, t12,
                        xy1, level1, desc1, valid1 & mp1_ok)
    N1 = m12.shape[0]
    j_safe = torch.where(m12 >= 0, m12, 0)
    agree = (m12 >= 0) & (m21[j_safe] == torch.arange(N1, device=m12.device))
    return (torch.where(agree, m12, -1),
            torch.sum(agree.to(torch.int32)))


class Sim3OptResult(NamedTuple):
    s12: torch.Tensor
    R12: torch.Tensor
    t12: torch.Tensor
    inlier: torch.Tensor     # [N] bool (both directions pass)
    n_inliers: torch.Tensor


def optimize_sim3(cam: cam_mod.Camera, p1c: torch.Tensor, p2c: torch.Tensor,
                  uv1: torch.Tensor, uv2: torch.Tensor,
                  inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
                  valid: torch.Tensor, s0, R0, t0, fix_scale: bool,
                  th2: float = TH2_SIM3, iters_a: int = 5,
                  iters_b: int = 10) -> Sim3OptResult:
    """Bidirectional Sim3 LM refinement (Optimizer::OptimizeSim3)."""
    dev = p1c.device
    delta_huber = torch.sqrt(torch.tensor(th2, dtype=torch.float32)).item()
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    zero7 = torch.zeros((1, 7), dtype=torch.float32, device=dev)

    def residuals(dx, s, R, t):
        """dx [1, 7] (a batch of one: forward mode through 0-dim tensors
        times Python floats gives float64 tangents in torch 2.x)."""
        s_, R_, t_ = lie.sim3_mul(torch.exp(dx[:, 6]),
                                  lie.so3_exp(dx[:, 0:3]), dx[:, 3:6],
                                  s.reshape(1), R[None], t[None])
        si, Ri, ti = lie.sim3_inv(s_, R_, t_)
        pred1 = _project(cam, s_[:, None] * (p2c @ R_[0].T) + t_)  # → im1
        pred2 = _project(cam, si[:, None] * (p1c @ Ri[0].T) + ti)  # → im2
        return torch.cat([uv1 - pred1, uv2 - pred2], dim=-1)  # [N, 4]

    def jac(dx, s, R, t):                                   # [N, 4, 7]
        J = torch.func.jacfwd(residuals, argnums=0)(dx, s, R, t)
        return J.reshape(J.shape[0], 4, 7)

    def chi2_of(e):
        c1 = torch.sum(e[:, 0:2] ** 2, dim=-1) * inv_sigma2_1
        c2 = torch.sum(e[:, 2:4] ** 2, dim=-1) * inv_sigma2_2
        return c1, c2

    def rho(c):
        sq = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(sq > delta_huber, 2.0 * delta_huber * sq - th2, c)

    def huber_w(c, inv_s2):
        sq = torch.sqrt(torch.clamp(c, min=1e-12))
        return inv_s2 * torch.where(sq > delta_huber, delta_huber / sq, 1.0)

    def lm(s, R, t, inlier, n_iters):
        m = inlier.to(torch.float32)

        def normal_eq(s, R, t):
            e = residuals(zero7, s, R, t)
            J = jac(zero7, s, R, t)                           # [N, 4, 7]
            c1, c2 = chi2_of(e)
            w1 = huber_w(c1, inv_sigma2_1) * m
            w2 = huber_w(c2, inv_sigma2_2) * m
            Jw = J * torch.stack([w1, w1, w2, w2], dim=-1)[:, :, None]
            H = torch.einsum("nij,nik->jk", Jw, J)
            b = torch.einsum("nij,ni->j", Jw, e)
            cost = torch.sum(torch.where(inlier, rho(c1) + rho(c2),
                                         torch.zeros_like(c1)))
            return H, b, cost

        H, b, cost = normal_eq(s, R, t)
        lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            # solve_ex: a singular system gives a non-finite step that the
            # accept test rejects, as jnp.linalg.solve does
            dx = -torch.linalg.solve_ex(H + lam * eye7, b)[0]
            if fix_scale:
                dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
            s_c, R_c, t_c = lie.sim3_mul(torch.exp(dx[6]),
                                         lie.so3_exp(dx[0:3]), dx[3:6],
                                         s, R, t)
            H_c, b_c, cost_c = normal_eq(s_c, R_c, t_c)
            acc = cost_c < cost
            s = torch.where(acc, s_c, s)
            R = torch.where(acc, R_c, R)
            t = torch.where(acc, t_c, t)
            H = torch.where(acc, H_c, H)
            b = torch.where(acc, b_c, b)
            cost = torch.where(acc, cost_c, cost)
            lam = torch.where(acc, lam * 0.5, lam * 4.0)
        return s, R, t

    def classify(s, R, t):
        c1, c2 = chi2_of(residuals(zero7, s, R, t))
        return valid & (c1 <= th2) & (c2 <= th2)

    s = torch.as_tensor(s0, dtype=torch.float32, device=dev)
    R = R0.to(torch.float32)
    t = t0.to(torch.float32)
    s, R, t = lm(s, R, t, valid, iters_a)
    s, R, t = lm(s, R, t, classify(s, R, t), iters_b)
    inlier = classify(s, R, t)
    return Sim3OptResult(s12=s, R12=R, t12=t, inlier=inlier,
                         n_inliers=torch.sum(inlier.to(torch.int32)))
