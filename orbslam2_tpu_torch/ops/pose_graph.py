"""Sim(3) pose-graph optimization: the essential graph after a loop closure.

Port of ``orbslam2_tpu/ops/pose_graph.py`` (Optimizer::
OptimizeEssentialGraph): vertices are tangent perturbations x ∈ R^{K×7}
around base Sim3s, every edge's residual log(meas⁻¹ ∘ S_i ∘ S_j⁻¹) is
weighted by √w, and each Gauss-Newton step solves the normal equations by
a fixed number of conjugate-gradient iterations with fixed vertices and
the stereo fix-scale constraint projected in and out of the operator.

Where the JAX version applies JᵀJ matrix-free through ``jax.linearize``
and ``jax.vjp``, the port takes each edge's two 7×7 Jacobian blocks once
per step by forward-mode autodiff (``torch.func.jvp`` over the 14 tangent
directions): J·v is then a gather and a batched 7×7 product, Jᵀ·u two
segment sums (``index.scatter_add``, dead edges dropped).  It is the same linear map.  The residual is evaluated
batched over edges, never per edge: forward mode through a 0-dim tensor
times a Python float yields float64 tangents in torch 2.x.  Both loop
counts are fixed and nothing inside them is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orbslam2_tpu_torch.utils import lie
from orbslam2_tpu_torch.utils.index import scatter_add


class PoseGraphProblem(NamedTuple):
    # vertices: world→kf Sim3 as (s, R, t)
    s: torch.Tensor          # [K]
    R: torch.Tensor          # [K, 3, 3]
    t: torch.Tensor          # [K, 3]
    fixed: torch.Tensor      # [K] bool — loop KF anchor
    vertex_valid: torch.Tensor  # [K] bool
    # edges with relative measurement S_ij ≈ S_i ∘ S_j⁻¹
    e_i: torch.Tensor        # [E] int
    e_j: torch.Tensor        # [E] int
    m_s: torch.Tensor        # [E]
    m_R: torch.Tensor        # [E, 3, 3]
    m_t: torch.Tensor        # [E, 3]
    e_weight: torch.Tensor   # [E] float32 (0 = padding)


def _edge_residual(xi, xj, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """log(meas⁻¹ ∘ (exp(xi)∘S_i) ∘ (exp(xj)∘S_j)⁻¹), unweighted; any
    leading batch shape."""
    si, Ri, ti = lie.sim3_mul(*lie.sim3_exp(xi), si, Ri, ti)
    sj, Rj, tj = lie.sim3_mul(*lie.sim3_exp(xj), sj, Rj, tj)
    rs, rR, rt = lie.sim3_mul(si, Ri, ti, *lie.sim3_inv(sj, Rj, tj))
    es, eR, et = lie.sim3_mul(*lie.sim3_inv(ms, mR, mt), rs, rR, rt)
    return lie.sim3_log(es, eR, et)


def _edge_jacobians(zeros: torch.Tensor, *args):
    """Each edge's blocks (∂r/∂x_i, ∂r/∂x_j) [E, 7, 7] at x = 0: forward
    mode over the 14 tangent directions, every direction for all edges at
    once (the residual stays batched over edges)."""
    E = zeros.shape[0]
    basis = torch.eye(7, dtype=zeros.dtype, device=zeros.device)
    basis = basis[:, None, :].expand(7, E, 7)
    none = torch.zeros_like(basis)
    t_i = torch.cat([basis, none])                      # [14, E, 7]
    t_j = torch.cat([none, basis])

    def directional(ti, tj):
        return torch.func.jvp(lambda a, b: _edge_residual(a, b, *args),
                              (zeros, zeros), (ti, tj))[1]

    d = torch.func.vmap(directional)(t_i, t_j)          # [14, E, 7]
    return d[:7].permute(1, 2, 0), d[7:].permute(1, 2, 0)


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        cg_iters: int = 64, fix_scale: bool = True,
                        damping: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns optimized (s, R, t) per vertex."""
    K = prob.s.shape[0]
    E = prob.e_i.shape[0]
    dev, dtype = prob.R.device, prob.R.dtype
    e_i, e_j = prob.e_i.long(), prob.e_j.long()
    mask = (prob.vertex_valid & ~prob.fixed).to(dtype)[:, None].repeat(1, 7)
    if fix_scale:
        mask[:, 6] = 0.0
    w = torch.clamp(prob.e_weight, min=0.0)
    sw = torch.sqrt(w)[:, None]
    live = (w > 0)[:, None]
    zeros = torch.zeros((E, 7), dtype=dtype, device=dev)

    def JT(u_i, u_j):       # dead edges' rows are zero: dropped
        out = torch.zeros((K, 7), dtype=dtype, device=dev)
        return scatter_add(scatter_add(out, e_i, u_i, live[:, 0]), e_j, u_j,
                           live[:, 0])

    s, R, t = prob.s, prob.R, prob.t
    for _ in range(n_iters):
        args = (s[e_i], R[e_i], t[e_i], s[e_j], R[e_j], t[e_j],
                prob.m_s, prob.m_R, prob.m_t)
        r0 = torch.where(live, _edge_residual(zeros, zeros, *args) * sw, 0.0)
        Ji, Jj = _edge_jacobians(zeros, *args)                 # [E, 7, 7]
        Ji = torch.where(live[:, :, None], Ji * sw[:, :, None], 0.0)
        Jj = torch.where(live[:, :, None], Jj * sw[:, :, None], 0.0)
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)

        def A(v):   # (JᵀJ + λI) v with the freeze mask in and out
            v = v * mask
            jv = (torch.bmm(Ji, v[e_i][:, :, None])
                  + torch.bmm(Jj, v[e_j][:, :, None]))
            out = JT(torch.bmm(JiT, jv)[:, :, 0], torch.bmm(JjT, jv)[:, :, 0])
            return out * mask + damping * v

        b = -JT(torch.bmm(JiT, r0[:, :, None])[:, :, 0],
                torch.bmm(JjT, r0[:, :, None])[:, :, 0]) * mask
        x = torch.zeros_like(b)
        r, p = b, b
        rs_old = torch.sum(b * b)
        for _ in range(cg_iters):
            Ap = A(p)
            alpha = rs_old / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = torch.sum(r * r)
            p = r + (rs_new / torch.clamp(rs_old, min=1e-20)) * p
            rs_old = rs_new
        s, R, t = lie.sim3_mul(*lie.sim3_exp(x * mask), s, R, t)
    return s, R, t


def sim3_from_se3(T: torch.Tensor):
    """[..., 4, 4] SE3 → (s=1, R, t)."""
    R, t = lie.mat_to_rt(T)
    return torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device), R, t


def se3_from_sim3(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                  ) -> torch.Tensor:
    """Sim3 → SE3 with translation divided by scale (Optimizer.cc:1046)."""
    return lie.rt_to_mat(R, t / s[..., None])


def correct_points(mp_pos: torch.Tensor, ref_old_s, ref_old_R, ref_old_t,
                   ref_new_s, ref_new_R, ref_new_t) -> torch.Tensor:
    """Map-point correction through the reference KF (Optimizer.cc:1057):
    p' = S_new⁻¹(S_old(p)), batched per point."""
    pc = lie.sim3_apply(ref_old_s, ref_old_R, ref_old_t, mp_pos[..., None, :])
    inv = lie.sim3_inv(ref_new_s, ref_new_R, ref_new_t)
    return lie.sim3_apply(*inv, pc)[..., 0, :]
