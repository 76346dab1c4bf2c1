"""Bundle adjustment: Levenberg-Marquardt on the Schur complement.

Port of ``orbslam2_tpu/ops/bundle.py`` (single device): batched
residuals/Jacobians and block normal equations by segment sums
(``index.scatter_add``, sorted on CUDA so that the sums do not change
from run to run, with the zero rows of invalid observations dropped —
not the JAX version's one-hot matmuls, which exist for the TPU's matrix
unit).  Two solvers for the reduced camera system:

  * ``"dense"`` (local BA): the camera-point coupling as [P, C, 6, 3],
    the Schur complement materialised, Jacobi-preconditioned and solved
    by FP32 Cholesky;
  * ``"cg"`` (global BA): matrix-free conjugate gradient.  The coupling
    stays per observation ([O, 6, 3]), each Schur product is two segment
    sums, the preconditioner is the exact 6×6 block diagonal, and the
    ``cg_iters`` steps read nothing back to the host.  No [P, C, …]
    object is built.

Landmarks are back-substituted.  Schedule: 5 robust (Huber) iterations,
outlier classification, 10 plain ones, final classification.  The JAX
``scan``/``cond`` pair becomes a Python loop: an accepted step
re-linearises, a rejected one keeps the carried system with a larger λ,
and the loop stops at the JAX ``done`` flag.  The mesh path
(``axis_name``) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orbslam2_tpu_torch.ops.pose_opt import CHI2_MONO, CHI2_STEREO
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie
from orbslam2_tpu_torch.utils.index import scatter_add


class BAProblem(NamedTuple):
    """Cameras [0, n_free) are optimized, the rest are fixed anchors."""

    poses: torch.Tensor        # [C_total, 4, 4] world→camera
    points: torch.Tensor       # [P, 3]
    point_valid: torch.Tensor  # [P] bool
    cam_i: torch.Tensor        # [O] int64 index into poses
    pt_i: torch.Tensor         # [O] int64 index into points
    uv: torch.Tensor           # [O, 2]
    ur: torch.Tensor           # [O] right coord, <0 ⇒ mono edge
    inv_sigma2: torch.Tensor   # [O]
    valid: torch.Tensor        # [O] bool


def _matvec(m, v):
    return torch.sum(m * v[..., None, :], dim=-1)


def _bmm(a, b):
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _outer_acc(a, b):
    """[..., r, i] × [..., r, j] → [..., i, j] summed over r (JᵀWJ)."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def _tmatvec(a, e):
    return torch.sum(a * e[..., None], dim=-2)


def _vecmat(v, m):
    """[..., k] × [..., k, j] → [..., j]  (= mᵀ v batched)."""
    return torch.sum(v[..., :, None] * m, dim=-2)


def _project_residuals(cam, poses, points, prob):
    T = poses[prob.cam_i]
    R = T[:, :3, :3]
    pc = _matvec(R, points[prob.pt_i]) + T[:, :3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    invz = 1.0 / torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.fx * x * invz + cam.cx
    v = cam.fy * y * invz + cam.cy
    is_stereo = prob.ur >= 0
    e = torch.stack([prob.uv[:, 0] - u, prob.uv[:, 1] - v,
                     torch.where(is_stereo, prob.ur - (u - cam.bf * invz),
                                 torch.zeros_like(u))], dim=-1)
    return e, is_stereo, z < 1e-6, pc, R, invz


def _residuals_jacobians(cam: cam_mod.Camera, poses, points,
                         prob: BAProblem):
    """e [O,3], J_cam [O,3,6], J_pt [O,3,3], is_stereo [O], behind [O]."""
    e, is_stereo, behind, pc, R, invz = _project_residuals(cam, poses,
                                                           points, prob)
    x, y = pc[:, 0], pc[:, 1]
    invz2 = invz * invz
    zero = torch.zeros_like(x)
    du_dp = torch.stack([cam.fx * invz, zero, -cam.fx * x * invz2], dim=-1)
    dv_dp = torch.stack([zero, cam.fy * invz, -cam.fy * y * invz2], dim=-1)
    dur_dp = du_dp + torch.stack([zero, zero, cam.bf * invz2], dim=-1)
    dproj = torch.stack([du_dp, dv_dp,
                         torch.where(is_stereo[:, None], dur_dp,
                                     torch.zeros_like(dur_dp))], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[0], 3, 3)
    dpc_dxi = torch.cat([-lie.hat(pc), eye], dim=-1)
    J_cam = -_bmm(dproj, dpc_dxi)
    J_pt = -_bmm(dproj, R)
    return e, J_cam, J_pt, is_stereo, behind


def _residuals_only(cam, poses, points, prob):
    e, is_stereo, behind, _, _, _ = _project_residuals(cam, poses, points,
                                                       prob)
    return e, is_stereo, behind


def _chi2_of(e, is_stereo, inv_sigma2):
    sq = torch.sum(e * e, dim=-1) * inv_sigma2
    return sq, torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int,
                 ok: torch.Tensor) -> torch.Tensor:
    """[O, ...] rows summed into [n, ...] by ``seg``, rows with ``ok``
    False dropped."""
    return scatter_add(vals.new_zeros((n,) + tuple(vals.shape[1:])), seg,
                       vals, ok)


LAM0 = 1e-4   # initial LM damping


def bundle_adjust(cam: cam_mod.Camera, prob: BAProblem, n_free: int,
                  iters_a: int = 5, iters_b: int = 10,
                  fix_first_free: bool = False, solver: str = "dense",
                  cg_iters: int = 48
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage LM schedule.  ``fix_first_free`` also freezes camera 0
    (the global-BA gauge).  ``solver`` is ``"dense"`` or ``"cg"`` (see
    the module docstring).  Returns (poses, points, obs_inlier)."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"bundle_adjust: unknown solver {solver!r}")
    C = n_free
    P = prob.points.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device
    pt_i = prob.pt_i
    # an invalid observation's rows carry weight 0: dropped from the sums
    cam_ok = prob.valid & (prob.cam_i < C)       # rows of free cameras

    def to_cams(vals):                           # [O, ...] → [C, ...]
        return _segment_sum(vals, prob.cam_i, C, cam_ok)

    def to_pts(vals):                            # [O, ...] → [P, ...]
        return _segment_sum(vals, pt_i, P, prob.valid)
    delta_m = torch.sqrt(torch.tensor(CHI2_MONO)).item()
    delta_s = torch.sqrt(torch.tensor(CHI2_STEREO)).item()

    def lm_solve(poses, points, obs_w, n_iters, use_huber):
        def rho_total(e, is_s):
            sq, _ = _chi2_of(e, is_s, prob.inv_sigma2)
            if use_huber:
                d = torch.where(is_s, delta_s, delta_m)
                r = torch.sqrt(torch.clamp(sq, min=1e-12))
                rho = torch.where(r <= d, sq, 2.0 * d * r - d * d)
            else:
                rho = sq
            return torch.sum(torch.where(obs_w > 0, rho,
                                         torch.zeros_like(rho)) * obs_w)

        def linearize(poses, points):
            e, Jc, Jp, is_s, behind = _residuals_jacobians(cam, poses,
                                                           points, prob)
            w = obs_w * prob.inv_sigma2 * (~behind).to(dtype)
            if use_huber:
                sq, _ = _chi2_of(e, is_s, prob.inv_sigma2)
                d = torch.where(is_s, delta_s, delta_m)
                r = torch.sqrt(torch.clamp(sq, min=1e-12))
                w = w * torch.where(r > d, d / r, 1.0)
            Jc_w = Jc * w[:, None, None]
            Jp_w = Jp * w[:, None, None]
            Hcc = to_cams(_outer_acc(Jc_w, Jc))
            g_c = to_cams(_tmatvec(Jc_w, e))
            Hpp = to_pts(_outer_acc(Jp_w, Jp))
            g_p = to_pts(_tmatvec(Jp_w, e))
            a_obs = _outer_acc(Jc_w, Jp)                       # [O, 6, 3]
            if solver == "dense":
                coup = _segment_sum(a_obs, pt_i * C + prob.cam_i, P * C,
                                    cam_ok).reshape(P, C, 6, 3)
            else:
                # per-observation blocks, masked to free cameras
                free_obs = prob.cam_i < C
                if fix_first_free:
                    free_obs = free_obs & (prob.cam_i != 0)
                coup = a_obs * free_obs[:, None, None].to(dtype)
            return (Hcc, Hpp, g_c, g_p, coup), rho_total(e, is_s)

        def solve(blocks, lam):
            Hcc, Hpp, g_c, g_p, coup = blocks
            eye3 = torch.eye(3, dtype=dtype, device=dev)
            eye6 = torch.eye(6, dtype=dtype, device=dev)
            Hpp_d = Hpp + (lam * _trace_mean(Hpp) + 1e-6) * eye3
            Hcc_d = Hcc + (lam * _trace_mean(Hcc) + 1e-6) * eye6
            if solver == "dense":
                return _schur_solve_dense(coup, Hcc_d, inv3x3(Hpp_d), g_c,
                                          g_p, C, P, fix_first_free)
            return _schur_solve_cg(coup, Hcc_d, inv3x3(Hpp_d), g_c, g_p,
                                   prob, C, to_cams, to_pts, fix_first_free,
                                   cg_iters)

        if n_iters == 0:      # a stage of length 0 (a GBA chunk's half)
            return poses, points
        blocks, cost = linearize(poses, points)
        lam = torch.tensor(LAM0, dtype=dtype, device=dev)
        for _ in range(n_iters):
            dc_blocks, dp = solve(blocks, lam)
            poses_t = poses.clone()
            poses_t[:C] = lie.se3_exp(dc_blocks) @ poses[:C]
            points_t = torch.where(prob.point_valid[:, None], points + dp,
                                   points)
            e_t, is_s, _ = _residuals_only(cam, poses_t, points_t, prob)
            cost_t = rho_total(e_t, is_s)
            accept = cost_t < cost
            gain = (cost - cost_t) / torch.clamp(cost, min=1e-9)
            done = (accept & (gain < 1e-5)) | (lam > 1e7)
            accept_h, done_h = torch.stack([accept, done]).tolist()
            if accept_h:
                poses, points = poses_t, points_t
                blocks, cost = linearize(poses, points)
                lam = lam * 0.5
            else:
                lam = lam * 4.0
            if done_h:
                break
        return poses, points

    def classify(poses, points):
        e, _, _, is_s, behind = _residuals_jacobians(cam, poses, points, prob)
        sq, th = _chi2_of(e, is_s, prob.inv_sigma2)
        return prob.valid & (sq <= th) & (~behind)

    poses, points = lm_solve(prob.poses, prob.points,
                             prob.valid.to(dtype), iters_a, use_huber=True)
    inlier = classify(poses, points)
    poses, points = lm_solve(poses, points, inlier.to(dtype), iters_b,
                             use_huber=False)
    return poses, points, classify(poses, points)


def _schur_solve_dense(Ucp, Hcc_d, Hpp_inv, g_c, g_p, C, P, fix_first_free):
    """Materialised Schur complement + Jacobi-preconditioned Cholesky.
    A failed factorisation yields NaN steps, which the LM test rejects
    (the JAX Cholesky returns NaN there too)."""
    dtype, dev = Hcc_d.dtype, Hcc_d.device
    U = Ucp.reshape(P, C * 6, 3)
    UHinv = _bmm(U, Hpp_inv)                                  # [P, 6C, 3]
    S = torch.block_diag(*Hcc_d) - torch.einsum("pik,pjk->ij", UHinv, U)
    r = g_c.reshape(C * 6) - torch.einsum("pik,pk->i", UHinv, g_p)
    if fix_first_free:
        m = torch.ones(C * 6, dtype=dtype, device=dev)
        m[:6] = 0.0
        S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        r = r * m
    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    S_pre = S * dscale[:, None] * dscale[None, :]
    L, info = torch.linalg.cholesky_ex(
        S_pre + 1e-7 * torch.eye(C * 6, dtype=dtype, device=dev))
    dc = torch.cholesky_solve((-r * dscale)[:, None], L)[:, 0] * dscale
    dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
    dc_blocks = dc.reshape(C, 6)
    Ut_dc = torch.sum(Ucp * dc_blocks[None, :, :, None], dim=(1, 2))
    dp = _matvec(Hpp_inv, -g_p - Ut_dc)
    return dc_blocks, dp


def _schur_solve_cg(a_obs, Hcc_d, Hpp_inv, g_c, g_p, prob: BAProblem, C,
                    to_cams, to_pts, fix_first_free, cg_iters):
    """Matrix-free PCG on the Schur complement (global-BA path).

    ``a_obs`` [O, 6, 3] holds each observation's coupling block
    a_o = Jc_oᵀ W_o Jp_o, zero for fixed cameras; S·x = Hcc·x − U Hpp⁻¹ Uᵀ x
    is a gather to points, a 3×3 solve and a scatter to cameras
    (``to_pts`` / ``to_cams``: the segment sums).  The preconditioner is
    the exact 6×6 block diagonal of S.  The loop runs
    ``cg_iters`` steps with no host read; ``torch.where`` guards the
    divisions as JAX's ``jnp.where`` does."""
    dtype, dev = Hcc_d.dtype, Hcc_d.device
    pt_i = prob.pt_i
    cam_g = torch.where(prob.cam_i < C, prob.cam_i, 0)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    tiny = torch.tensor(1e-20, dtype=dtype, device=dev)

    def schur_matvec(x):                                  # x: [C, 6]
        y = to_pts(_vecmat(x[cam_g], a_obs))                  # Uᵀ x
        z = _matvec(Hpp_inv, y)                               # Hpp⁻¹ Uᵀ x
        Sx = _matvec(Hcc_d, x) - to_cams(_matvec(a_obs, z[pt_i]))
        if fix_first_free:
            Sx = torch.cat([x[:1], Sx[1:]])
        return Sx

    # rhs = −(g_c − U Hpp⁻¹ g_p)
    zp = _matvec(Hpp_inv, g_p)
    rhs = -(g_c - to_cams(_matvec(a_obs, zp[pt_i])))
    diag_obs = _bmm(_bmm(a_obs, Hpp_inv[pt_i]), a_obs.transpose(-1, -2))
    diagS = Hcc_d - to_cams(diag_obs)
    if fix_first_free:
        rhs = torch.cat([torch.zeros_like(rhs[:1]), rhs[1:]])
        diagS = torch.cat([eye6[None], diagS[1:]])
    Minv = _inv6x6(diagS + 1e-6 * eye6)

    def guard(v):
        return torch.where(torch.abs(v) < 1e-20, tiny, v)

    x = torch.zeros_like(rhs)
    r = rhs
    z = _matvec(Minv, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = schur_matvec(p)
        alpha = rz / guard(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = _matvec(Minv, r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / guard(rz)) * p
        rz = rz_new

    # back-substitute landmarks through the same per-observation blocks
    Ut_dc = to_pts(_vecmat(x[cam_g], a_obs))
    dp = _matvec(Hpp_inv, -g_p - Ut_dc)
    return x, dp


def _inv6x6(A: torch.Tensor) -> torch.Tensor:
    """Batched 6×6 SPD inverse by 2×2 block inversion over 3×3 blocks
    (JAX's form: no LU, no host check)."""
    A11, A12 = A[..., :3, :3], A[..., :3, 3:]
    A21, A22 = A[..., 3:, :3], A[..., 3:, 3:]
    A11i = inv3x3(A11)
    A21_A11i = _bmm(A21, A11i)
    S22i = inv3x3(A22 - _bmm(A21_A11i, A12))
    B12 = -_bmm(_bmm(A11i, A12), S22i)
    B11 = A11i - _bmm(B12, A21_A11i)
    B21 = -_bmm(S22i, A21_A11i)
    return torch.cat([torch.cat([B11, B12], dim=-1),
                      torch.cat([B21, S22i], dim=-1)], dim=-2)


def _trace_mean(H: torch.Tensor) -> torch.Tensor:
    """[B, n, n] → [B, 1, 1] mean of the diagonal."""
    return (torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
            / H.shape[-1])[:, None, None]


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3×3 inverse (adjugate)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    adj = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                       torch.stack([A21, A22, A23], dim=-1),
                       torch.stack([A31, A32, A33], dim=-1)], dim=-2)
    return adj / det[..., None, None]
