"""Motion-only pose optimization: Levenberg-Marquardt on one SE3 pose.

Port of ``orbslam2_tpu/ops/pose_opt.py`` (Optimizer::PoseOptimization):
4 rounds × up to 10 LM iterations with rollback on rejected steps, the
Huber kernel in rounds 0-1, chi² inlier reclassification between rounds.
The JAX ``scan`` with a ``done`` flag becomes a Python loop that stops
at ``done`` — the JAX iterations after it are no-ops, so the result is
the same.  Each stop test reads one flag back from the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orbslam2_tpu_torch.config import OptimizerConfig
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
N_ROUNDS = 4           # Optimizer.cc:411 its[4] = {10, 10, 10, 10}
ITERS_PER_ROUND = 10


class PoseObs(NamedTuple):
    pts_w: torch.Tensor       # [N, 3] world landmark positions (fixed)
    uv: torch.Tensor          # [N, 2] undistorted measurements
    ur: torch.Tensor          # [N] right coord (<0 ⇒ monocular edge)
    inv_sigma2: torch.Tensor  # [N]
    valid: torch.Tensor       # [N] bool


def _residuals_jac(cam: cam_mod.Camera, Tcw: torch.Tensor, obs: PoseObs):
    """Residuals [N, 3] and Jacobians [N, 3, 6] (tangent [ω, υ], left
    convention T ← exp(ξ)·T); the third row is the stereo edge."""
    R, t = lie.mat_to_rt(Tcw)
    pc = torch.sum(obs.pts_w[:, None, :] * R[None, :, :], dim=-1) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    invz = 1.0 / z_safe
    invz2 = invz * invz
    u = cam.fx * x * invz + cam.cx
    v = cam.fy * y * invz + cam.cy
    ur_pred = u - cam.bf * invz
    is_stereo = obs.ur >= 0
    zero = torch.zeros_like(x)
    e = torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                     torch.where(is_stereo, obs.ur - ur_pred, zero)], dim=-1)
    du_dp = torch.stack([cam.fx * invz, zero, -cam.fx * x * invz2], dim=-1)
    dv_dp = torch.stack([zero, cam.fy * invz, -cam.fy * y * invz2], dim=-1)
    dur_dp = du_dp + torch.stack([zero, zero, cam.bf * invz2], dim=-1)
    dproj = torch.stack([du_dp, dv_dp,
                         torch.where(is_stereo[:, None], dur_dp,
                                     torch.zeros_like(dur_dp))], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[0], 3, 3)
    dpc = torch.cat([-lie.hat(pc), eye], dim=-1)                 # [N, 3, 6]
    J = -torch.sum(dproj[:, :, :, None] * dpc[:, None, :, :], dim=-2)
    return e, J, is_stereo, z < 1e-6


def _chi2(e, is_stereo, inv_sigma2):
    sq = torch.sum(e * e, dim=-1) * inv_sigma2
    th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    return sq, th


def pose_optimization(cam: cam_mod.Camera, Tcw0: torch.Tensor, obs: PoseObs,
                      opt_cfg: OptimizerConfig = OptimizerConfig()
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (Tcw [4, 4], inlier mask [N], n_inliers)."""
    # float32 square roots, as jnp.sqrt takes them
    delta_mono = torch.sqrt(torch.tensor(CHI2_MONO)).item()
    delta_stereo = torch.sqrt(torch.tensor(CHI2_STEREO)).item()
    eye6 = torch.eye(6, dtype=Tcw0.dtype, device=Tcw0.device)

    def normal_eq(Tcw, inlier, use_huber):
        """(H, b, total robust objective) at Tcw — the accept test compares
        the same objective the step minimises (ρ(χ²) under Huber)."""
        e, J, is_stereo, behind = _residuals_jac(cam, Tcw, obs)
        w = obs.inv_sigma2 * inlier.to(torch.float32) \
            * (~behind).to(torch.float32)
        chi2, _ = _chi2(e, is_stereo, obs.inv_sigma2)
        rho = chi2
        if use_huber:
            delta = torch.where(is_stereo, delta_stereo, delta_mono)
            sq = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w = w * torch.where(sq > delta, delta / sq, 1.0)
            rho = torch.where(sq > delta, 2.0 * delta * sq - delta * delta,
                              chi2)
        Jw = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, J)
        b = torch.einsum("nij,ni->j", Jw, e)
        total = torch.sum(torch.where(inlier & (~behind), rho,
                                      torch.zeros_like(rho)))
        return H, b, total

    def lm_round(Tcw, inlier, use_huber):
        H, b, chi2_best = normal_eq(Tcw, inlier, use_huber)
        lam = torch.tensor(opt_cfg.initial_lambda, dtype=Tcw.dtype,
                           device=Tcw.device)
        for _ in range(ITERS_PER_ROUND):
            # solve_ex: a singular system (no usable edges) gives a
            # non-finite step that the accept test rejects, as in JAX
            dx = -torch.linalg.solve_ex(H + lam * eye6, b)[0]
            T_cand = lie.se3_exp(dx) @ Tcw
            H_c, b_c, chi2_c = normal_eq(T_cand, inlier, use_huber)
            accept = chi2_c < chi2_best
            gain = (chi2_best - chi2_c) / torch.clamp(chi2_best, min=1e-9)
            done = (accept & (gain < 1e-5)) | (lam > 1e7)
            Tcw = torch.where(accept, T_cand, Tcw)
            H = torch.where(accept, H_c, H)
            b = torch.where(accept, b_c, b)
            chi2_best = torch.where(accept, chi2_c, chi2_best)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            if bool(done):
                break
        return Tcw

    Tcw = Tcw0
    inlier = obs.valid
    for rnd in range(N_ROUNDS):
        Tcw = lm_round(Tcw, inlier, use_huber=(rnd < 2))
        e, _, is_stereo, behind = _residuals_jac(cam, Tcw, obs)
        chi2, th = _chi2(e, is_stereo, obs.inv_sigma2)
        inlier = obs.valid & (chi2 <= th) & (~behind)
    return Tcw, inlier, torch.sum(inlier.to(torch.int32))
