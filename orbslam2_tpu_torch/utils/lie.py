"""SO(3) / SE(3) Lie-group operations on torch tensors.

Port of ``orbslam2_tpu/utils/lie.py`` (SE3 part; Sim3 and quaternions wait
for the loop-closing slice).  Poses are ``[..., 4, 4]`` homogeneous
matrices, twists ``[..., 6]`` = [ω, υ], all with arbitrary leading batch
dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew → [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(x):
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)


def _cosc(x):
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 24.0,
                       (1.0 - torch.cos(xs)) / (xs * xs))


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle → [..., 3, 3] rotation."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    return (_eye3(W) + _sinc(theta)[..., None, None] * W
            + _cosc(theta)[..., None, None] * W2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation → [..., 3] axis-angle (θ < π − ε, with the
    near-π branch of the JAX version)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = _safe_norm(w)
    theta = torch.atan2(sin_t, cos_t)
    general = w * (theta / torch.where(sin_t < _EPS, torch.ones_like(sin_t),
                                       sin_t))[..., None]
    B = (R + _eye3(R)) * 0.5
    axis = torch.sqrt(torch.clamp(torch.stack(
        [B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1), min=1e-24))

    def _sgn(x):
        return torch.sign(torch.where(x == 0, torch.ones_like(x), x))

    signs = torch.stack([torch.ones_like(axis[..., 0]), _sgn(B[..., 0, 1]),
                         _sgn(B[..., 0, 2])], dim=-1)
    near_pi_axis = axis * signs * _sgn(w[..., 0])[..., None]
    near_pi = (near_pi_axis / _safe_norm(near_pi_axis)[..., None]
               * theta[..., None])
    return torch.where((theta < 1e-5)[..., None], w,
                       torch.where((sin_t < 1e-4)[..., None], near_pi,
                                   general))


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    t = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    small = t < 1e-4
    ts = torch.where(small, torch.ones_like(t), t)
    A = torch.where(small, 0.5 - t * t / 24.0, (1.0 - torch.cos(ts)) / (ts * ts))
    B = torch.where(small, 1.0 / 6.0 - t * t / 120.0,
                    (ts - torch.sin(ts)) / (ts ** 3))
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    t = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    small = t < 1e-4
    ts = torch.where(small, torch.ones_like(t), t)
    half = ts * 0.5
    cot = half / torch.tan(half)
    K = torch.where(small, 1.0 / 12.0 + t * t / 720.0, (1.0 - cot) / (ts * ts))
    return _eye3(W) - 0.5 * W + K[..., None, None] * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist [ω, υ] → [..., 4, 4] transform."""
    w, v = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = (so3_left_jacobian(w) @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] → [..., 6] twist [ω, υ]."""
    R, t = mat_to_rt(T)
    w = so3_log(R)
    v = (so3_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """([..., 3, 3], [..., 3]) → [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.eye(4, dtype=R.dtype, device=R.device).repeat(*batch, 1, 1)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def mat_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    R, t = mat_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """One pose applied to a set of points: T [4, 4] × pts [..., 3] →
    [..., 3].

    The batch rule is explicit — ONE pose, any number of points — where
    the JAX version dispatches on ndim (``lie.py:178``) and silently
    changes meaning with the input's rank."""
    if T.shape != (4, 4):
        raise ValueError(f"transform_points takes one [4, 4] pose, got "
                         f"{tuple(T.shape)}")
    R, t = mat_to_rt(T)
    return torch.sum(pts[..., None, :] * R, dim=-1) + t

