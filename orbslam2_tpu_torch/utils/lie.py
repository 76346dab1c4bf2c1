"""SO(3) / SE(3) / Sim(3) Lie-group operations on torch tensors.

Port of ``orbslam2_tpu/utils/lie.py``, the quaternion part
(``lie.py:186-249``: TUM-order (x, y, z, w) quaternions and HPose's
Euler angles) included.  Poses are ``[..., 4, 4]`` homogeneous
matrices, twists ``[..., 6]`` = [ω, υ], Sim3 elements ``(s, R, t)`` with
x ↦ s·R·x + t and tangents ``[..., 7]`` = [ω, υ, σ], all with arbitrary
leading batch dimensions.
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


# ------------------------------------------------------------- quaternion ----

def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] → [..., 4] quaternion (x, y, z, w), TUM trajectory order
    (System.cc:516 writes q.x q.y q.z q.w).  All four extractions are
    computed and one is selected as JAX does: the trace branch when the
    trace is positive, else the one of the largest diagonal entry (the
    near-180° rotations)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw0 = half_sqrt(1.0 + tr)
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)
    cond_tr = (tr > 0.0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_tr, q0,
                    torch.where(cond_x, q1, torch.where(cond_y, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x, y, z, w) → [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a·b of [..., 4] (x, y, z, w) quaternions."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def euler_from_quat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x, y, z, w) → [..., 3] roll, pitch, yaw (HPose.cpp)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


# ----------------------------------------------------------------- Sim(3) ----
# (s, R, t): x ↦ s·R·x + t, as g2o::Sim3.

def sim3_apply(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
               pts: torch.Tensor) -> torch.Tensor:
    """([...], [..., 3, 3], [..., 3]) on [..., N, 3]."""
    return (s[..., None, None] * (pts @ R.transpose(-1, -2))
            + t[..., None, :])


def sim3_inv(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -(s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def sim3_mul(s1, R1, t1, s2, R2, t2):
    """(s1,R1,t1) ∘ (s2,R2,t2): first apply 2, then 1."""
    return (s1 * s2, R1 @ R2,
            s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1)


def _sim3_coeffs(w: torch.Tensor, sigma: torch.Tensor):
    """(s, A, B, C) of the W matrix A·I + B·[ω]× + C·[ω]×² with the σ→0
    and θ→0 limits (Strasdat's Sim3 exp)."""
    s = torch.exp(sigma)
    theta = _safe_norm(w)
    eps = 1e-5
    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    sig_s = torch.where(sig_small, torch.ones_like(sigma), sigma)
    th_s = torch.where(th_small, torch.ones_like(theta), theta)
    A = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_s)
    denom = sig_s * sig_s + th_s * th_s
    sin_t, cos_t = torch.sin(th_s), torch.cos(th_s)
    B_gen = (sig_s * (s * sin_t) + th_s * (1.0 - s * cos_t)) / (th_s * denom)
    C_gen = (A - ((s * cos_t - 1.0) * sig_s + s * sin_t * th_s) / denom) \
        / (th_s * th_s)
    B_sig0 = _cosc(theta)
    C_sig0 = torch.where(th_small, torch.full_like(theta, 1.0 / 6.0),
                         (th_s - torch.sin(th_s)) / (th_s ** 3))
    B_th0 = torch.where(sig_small, 0.5 + sigma / 6.0,
                        ((sig_s - 1.0) * s + 1.0) / (sig_s * sig_s))
    C_th0 = torch.where(
        sig_small, 1.0 / 6.0 + sigma / 24.0,
        (s * (0.5 * sig_s * sig_s - sig_s + 1.0) - 1.0) / (sig_s ** 3))
    B = torch.where(th_small, B_th0, torch.where(sig_small, B_sig0, B_gen))
    C = torch.where(th_small, C_th0, torch.where(sig_small, C_sig0, C_gen))
    return s, A, B, C


def _sim3_wmat(xi: torch.Tensor) -> torch.Tensor:
    """The W matrix of sim3_exp (t = W·υ) for tangent ``xi`` [..., 7]."""
    w = xi[..., :3]
    _, A, B, C = _sim3_coeffs(w, xi[..., 6])
    W = hat(w)
    return (A[..., None, None] * _eye3(W) + B[..., None, None] * W
            + C[..., None, None] * (W @ W))


def sim3_exp(xi: torch.Tensor):
    """[..., 7] = [ω, υ, σ] → (s, R, t)."""
    w, v = xi[..., :3], xi[..., 3:6]
    s = torch.exp(xi[..., 6])
    t = (_sim3_wmat(xi) @ v[..., None])[..., 0]
    return s, so3_exp(w), t


def sim3_log(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor
             ) -> torch.Tensor:
    """(s, R, t) → [..., 7]: inverts sim3_exp by solving W·υ = t."""
    sigma = torch.log(s)
    w = so3_log(R)
    Wmat = _sim3_wmat(torch.cat([w, torch.zeros_like(w), sigma[..., None]],
                                dim=-1))
    # solve_ex: no error check, so no device→host read (the pose graph
    # calls this inside its fixed-length loops)
    v = torch.linalg.solve_ex(Wmat, t[..., None])[0][..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def sim3_to_mat(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                ) -> torch.Tensor:
    """(s, R, t) → [..., 4, 4] with sR in the upper block."""
    return rt_to_mat(s[..., None, None] * R, t)


def mat_to_sim3(T: torch.Tensor):
    sR = T[..., :3, :3]
    s = torch.exp(torch.log(torch.clamp(torch.linalg.det(sR), min=1e-30))
                  / 3.0)
    return s, sR / s[..., None, None], T[..., :3, 3]
