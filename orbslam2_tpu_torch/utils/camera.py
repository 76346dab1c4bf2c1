"""Pinhole camera model: projection, back-projection, rad-tan distortion.

Port of ``orbslam2_tpu/utils/camera.py``.  A ``Camera`` holds Python
floats (float32-rounded, as the JAX version holds numpy float32 scalars),
so it carries no device and works with tensors on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import CameraConfig
from orbslam2_tpu_torch.utils import lie


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    bf: float          # baseline × fx
    width: float
    height: float
    # undistorted-image valid bounds (Frame::ComputeImageBounds)
    min_x: float
    max_x: float
    min_y: float
    max_y: float

    @property
    def baseline(self) -> float:
        return float(np.float32(self.bf) / np.float32(self.fx))

    def K(self, device=None) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)

    @staticmethod
    def from_config(cfg: CameraConfig) -> "Camera":
        def f(v):
            return float(np.float32(v))

        cam = Camera(
            fx=f(cfg.fx), fy=f(cfg.fy), cx=f(cfg.cx), cy=f(cfg.cy),
            k1=f(cfg.k1), k2=f(cfg.k2), p1=f(cfg.p1), p2=f(cfg.p2),
            k3=f(cfg.k3), bf=f(cfg.bf),
            width=f(cfg.width), height=f(cfg.height),
            min_x=0.0, max_x=f(cfg.width), min_y=0.0, max_y=f(cfg.height))
        if cfg.has_distortion:
            corners = torch.tensor(
                [[0.0, 0.0], [cfg.width, 0.0], [0.0, cfg.height],
                 [cfg.width, cfg.height]], dtype=torch.float32)
            und = undistort_points(cam, corners).numpy()
            cam = cam._replace(
                min_x=f(min(und[0, 0], und[2, 0])),
                max_x=f(max(und[1, 0], und[3, 0])),
                min_y=f(min(und[0, 1], und[1, 1])),
                max_y=f(max(und[2, 1], und[3, 1])))
        return cam


def _nonzero_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] → pixel coords [..., 2]."""
    zs = _nonzero_z(pts_cam[..., 2])
    u = cam.fx * pts_cam[..., 0] / zs + cam.cx
    v = cam.fy * pts_cam[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Camera, pts_cam: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [..., 3] = (u_left, v, u_right) with u_r = u − bf/z."""
    uv = project(cam, pts_cam)
    ur = uv[..., 0] - cam.bf / _nonzero_z(pts_cam[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: Camera, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] + depth [...] → camera-frame [..., 3]."""
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)


def project_world(cam: Camera, Tcw: torch.Tensor, pts_w: torch.Tensor):
    """World points → (uv [..., 2], depth [...]) under one pose."""
    pc = lie.transform_points(Tcw, pts_w)
    return project(cam, pc), pc[..., 2]


def distort_normalized(cam: Camera, xy: torch.Tensor) -> torch.Tensor:
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv: torch.Tensor, iters: int = 10
                     ) -> torch.Tensor:
    """Observed pixels → ideal pixels: Gauss-Newton on the forward rad-tan
    model (the JAX ``fori_loop`` becomes a Python loop)."""
    xy0 = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                       (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xy = xy0
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dradial_dr2 = cam.k1 + r2 * (2.0 * cam.k2 + 3.0 * r2 * cam.k3)
        j00 = radial + x * (2.0 * x) * dradial_dr2 + 2.0 * cam.p1 * y \
            + 6.0 * cam.p2 * x
        j01 = x * (2.0 * y) * dradial_dr2 + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
        j10 = y * (2.0 * x) * dradial_dr2 + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
        j11 = radial + y * (2.0 * y) * dradial_dr2 + 6.0 * cam.p1 * y \
            + 2.0 * cam.p2 * x
        r = distort_normalized(cam, xy) - xy0
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                          det)
        dx = (j11 * r[..., 0] - j01 * r[..., 1]) / det
        dy = (-j10 * r[..., 0] + j00 * r[..., 1]) / det
        xy = xy - torch.stack([dx, dy], dim=-1)
    return torch.stack([xy[..., 0] * cam.fx + cam.cx,
                        xy[..., 1] * cam.fy + cam.cy], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return ((uv[..., 0] >= cam.min_x) & (uv[..., 0] < cam.max_x)
            & (uv[..., 1] >= cam.min_y) & (uv[..., 1] < cam.max_y))


def in_frustum(cam: Camera, Tcw: torch.Tensor, pts_w: torch.Tensor,
               min_dist: torch.Tensor, max_dist: torch.Tensor,
               normal: torch.Tensor, view_cos_limit: float = 0.5):
    """Vectorised Frame::isInFrustum under one pose Tcw [4, 4] for points
    [P, 3].  Returns (visible [P], uv [P, 2], ur [P], dist [P],
    view_cos [P])."""
    R, t = lie.mat_to_rt(Tcw)
    pc = torch.sum(pts_w[..., :, None, :] * R, dim=-1) + t
    z = pc[..., 2]
    uv = project(cam, pc)
    ur = uv[..., 0] - cam.bf / _nonzero_z(z)
    Ow = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    po = pts_w - Ow
    dist = torch.linalg.vector_norm(po, dim=-1)
    dist_safe = torch.where(dist < 1e-9, torch.full_like(dist, 1e-9), dist)
    view_cos = torch.sum(po * normal, dim=-1) / dist_safe
    ok = ((z > 0.0) & in_image(cam, uv)
          & (dist >= min_dist) & (dist <= max_dist)
          & (view_cos >= view_cos_limit))
    return ok, uv, ur, dist, view_cos
