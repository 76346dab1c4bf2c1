"""AR demo: the ViewerAR / ros_mono_ar capability
(Test/Replay/ROS/ORB_SLAM2/src/AR/ViewerAR.cc) without Pangolin — plane
detection over the live map + virtual cubes rendered into the camera
frames.

Port of ``orbslam2_tpu/utils/ar.py``.  ViewerAR.cc semantics kept:
  * DetectPlane (:392-488): RANSAC 3-point plane fits over map points
    with >5 observations (≥50 required), scored by the MEDIAN point-to-
    plane distance; the plane frame Tpw puts the origin at the inlier
    centroid with y aligned to the normal.
  * "Insert Cube" drops a cube of ``size`` on the latest detected plane;
    several cubes on different planes accumulate (:159-180).

The RANSAC is one batch over all hypotheses on the map's device, with no
host read; its draws come from an explicit ``torch.Generator``, or are
passed in (``idx=``) so that tests can hand it the JAX package's draws.
The median is ``jnp.nanmedian``'s (the mean of the two middle values at an
even count of candidates).  Rendering is host-side numpy (a viewer, not a
kernel)."""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import CameraConfig
from orbslam2_tpu_torch.ops.initializer import nanmedian


class PlaneFit(NamedTuple):
    ok: torch.Tensor        # bool — enough points / found a plane
    n: torch.Tensor         # [3] unit normal
    d: torch.Tensor         # plane offset: n·x + d = 0
    origin: torch.Tensor    # [3] inlier centroid


def draw_hypotheses(cand: torch.Tensor, n_hypotheses: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """[H, 3] point indices drawn with replacement among the candidates
    (uniform over all points when there is none: that fit is not ok)."""
    w = cand.to(torch.float32)
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    return torch.multinomial(w, 3 * n_hypotheses, replacement=True,
                             generator=generator).reshape(n_hypotheses, 3)


def detect_plane(points: torch.Tensor, valid: torch.Tensor,
                 n_obs: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 n_hypotheses: int = 64,
                 idx: Optional[torch.Tensor] = None) -> PlaneFit:
    """Batched DetectPlane (ViewerAR.cc:392): points [P,3]; candidates
    need >5 observations and ≥50 must exist.  ``idx`` [H, 3]: the
    hypotheses' point indices, drawn from ``generator`` when not given."""
    cand = valid & (n_obs > 5)
    n_cand = torch.sum(cand.to(torch.int32))
    if idx is None:
        idx = draw_hypotheses(cand, n_hypotheses, generator)
    tri = points[idx.to(device=points.device, dtype=torch.long)]  # [H,3,3]
    nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(nn, min=1e-9)
    d = -torch.sum(nrm * tri[:, 0], dim=-1)                     # [H]
    dist = torch.abs(points @ nrm.T + d[None, :])               # [P, H]
    dist = torch.where(cand[:, None], dist, torch.nan)
    med = nanmedian(dist, dim=0)                                # [H]
    med = torch.where(nn[:, 0] > 1e-6, med, torch.inf)
    best = torch.argmin(med).reshape(1)                  # first of ties
    n_best = nrm.index_select(0, best)[0]
    d_best = d.index_select(0, best)[0]
    med_best = med.index_select(0, best)[0]
    inl = cand & (torch.abs(points @ n_best + d_best) < 4.0 * med_best)
    w = inl.to(points.dtype)[:, None]
    origin = torch.sum(points * w, dim=0) / torch.clamp(torch.sum(w),
                                                        min=1.0)
    return PlaneFit(ok=(n_cand >= 50) & torch.isfinite(med_best),
                    n=n_best, d=d_best, origin=origin)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def plane_frame(fit: PlaneFit, up_hint: np.ndarray = None) -> np.ndarray:
    """Twp [4,4]: plane frame with origin at the inlier centroid and the
    y axis along the normal (ViewerAR Plane ctor semantics)."""
    n = _host(fit.n)
    if up_hint is not None and float(n @ np.asarray(up_hint)) < 0:
        n = -n
    a = np.array([1.0, 0.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([0.0, 0.0, 1.0])
    x = np.cross(n, a)
    x /= np.linalg.norm(x)
    z = np.cross(x, n)
    Twp = np.eye(4)
    Twp[:3, 0] = x
    Twp[:3, 1] = n
    Twp[:3, 2] = z
    Twp[:3, 3] = _host(fit.origin)
    return Twp


_CUBE_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6),
               (6, 4), (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_cube(img: np.ndarray, cam: CameraConfig, Tcw: np.ndarray,
              Twp: np.ndarray, size: float = 0.05,
              intensity: float = 255.0) -> np.ndarray:
    """Render a wireframe cube of side ``size`` sitting ON the plane
    (its base at the plane, as the reference draws it) into a grayscale
    frame.  Host-side sampling rasterizer."""
    s = size / 2.0
    corners_p = np.array([[x, y, z, 1.0]
                          for y in (0.0, size)
                          for x in (-s, s)
                          for z in (-s, s)])         # base at plane level
    Tcp = np.asarray(Tcw, np.float64) @ np.asarray(Twp, np.float64)
    pc = corners_p @ Tcp[:3, :4].T                   # [8, 3]
    out = np.array(img, np.float32, copy=True)
    h, w = out.shape
    z = pc[:, 2]
    if np.any(z <= 0.05):
        return out
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    for i, j in _CUBE_EDGES:
        n_samp = int(max(abs(u[i] - u[j]), abs(v[i] - v[j]), 1)) + 1
        us = np.linspace(u[i], u[j], n_samp).round().astype(int)
        vs = np.linspace(v[i], v[j], n_samp).round().astype(int)
        ok = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
        out[vs[ok], us[ok]] = intensity
    return out


class ArDemo:
    """ros_mono_ar's menu state: detect planes on demand, keep the cube
    list, overlay them on every tracked frame.  The RANSAC draws come from
    a generator on the engine's device, seeded with ``seed``."""

    def __init__(self, engine, cube_size: float = 0.05, seed: int = 5):
        self.engine = engine
        self.cube_size = cube_size
        self.planes: List[np.ndarray] = []           # Twp per cube
        self._gen = torch.Generator(device=engine.device)
        self._gen.manual_seed(seed)

    def insert_cube(self) -> bool:
        """menu.Insert Cube (ViewerAR.cc:170-180): detect a plane in the
        current map, anchor a cube on it."""
        ms = self.engine.ms
        fit = detect_plane(ms.mp_pos, ms.mp_valid, ms.mp_n_obs, self._gen)
        if not bool(fit.ok):
            return False
        self.planes.append(plane_frame(fit))
        return True

    def clear(self) -> None:
        self.planes = []                             # menu.Clear All

    def render(self, frame: np.ndarray, Tcw: Optional[np.ndarray]
               ) -> np.ndarray:
        if Tcw is None:
            return np.asarray(frame, np.float32)
        out = np.asarray(frame, np.float32)
        for Twp in self.planes:
            out = draw_cube(out, self.engine.cfg.camera, Tcw, Twp,
                            self.cube_size)
        return out
