"""Stereo rectification: the cv::initUndistortRectifyMap / cv::remap pair
of the EuRoC driver (stereo_euroc.cc:72-100).

Port of ``orbslam2_tpu/ops/rectify.py``:

  * :func:`init_undistort_rectify_map` — the map build (numpy, once per
    run), a copy of the JAX package's: for each DESTINATION pixel, lift
    through the rectified projection P, rotate by R⁻¹, apply the rad-tan
    distortion of K/D, project — the SOURCE pixel to sample;
  * :func:`remap_bilinear` — bilinear sampling on tensors (clamped
    gathers of the 4 neighbours + lerp, 0 out of bounds), plain PyTorch on
    the tensors' device (the JAX version is a ``jax.jit`` program, not a
    Pallas kernel);
  * :class:`StereoRectifier` — the host numpy path (``__call__``, the
    replay drivers' per-frame cost) and the device path (``remap_pair``)
    on the rectifier's device, the CUDA card unless another is named,
    with its maps uploaded once;
  * :func:`load_rectification` — the LEFT./RIGHT. blocks of a settings
    file (``config._parse_opencv_yaml`` yields the !!opencv-matrix blocks
    as numpy arrays); None when the file carries no rectification.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.runtime import device as device_mod


def init_undistort_rectify_map(K: np.ndarray, D: np.ndarray, R: np.ndarray,
                               P3: np.ndarray, width: int, height: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap semantics (stereo_euroc.cc:98-99).

    K [3,3] source intrinsics, D [1,n] rad-tan distortion (k1 k2 p1 p2
    [k3]), R [3,3] rectifying rotation, P3 [3,3] = P.rowRange(0,3)
    .colRange(0,3) new projection.  Returns (map_x, map_y) float32 [H,W]:
    source coordinates for each destination pixel."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.size > 4 else 0.0
    R = np.asarray(R, np.float64)
    P3 = np.asarray(P3, np.float64)

    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    # lift through the NEW projection, rotate back to the source frame
    Pinv = np.linalg.inv(P3)
    x = Pinv[0, 0] * u + Pinv[0, 1] * v + Pinv[0, 2]
    y = Pinv[1, 0] * u + Pinv[1, 1] * v + Pinv[1, 2]
    w = Pinv[2, 0] * u + Pinv[2, 1] * v + Pinv[2, 2]
    Rinv = R.T                      # R maps source→rectified
    X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2] * w
    Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2] * w
    W = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2] * w
    xn = X / W
    yn = Y / W
    # rad-tan distortion of the SOURCE camera
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """cv::remap(..., INTER_LINEAR) on tensors: out[v,u] =
    bilinear(img, map_y[v,u], map_x[v,u]) as float32; out of bounds → 0."""
    H, W = img.shape
    x0 = torch.floor(map_x).long()
    y0 = torch.floor(map_y).long()
    fx = map_x - x0
    fy = map_y - y0
    inb = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    x0c = x0.clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    x1c = (x0 + 1).clamp(0, W - 1)
    y1c = (y0 + 1).clamp(0, H - 1)
    img = img.to(torch.float32)
    v00 = img[y0c, x0c]
    v01 = img[y0c, x1c]
    v10 = img[y1c, x0c]
    v11 = img[y1c, x1c]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(inb, out, 0.0)


class RectifyMaps(NamedTuple):
    lx: np.ndarray
    ly: np.ndarray
    rx: np.ndarray
    ry: np.ndarray


class StereoRectifier:
    """Per-frame stereo rectification with precomputed maps.

    Host path (``__call__``): numpy bilinear with precomputed integer
    indices and weights.  Device path (``remap_pair``): ``remap_bilinear``
    on ``device`` (the CUDA card unless another is named, e.g.
    ``device="cpu"``), the maps uploaded once."""

    def __init__(self, maps: RectifyMaps, device=None):
        self.maps = maps
        self.device = device_mod.resolve(device)
        self._pre = tuple(self._precompute(mx, my)
                          for mx, my in ((maps.lx, maps.ly),
                                         (maps.rx, maps.ry)))
        self._dev_maps = tuple(torch.as_tensor(m, device=self.device)
                               for m in maps)

    @staticmethod
    def _precompute(mx, my):
        H, W = mx.shape
        x0 = np.floor(mx).astype(np.int32)
        y0 = np.floor(my).astype(np.int32)
        fx = (mx - x0)[..., None]
        fy = (my - y0)[..., None]
        inb = (mx >= 0) & (mx <= W - 1) & (my >= 0) & (my <= H - 1)
        x0c = np.clip(x0, 0, W - 1)
        y0c = np.clip(y0, 0, H - 1)
        x1c = np.clip(x0 + 1, 0, W - 1)
        y1c = np.clip(y0 + 1, 0, H - 1)
        idx = (y0c * W + x0c, y0c * W + x1c, y1c * W + x0c, y1c * W + x1c)
        w = np.concatenate([(1 - fx) * (1 - fy), fx * (1 - fy),
                            (1 - fx) * fy, fx * fy], axis=-1
                           ).astype(np.float32)
        return idx, w, inb

    def _apply(self, img: np.ndarray, pre) -> np.ndarray:
        idx, w, inb = pre
        flat = np.asarray(img, np.float32).reshape(-1)
        out = (flat[idx[0]] * w[..., 0] + flat[idx[1]] * w[..., 1]
               + flat[idx[2]] * w[..., 2] + flat[idx[3]] * w[..., 3])
        return np.where(inb, out, 0.0)

    def __call__(self, left: np.ndarray, right: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return (self._apply(left, self._pre[0]),
                self._apply(right, self._pre[1]))

    def remap_pair(self, left, right) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both images (arrays or tensors) rectified on the rectifier's
        device: float32 [H, W] tensors there."""
        lx, ly, rx, ry = self._dev_maps
        return (remap_bilinear(torch.as_tensor(left, device=self.device),
                               lx, ly),
                remap_bilinear(torch.as_tensor(right, device=self.device),
                               rx, ry))


def load_rectification(settings_path_or_flat, device=None
                       ) -> Optional[StereoRectifier]:
    """A StereoRectifier (on ``device``) from a settings file, or its
    parsed flat dict, carrying LEFT./RIGHT. rectification blocks
    (Stereo-EuRoC.yaml); None when they are absent."""
    if isinstance(settings_path_or_flat, dict):
        flat = settings_path_or_flat
    else:
        from orbslam2_tpu_torch.config import _parse_opencv_yaml
        with open(settings_path_or_flat) as f:
            flat = _parse_opencv_yaml(f.read())
    need = ["LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P",
            "RIGHT.K", "RIGHT.D", "RIGHT.R", "RIGHT.P"]
    if not all(k in flat and isinstance(flat[k], np.ndarray) for k in need):
        return None
    wl = int(flat.get("LEFT.width", 0))
    hl = int(flat.get("LEFT.height", 0))
    wr = int(flat.get("RIGHT.width", 0))
    hr = int(flat.get("RIGHT.height", 0))
    if not (wl and hl and wr and hr):
        return None
    lx, ly = init_undistort_rectify_map(
        flat["LEFT.K"], flat["LEFT.D"], flat["LEFT.R"],
        np.asarray(flat["LEFT.P"])[:3, :3], wl, hl)
    rx, ry = init_undistort_rectify_map(
        flat["RIGHT.K"], flat["RIGHT.D"], flat["RIGHT.R"],
        np.asarray(flat["RIGHT.P"])[:3, :3], wr, hr)
    return StereoRectifier(RectifyMaps(lx, ly, rx, ry), device=device)
