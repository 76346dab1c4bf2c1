"""Image ops: scale pyramid and Gaussian blur.

Port of ``orbslam2_tpu/ops/image.py``.  The bilinear resize is a pair of
two-tap gathers along rows and columns, not the JAX version's
resize-as-matmul (that form exists only to put the resize on the TPU's
matrix unit); the taps and weights are the same.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float
                   ) -> List[Tuple[int, int]]:
    """Static (H, W) per level — level l scaled by 1/scale_factor**l."""
    return [(int(round(h / scale_factor ** l)), int(round(w / scale_factor ** l)))
            for l in range(n_levels)]


@functools.lru_cache(maxsize=None)
def _resize_taps(n_out: int, n_in: int):
    """(lo0, lo1, w0, w1) of the half-pixel-centre bilinear resize — the
    rows of the JAX version's interpolation matrix, with the two taps
    merged (in float32, as the matrix accumulates them) where clamping
    makes them coincide."""
    scale = n_in / n_out
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(centers).astype(np.int64)
    frac = centers - lo
    lo0 = np.clip(lo, 0, n_in - 1)
    lo1 = np.clip(lo + 1, 0, n_in - 1)
    w0 = (1.0 - frac).astype(np.float32)
    w1 = frac.astype(np.float32)
    same = lo0 == lo1
    w0 = np.where(same, w0 + w1, w0).astype(np.float32)
    w1 = np.where(same, np.float32(0.0), w1).astype(np.float32)
    return lo0, lo1, w0, w1


def _resize_axis(img: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    lo0, lo1, w0, w1 = _resize_taps(n_out, img.shape[axis])
    dev = img.device
    lo0 = torch.as_tensor(lo0, device=dev)
    lo1 = torch.as_tensor(lo1, device=dev)
    shape = [1] * img.dim()
    shape[axis] = n_out
    w0 = torch.as_tensor(w0, device=dev).reshape(shape)
    w1 = torch.as_tensor(w1, device=dev).reshape(shape)
    return (w0 * torch.index_select(img, axis, lo0)
            + w1 * torch.index_select(img, axis, lo1))


def resize_bilinear(img: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    """[..., H, W] → [..., h2, w2] separable bilinear resize."""
    out = _resize_axis(img, h2, img.dim() - 2)
    return _resize_axis(out, w2, img.dim() - 1)


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float
                  ) -> List[torch.Tensor]:
    """[..., H, W] float32 → n_levels tensors, level 0 = input, each level
    resized from the previous one."""
    shapes = pyramid_shapes(img.shape[-2], img.shape[-1], n_levels,
                            scale_factor)
    out = [img]
    for l in range(1, n_levels):
        out.append(resize_bilinear(out[-1], *shapes[l]))
    return out


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect_pad(img: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-101 padding of the last two axes (OpenCV's default border,
    numpy's and torch's 'reflect')."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    x = F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    return x.reshape(tuple(lead) + tuple(x.shape[-2:]))


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0
                  ) -> torch.Tensor:
    """Separable Gaussian blur, reflect-101 borders, [..., H, W] → same."""
    k = _gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    xp = _reflect_pad(img, r, 0)
    acc = None
    for i in range(ksize):
        term = float(k[i]) * xp[..., i:i + h, :]
        acc = term if acc is None else acc + term
    xp = _reflect_pad(acc, 0, r)
    acc = None
    for i in range(ksize):
        term = float(k[i]) * xp[..., :, i:i + w]
        acc = term if acc is None else acc + term
    return acc
