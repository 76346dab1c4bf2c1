"""FAST-9/16 corner scores and 3×3 non-max suppression.

Port of ``orbslam2_tpu/ops/fast.py``: each pixel's exact corner score
(the largest threshold at which it is still a FAST-9 corner) from 16
rolled copies of the image and a circular min-filter along the ring.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (clockwise from 12 o'clock)
CIRCLE_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

ARC_LEN = 9


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """[H, W] float32 (0..255) → [H, W] float32 corner scores; a pixel is a
    corner at threshold t iff score > t.  The 3-px border scores 0."""
    x = img.to(torch.float32)
    ring = torch.stack([torch.roll(x, shifts=(-int(dy), -int(dx)),
                                   dims=(0, 1))
                        for dx, dy in CIRCLE_OFFSETS])          # [16, H, W]
    d_bright = ring - x[None]
    d_dark = -d_bright

    def arc_score(d):
        mins = d
        for j in range(1, ARC_LEN):
            mins = torch.minimum(mins, torch.roll(d, -j, dims=0))
        return torch.amax(mins, dim=0)

    score = torch.maximum(arc_score(d_bright), arc_score(d_dark))
    h, w = x.shape
    valid = torch.zeros((h, w), dtype=torch.bool, device=x.device)
    valid[3:h - 3, 3:w - 3] = True
    return torch.where(valid, score, torch.zeros_like(score))


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep a pixel only if it is the maximum of its 3×3 neighbourhood;
    plateau ties go to the later pixel in scan order via a sub-resolution
    index fraction (as in the JAX version)."""
    h, w = score.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=score.device
                       ).reshape(h, w)
    frac = idx.to(torch.float32) * (0.5 / (h * w))
    aug = torch.where(score > 0.0, score + frac, torch.zeros_like(score))
    neigh_max = F.max_pool2d(aug[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(aug >= neigh_max, score, torch.zeros_like(score))
