"""FAST-9/16 corner scores and 3×3 non-max suppression.

Port of ``orbslam2_tpu/ops/fast.py``: each pixel's exact corner score
(the largest threshold at which it is still a FAST-9 corner) from the 16
shifted copies of the image on the ring and a circular min-filter along
it (each run of 9 a window of one strided view).
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
_RING_WRAPPED = [(int(dx), int(dy)) for dx, dy in np.concatenate(
    [CIRCLE_OFFSETS, CIRCLE_OFFSETS[:ARC_LEN - 1]])]


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """[H, W] float32 (0..255) → [H, W] float32 corner scores; a pixel is a
    corner at threshold t iff score > t.  The 3-px border scores 0."""
    x = img.to(torch.float32)
    h, w = x.shape
    # the ring's 16 offsets and its first 8 again, so that every run of 9
    # is a window; zero padding reaches only the border, which scores 0
    pad = F.pad(x[None, None], (3, 3, 3, 3))[0, 0]
    ring = torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dx, dy in _RING_WRAPPED]) - x[None]  # [24, H, W]
    runs = ring.unfold(0, ARC_LEN, 1)                      # [16, H, W, 9]
    bright = torch.amax(torch.amin(runs, dim=-1), dim=0)
    dark = -torch.amin(torch.amax(runs, dim=-1), dim=0)    # the runs of −d
    score = torch.maximum(bright, dark)
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
