# Verbatim copy of orbslam2_tpu/ops/pattern.py: the JAX package imports jax on import,
# which the GPU host does not have.  tests/test_torch_copies.py holds it equal.
"""Sampling patterns for rotated-BRIEF description and IC-angle orientation.

The reference embeds ORB's learned 256-pair table
(``bit_pattern_31_``, src/ORBextractor.cc:145-403).  We deliberately do NOT
copy it: this framework generates its own deterministic pattern with the
BRIEF paper's G-II recipe (both endpoints iid N(0, (patch/5)²), clipped to
the radius-13 disc so a rotated pair stays inside the 19-px edge threshold).
Descriptors are therefore not bit-compatible with OpenCV ORB — they don't
need to be; all matching is internal to the framework.
"""

from __future__ import annotations

import functools

import numpy as np

N_BITS = 256
HALF_PATCH = 15          # IC-angle disc radius (ORBextractor.cc:448-463)
PATTERN_RADIUS = 13      # max |coordinate| of a pattern endpoint


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 7) -> np.ndarray:
    """[256, 4] int32: (x1, y1, x2, y2) per bit, all inside radius-13 disc."""
    rng = np.random.default_rng(seed)
    pts = []
    sigma = 31.0 / 5.0
    while len(pts) < N_BITS:
        p = rng.normal(0.0, sigma, size=4)
        p = np.clip(np.round(p), -PATTERN_RADIUS, PATTERN_RADIUS)
        if (p[0] ** 2 + p[1] ** 2 <= PATTERN_RADIUS ** 2
                and p[2] ** 2 + p[3] ** 2 <= PATTERN_RADIUS ** 2
                and (p[0] != p[2] or p[1] != p[3])):
            pts.append(p)
    return np.asarray(pts, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def ic_angle_disc(half_patch: int = HALF_PATCH) -> np.ndarray:
    """[2r+1, 2r+1] float32 mask of the orientation disc.

    Row half-widths follow OpenCV's ``umax`` construction
    (u ≤ round(√(r² − v²))), so IC angles agree with cv2.ORB's.
    """
    r = half_patch
    vs = np.arange(-r, r + 1)
    umax = np.round(np.sqrt(np.maximum(r * r - vs * vs, 0.0))).astype(np.int32)
    mask = np.zeros((2 * r + 1, 2 * r + 1), np.float32)
    for i, v in enumerate(vs):
        u = umax[i]
        mask[i, r - u:r + u + 1] = 1.0
    return mask
