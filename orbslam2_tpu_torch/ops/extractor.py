"""ORB feature extraction: pyramid FAST + orientation + rotated BRIEF.

Port of ``orbslam2_tpu/ops/extractor.py``.  The JAX version samples
patches and BRIEF points with one-hot matmuls (``ops/sampling.py``, a
workaround for slow TPU gathers); here they are direct gathers of the
same clamped coordinates.  Keypoint selection keeps the JAX tie rules:
first-index argmax within a cell, lower-index-first global top-k.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from orbslam2_tpu_torch.config import OrbConfig
from orbslam2_tpu_torch.ops import fast as fast_ops
from orbslam2_tpu_torch.ops import image as image_ops
from orbslam2_tpu_torch.ops import pattern as pattern_mod
from orbslam2_tpu_torch.utils.index import topk

CELL = 30
TOPK_PER_CELL = 8
DESC_HALF = 20   # ≥ ceil(PATTERN_RADIUS·√2): covers any rotated sample


class Features(NamedTuple):
    """Fixed-capacity feature set for one image."""

    xy: torch.Tensor        # [N, 2] float32 (x, y) at level-0 scale
    level: torch.Tensor     # [N] int32
    angle: torch.Tensor     # [N] float32 radians
    response: torch.Tensor  # [N] float32 FAST score
    valid: torch.Tensor     # [N] bool
    desc: torch.Tensor      # [N, 8] int32 words holding uint32 bits

    @property
    def n(self) -> int:
        return self.xy.shape[-2]


class OrbLevels(NamedTuple):
    scales: Tuple[float, ...]
    caps: Tuple[int, ...]
    sigma2: Tuple[float, ...]


def level_plan(cfg: OrbConfig) -> OrbLevels:
    """Feature budget per level, a geometric series in 1/scaleFactor that
    sums exactly to the padded capacity."""
    n_pad = cfg.n_features_padded
    inv = 1.0 / cfg.scale_factor
    weights = np.array([inv ** l for l in range(cfg.n_levels)])
    raw = weights / weights.sum() * n_pad
    caps = np.floor(raw).astype(int)
    rem = n_pad - caps.sum()
    order = np.argsort(-(raw - caps))
    caps[order[:rem]] += 1
    scales = tuple(cfg.scale_factor ** l for l in range(cfg.n_levels))
    return OrbLevels(scales=scales, caps=tuple(int(c) for c in caps),
                     sigma2=tuple(s * s for s in scales))


def _select_keypoints(score: torch.Tensor, cap: int, ini_th: float,
                      min_th: float, border: int):
    """Per-cell two-threshold FAST + rank-penalized bucketed top-k.
    Returns (xy [cap, 2] int32 level coords, response [cap], valid [cap])."""
    h, w = score.shape
    dev = score.device
    inb = torch.zeros((h, w), dtype=torch.bool, device=dev)
    inb[border:h - border, border:w - border] = True
    score = torch.where(inb, score, torch.zeros_like(score))

    hc, wc = -(-h // CELL), -(-w // CELL)
    sp = F.pad(score, (0, wc * CELL - w, 0, hc * CELL - h))
    cells = sp.reshape(hc, CELL, wc, CELL).permute(0, 2, 1, 3)
    cells = cells.reshape(hc * wc, CELL * CELL)                  # [C, 900]

    cell_max = torch.amax(cells, dim=1, keepdim=True)
    keep = (cells > ini_th) | ((cells > min_th) & (cell_max <= ini_th))
    work = torch.where(keep, cells, torch.zeros_like(cells))

    vals_l, idx_l = [], []
    col = torch.arange(CELL * CELL, device=dev)[None, :]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for _ in range(TOPK_PER_CELL):
        am = torch.argmax(work, dim=1)                           # first index
        vals_l.append(torch.gather(work, 1, am[:, None])[:, 0])
        idx_l.append(am)
        work = torch.where(col == am[:, None], neg_inf, work)
    vals = torch.stack(vals_l, dim=1)                            # [C, K]
    idx = torch.stack(idx_l, dim=1)
    rank_pen = torch.arange(TOPK_PER_CELL, dtype=torch.float32,
                            device=dev) * 1024.0
    prio = torch.where(vals > 0.0, vals - rank_pen[None, :], neg_inf)

    c_ids = torch.arange(hc * wc, device=dev)[:, None]
    kp_y = ((c_ids // wc) * CELL + idx // CELL).reshape(-1)
    kp_x = ((c_ids % wc) * CELL + idx % CELL).reshape(-1)

    top_prio, top_i = topk(prio.reshape(-1), cap)
    valid = top_prio > float("-inf")
    out_xy = torch.stack([kp_x[top_i], kp_y[top_i]], dim=-1).to(torch.int32)
    out_resp = vals.reshape(-1)[top_i]
    return (torch.where(valid[:, None], out_xy, torch.zeros_like(out_xy)),
            torch.where(valid, out_resp, torch.zeros_like(out_resp)), valid)


@functools.lru_cache(maxsize=None)
def _moment_kernels() -> np.ndarray:
    disc = pattern_mod.ic_angle_disc()
    r = pattern_mod.HALF_PATCH
    coords = np.arange(-r, r + 1, dtype=np.float32)
    kx = (disc * coords[None, :]).reshape(-1)
    ky = (disc * coords[:, None]).reshape(-1)
    return np.stack([kx, ky], axis=-1)        # [961, 2]


def _patch_rows_cols(h: int, w: int, cx: torch.Tensor, cy: torch.Tensor,
                     half_h: int, half_w: int):
    """Row/col indices of the (2·half+1)² windows centred at (cx, cy),
    centres clamped so the window stays in the image (the JAX
    ``sampling.extract_patches`` convention)."""
    dev = cx.device
    cyc = torch.clamp(cy.long(), half_h, h - 1 - half_h)
    cxc = torch.clamp(cx.long(), half_w, w - 1 - half_w)
    rows = cyc[:, None] + torch.arange(-half_h, half_h + 1, device=dev)[None]
    cols = cxc[:, None] + torch.arange(-half_w, half_w + 1, device=dev)[None]
    return rows, cols


def extract_patches(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                    half_h: int, half_w: int) -> torch.Tensor:
    """[H, W] + integer centres [n] → [n, 2·half_h+1, 2·half_w+1]."""
    h, w = img.shape
    rows, cols = _patch_rows_cols(h, w, cx, cy, half_h, half_w)
    return img[rows[:, :, None], cols[:, None, :]]


def keypoint_angles(level_img: torch.Tensor, xy: torch.Tensor
                    ) -> torch.Tensor:
    """IC angles at the keypoints: 31×31 patch moments, then atan2."""
    r = pattern_mod.HALF_PATCH
    patches = extract_patches(level_img, xy[:, 0], xy[:, 1], r, r
                              ).reshape(-1, (2 * r + 1) ** 2)
    kern = torch.as_tensor(_moment_kernels(), device=level_img.device)
    m = patches @ kern                                           # [cap, 2]
    return torch.atan2(m[:, 1], m[:, 0])


def _descriptors(blurred: torch.Tensor, xy: torch.Tensor,
                 angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF: [cap, 2] int coords + [cap] angles → [cap, 8] int32
    words carrying the uint32 bit pattern."""
    dev = blurred.device
    pat = torch.as_tensor(pattern_mod.brief_pattern(), device=dev)
    px = torch.cat([pat[:, 0], pat[:, 2]]).to(torch.float32)     # [512]
    py = torch.cat([pat[:, 1], pat[:, 3]]).to(torch.float32)
    ca, sa = torch.cos(angle), torch.sin(angle)
    rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    # edge-padded image, patch centre clamped, in-patch sample clamped —
    # exactly the JAX extract_patches + sample_points index arithmetic
    padded = F.pad(blurred[None, None], (DESC_HALF,) * 4,
                   mode="replicate")[0, 0]
    hp, wp = padded.shape
    cyc = torch.clamp(xy[:, 1].long() + DESC_HALF, DESC_HALF,
                      hp - 1 - DESC_HALF)
    cxc = torch.clamp(xy[:, 0].long() + DESC_HALF, DESC_HALF,
                      wp - 1 - DESC_HALF)
    ry_i = torch.clamp(ry.long() + DESC_HALF, 0, 2 * DESC_HALF)
    rx_i = torch.clamp(rx.long() + DESC_HALF, 0, 2 * DESC_HALF)
    vals = padded[cyc[:, None] - DESC_HALF + ry_i,
                  cxc[:, None] - DESC_HALF + rx_i]               # [cap, 512]
    bits = (vals[:, :256] < vals[:, 256:]).to(torch.int64)
    pow2 = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev)
    words = torch.sum(bits.reshape(-1, 8, 32) * pow2, dim=-1)    # [cap, 8]
    return words.to(torch.int32)        # two's-complement wrap of uint32


def extract_level(level_img: torch.Tensor, cap: int, cfg: OrbConfig):
    """One pyramid level → (xy_lvl f32, angle, response, valid, desc)."""
    score = fast_ops.nms_3x3(fast_ops.fast_score(level_img))
    xy, resp, valid = _select_keypoints(
        score, cap, float(cfg.ini_th_fast), float(cfg.min_th_fast),
        border=cfg.edge_threshold)
    angle = keypoint_angles(level_img, xy)
    blurred = image_ops.gaussian_blur(level_img, 7, 2.0)
    desc = _descriptors(blurred, xy, angle)
    return xy.to(torch.float32), angle, resp, valid, desc


def extract(pyramid: List[torch.Tensor], cfg: OrbConfig) -> Features:
    """One image's pyramid (``image.build_pyramid``) → Features of capacity
    n_features_padded.  The JAX version takes the image and builds the
    pyramid itself; the stereo frontend shares one pyramid with stereo
    matching instead of building it twice."""
    plan = level_plan(cfg)
    parts = []
    for l, level_img in enumerate(pyramid):
        xy, angle, resp, valid, desc = extract_level(level_img, plan.caps[l],
                                                     cfg)
        lvl = torch.full((plan.caps[l],), l, dtype=torch.int32,
                         device=level_img.device)
        parts.append((xy * plan.scales[l], lvl, angle, resp, valid, desc))
    return Features(*(torch.cat([p[i] for p in parts]) for i in range(6)))
