"""Streaming window tracking for localization: B stereo frames per call.

Port of ``orbslam2_tpu/runtime/streaming.py``.  One flat uint8 buffer
holds B stereo pairs; per frame the tracker runs the frontend, a
constant-velocity prediction from the carried poses, the un-widened
two-stage track (motion model, then local map) and sums the frame's
visible/found masks.  Poses and associations carry from frame to frame
and from window to window as tensors on the device; only ``summaries``
is meant for the host.

The JAX version scans the window in one device program; here the scan is
a Python loop over tensors on the device, so each frame pays its own
launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.models import frame as frame_mod
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.runtime import tracking


class WindowResult(NamedTuple):
    summaries: torch.Tensor   # [B, 40] per-frame summaries (host-read)
    state_T: torch.Tensor     # [2, 4, 4] (last Tcw, previous Tcw)
    assoc: torch.Tensor       # [N] final frame's inlier associations
    counters: torch.Tensor    # [2, P] int32 (visible, found) sums


def pack_window_uint8(left_right_frames) -> np.ndarray:
    """List of (left, right) uint8 [H, W] pairs → one flat uint8 buffer."""
    parts = []
    for left, right in left_right_frames:
        parts.append(np.ascontiguousarray(left, dtype=np.uint8).reshape(-1))
        parts.append(np.ascontiguousarray(right, dtype=np.uint8).reshape(-1))
    return np.concatenate(parts)


def constant_velocity_prediction(T_prev: torch.Tensor,
                                 T_prev2: torch.Tensor) -> torch.Tensor:
    """(T_prev · T_prev2⁻¹) · T_prev (Tracking.cc:967); ``inv_ex``, as
    ``jnp.linalg.inv``, checks nothing on the host."""
    return T_prev @ torch.linalg.inv_ex(T_prev2)[0] @ T_prev


def make_window_tracker(cfg: SlamConfig, window: int, device=None):
    """track_window(ms, flat_u8 [B·2·H·W], state_T [2, 4, 4], assoc0 [N],
    ref_kf) → WindowResult, with B = ``window``.

    It runs on ``device`` (``track_window.device``): the CUDA card unless
    the caller names another (``device="cpu"``), and raises where there is
    no card.  The map must lie on that device; the buffer and the start
    state may be numpy."""
    # as a tensor reports it ("cuda" → "cuda:0"), to compare with the map's
    dev = torch.empty(0, device=device_mod.resolve(device)).device
    fns = tracking.make_tracking_fns(cfg)
    frontend = frame_mod.make_frontend_stereo(cfg)
    H, W = cfg.camera.height, cfg.camera.width
    B = window

    def track_window(ms: M.MapState, flat_u8, state_T, assoc0,
                     ref_kf: int) -> WindowResult:
        if ms.mp_pos.device != dev:
            raise ValueError(f"track_window: the map is on "
                             f"{ms.mp_pos.device}, the tracker on {dev}")
        imgs = torch.as_tensor(flat_u8).to(dev).reshape(B, 2, H, W).to(
            torch.float32)
        sT = torch.as_tensor(state_T, dtype=torch.float32, device=dev)
        T_prev, T_prev2 = sT[0], sT[1]
        assoc = torch.as_tensor(assoc0, device=dev)
        vis = torch.zeros(ms.P, dtype=torch.int32, device=dev)
        fnd = torch.zeros_like(vis)
        summaries = []
        for i in range(B):
            fd = frontend(imgs[i, 0], imgs[i, 1])
            pred = constant_velocity_prediction(T_prev, T_prev2)
            res = fns.track(ms, fd, pred, assoc, assoc >= 0, ref_kf)
            vis = vis + res.visible_mask.to(torch.int32)
            fnd = fnd + res.found_mask.to(torch.int32)
            T_prev, T_prev2 = res.Tcw, T_prev
            assoc = res.assoc
            summaries.append(res.summary)
        return WindowResult(summaries=torch.stack(summaries),
                            state_T=torch.stack([T_prev, T_prev2]),
                            assoc=assoc, counters=torch.stack([vis, fnd]))

    track_window.device = dev
    return track_window
