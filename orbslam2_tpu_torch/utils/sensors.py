# Copy of orbslam2_tpu/utils/sensors.py (numpy only), but for the one import
# of the recorded-sequence backend, which reads through the port's
# utils/datasets.py: the JAX package imports jax on import, which the GPU
# host does not have.  tests/test_torch_copies.py holds it equal.
"""Sensor acquisition adapters: RealSense driver + UWB ranging stubs.

The reference ships a librealsense2-based camera driver
(Drivers/RealSense/realsense.{h,cc}: modalities RGBD/IRD/IRL/IRR/MULTI for
D435i + T265, frame alignment, timestamps, laser control) and links a
prebuilt UWB ranging library (UwbApi.h, consumed by Test/Live/UWB/uwb.cc).
TPU hosts have neither camera hardware nor the vendor libraries, so these
adapters keep the *interface* (the capability surface callers program
against) with a recorded-sequence backend; a hardware backend can be
plugged in by overriding `_grab`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from enum import Enum
from typing import Iterator, List, Optional, Tuple

import numpy as np


class Modality(Enum):
    """realsense.h:18 modalities."""

    RGBD = "rgbd"
    IRD = "ird"
    IRL = "irl"
    IRR = "irr"
    MULTI = "multi"


class RealSenseDevice:
    """Interface parity with Drivers/RealSense/realsense.h: start/stop,
    grab aligned frames with timestamps, laser control.  The default
    backend replays a recorded directory (color_*.png / depth_*.png or the
    TUM layout) — the same role as the reference's `realsense_replay`
    target."""

    def __init__(self, modality: Modality = Modality.IRD,
                 replay_dir: Optional[str] = None,
                 depth_factor: float = 1000.0, fps: float = 30.0):
        self.modality = modality
        self.replay_dir = replay_dir
        self.depth_factor = depth_factor
        self.fps = fps
        self.laser_on = True
        self._running = False
        self._it: Optional[Iterator] = None

    # lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.replay_dir is None:
            raise RuntimeError(
                "no camera hardware on a TPU host: construct with "
                "replay_dir= (recorded sequence) or subclass with a "
                "hardware backend")
        from orbslam2_tpu_torch.utils.datasets import iter_tum_rgbd
        self._it = iter_tum_rgbd(self.replay_dir, self.depth_factor)
        self._running = True

    def stop(self) -> None:
        self._running = False
        self._it = None

    def set_laser(self, on: bool) -> None:
        """realsense.h:96-132 laser control — recorded data ignores it."""
        self.laser_on = on

    # acquisition ---------------------------------------------------------
    def grab(self) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
        """(image, depth_m, timestamp) or None at end of stream."""
        if not self._running or self._it is None:
            return None
        try:
            return next(self._it)
        except StopIteration:
            self._running = False
            return None


@dataclass
class UwbNeighbor:
    """UwbApi.h neighbor-table row."""

    node_id: int
    distance_m: float
    timestamp: float


class UwbNode:
    """UwbApi.h surface (send/recv/neighbor table/multi_range_with) with a
    simulation backend: ranges are derived from ground-truth anchor
    positions + noise, which is what the SLAM+UWB fusion experiments in
    Test/Live/UWB/uwb.cc need for replay."""

    def __init__(self, node_id: int = 0,
                 anchors: Optional[dict] = None, noise_m: float = 0.05,
                 seed: int = 0):
        self.node_id = node_id
        self.anchors = anchors or {}
        self.noise = noise_m
        self._rng = np.random.default_rng(seed)
        self.neighbors: List[UwbNeighbor] = []

    def multi_range_with(self, position: np.ndarray,
                         node_ids: Optional[List[int]] = None
                         ) -> List[UwbNeighbor]:
        """Range against anchors from the given (true) position."""
        ids = node_ids if node_ids is not None else list(self.anchors)
        out = []
        now = time.time()
        for nid in ids:
            if nid not in self.anchors:
                continue
            d = float(np.linalg.norm(np.asarray(self.anchors[nid])
                                     - position))
            d += float(self._rng.normal(0.0, self.noise))
            out.append(UwbNeighbor(node_id=nid, distance_m=max(d, 0.0),
                                   timestamp=now))
        self.neighbors = out
        return out

    def neighbor_table(self) -> List[UwbNeighbor]:
        return list(self.neighbors)
