"""Replay driver: frames → System → trajectory, with per-frame timing.

Port of the synthetic part of ``orbslam2_tpu/tools/replay.py``
(``ReplayReport``, ``replay``, ``run_synthetic_stereo``: lines 25-80,
159-188), which mirrors the reference's Test/Replay drivers and logs
per-frame latency as Tools/Benchmarks/Replay/*/benchmark.cc does
(median and mean at exit).  The dataset drivers (KITTI, TUM, EuRoC, ISL,
RealSense IRD) wait for the copy of ``utils/datasets.py`` (ROADMAP
Queue 1, item 8).

A frame's time ends when its pose is on the host; a frame that returns
None (lost, or not initialized) ends in a synchronize of the engine's
card, so that it is not timed at its enqueue.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import STEREO
from orbslam2_tpu_torch.runtime.native import StageTimer
from orbslam2_tpu_torch.runtime.system import System


@dataclass
class ReplayReport:
    n_frames: int = 0
    n_tracked: int = 0
    durations_ms: List[float] = field(default_factory=list)

    @property
    def median_ms(self) -> float:
        return float(np.median(self.durations_ms)) if self.durations_ms \
            else 0.0

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.durations_ms)) if self.durations_ms \
            else 0.0

    def print_summary(self, label: str = "Track"):
        # benchmark.cc:110-115 prints the sorted median and the mean
        print(f"median {label} time: {self.median_ms:.2f} ms")
        print(f"mean {label} time: {self.mean_ms:.2f} ms")
        print(f"tracked {self.n_tracked}/{self.n_frames} frames")


def replay(system: System, frames: Iterable, kind: str,
           warmup: int = 2) -> ReplayReport:
    """Feed a frame iterator into a System.

    kind: "stereo" → (left, right, t); "rgbd"/"ird" → (img, depth, t);
    "mono" → (img, t).  The first ``warmup`` frames are tracked but not
    timed.  (JAX's ``pace`` and ``log_every`` come with the dataset
    drivers, their callers.)
    """
    rep = ReplayReport()
    timer = StageTimer()
    on_card = system.device.type == "cuda"
    for i, frame in enumerate(frames):
        t = frame[-1]
        timer.start()
        if kind == "stereo":
            out = system.track_stereo(frame[0], frame[1], t)
        elif kind in ("rgbd", "ird"):
            out = system.track_rgbd(frame[0], frame[1], t)
        else:
            out = system.track_monocular(frame[0], t)
        if out is None and on_card:
            torch.cuda.synchronize(system.device)
        ms = timer.stop()
        rep.n_frames += 1
        rep.n_tracked += out is not None
        if i >= warmup:
            rep.durations_ms.append(ms)
    return rep


def run_synthetic_stereo(n_frames: int = 40, seed: int = 0,
                         traj_out: Optional[str] = None,
                         device=None) -> ReplayReport:
    """Synthetic replay, the stand-in for the dataset drivers: the default
    capacity (``CapacityConfig()``: 512 keyframe slots, 32,768 points),
    1000 features, loop closing on, over a straight 0.25 m-a-frame walk
    through a sprite scene."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, SlamConfig)
    from orbslam2_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    cfg = SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(),
        sensor=STEREO)
    scene = synthetic.make_scene(rng, 900, extent=(14.0, 9.0, 40.0),
                                 z_near=3.0)
    poses = synthetic.straight_trajectory(n_frames, step=0.25)
    sys_ = System(None, None, sensor=STEREO, config=cfg, device=device)

    def frames():
        for i, T in enumerate(poses):
            left, right = synthetic.render_stereo(scene, cfg.camera, T, rng,
                                                  1.0)
            yield left, right, 0.1 * i

    rep = replay(sys_, frames(), "stereo")
    if traj_out:
        sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return rep

