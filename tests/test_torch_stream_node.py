"""The port's StreamNode (``runtime/stream_node.py``): the JAX package's
cases (tests/test_stream_node.py) on the port — callback feeding and
drop-oldest backpressure — plus what only the port does: a worker's
exception raised by ``stop()``, and ``run_device_loop`` through a node
into a real ``System`` on the CPU."""

import time

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, RGBD, SlamConfig)
from orbslam2_tpu_torch.runtime.stream_node import StreamNode, run_device_loop
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.utils import synthetic

torch.set_num_threads(2)


class FakeSystem:
    def __init__(self, delay=0.0, fail_at=None):
        self.frames = []
        self.delay = delay
        self.fail_at = fail_at

    def track_monocular(self, img, t):
        if self.delay:
            time.sleep(self.delay)
        if t == self.fail_at:
            raise ValueError("tracking failed")
        self.frames.append(t)
        return np.eye(4)

    track_stereo = None
    track_rgbd = None


def test_stream_node_processes_all_when_fast():
    sysm = FakeSystem()
    poses = []
    node = StreamNode(sysm, on_pose=lambda p, t: poses.append(t))
    node.start()
    for i in range(10):
        node.on_image_mono(np.zeros((4, 4)), float(i))
        time.sleep(0.01)
    time.sleep(0.3)
    node.stop()
    assert node.processed == 10
    assert poses == [float(i) for i in range(10)]
    assert node.dropped == 0


def test_stream_node_drops_under_backpressure():
    sysm = FakeSystem(delay=0.05)
    node = StreamNode(sysm, queue_capacity=2)
    node.start()
    for i in range(30):
        node.on_image_mono(np.zeros((4, 4)), float(i))
    time.sleep(1.2)
    node.stop()
    # slow consumer: most frames dropped, newest ones processed
    assert node.dropped > 0
    assert node.processed < 30
    assert sysm.frames[-1] == 29.0  # the latest frame survived
    assert node.processed + node.dropped == 30


def test_worker_error_is_raised_by_stop():
    node = StreamNode(FakeSystem(fail_at=2.0))
    node.start()
    for i in range(5):
        node.on_image_mono(np.zeros((4, 4)), float(i))
        time.sleep(0.02)
    with pytest.raises(RuntimeError, match="worker failed") as exc:
        node.stop(timeout=10.0)
    assert isinstance(exc.value.__cause__, ValueError)
    assert not node._worker.is_alive()
    assert node.processed == 2


def test_device_loop_through_a_node_tracks_rgbd_on_cpu():
    """RGB-D frames pulled from a grab() source and pushed through a node
    (each only after the previous pose came out) into a System on the CPU:
    every frame tracked on the worker thread."""
    cam = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                       width=320, height=240, fps=10.0, th_depth=60.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=200),
                     capacity=CapacityConfig(max_keyframes=8,
                                             max_map_points=2048,
                                             local_ba_keyframes=4,
                                             local_ba_points=512),
                     sensor=RGBD)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    frames = [synthetic.render_world(world, cam, T, rng, 1.0,
                                     with_depth=True)
              for T in synthetic.straight_trajectory(5, step=0.3)]
    sysm = System(None, None, RGBD, config=cfg, device="cpu")
    poses = []
    node = StreamNode(sysm, on_pose=lambda p, t: poses.append(p))
    node.start()

    class Source:
        i = 0

        def grab(self):
            if self.i >= len(frames):
                return None
            deadline = time.time() + 60.0
            while len(poses) < self.i and time.time() < deadline:
                time.sleep(0.01)
            g, d = frames[self.i]
            self.i += 1
            return np.clip(g, 0, 255).astype(np.uint8), d, 0.1 * self.i

    assert run_device_loop(sysm, Source(), node=node) == len(frames)
    deadline = time.time() + 60.0
    while len(poses) < len(frames) and time.time() < deadline:
        time.sleep(0.01)
    node.stop()
    assert node.processed == len(frames) and node.dropped == 0
    assert all(p is not None and p.shape == (4, 4) for p in poses)
    assert sysm.engine.stats["kf_inserted"] >= 1
