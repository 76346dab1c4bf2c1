"""Live-stream node: callback-driven System feeding.

Port of ``orbslam2_tpu/runtime/stream_node.py``.  The reference's live
entry points are ROS nodes subscribing to image topics
(Test/Replay/ROS/ORB_SLAM2/src/ros_mono.cc:46-77, ros_stereo.cc,
ros_rgbd.cc) and webcam/RealSense loops (Test/Live/*).  This module is the
transport-agnostic equivalent: a node object with ``on_image`` callbacks
that any source (ROS bridge, GStreamer, RealSenseDevice, a socket) can
drive, plus a pull-driven loop for device-style sources.  Frames go
through a bounded native queue with drop-oldest backpressure (live
sources must never block the producer).

The node's worker thread calls ``System.track_*``, which makes the frame's
tensors on that thread, from the numpy arrays pushed.  On the card a
thread that enters no stream issues on the default stream, as the thread
that built the System did, so the engine's state needs no handoff between
the two.  An exception on the worker ends it and is raised by ``stop()``
(the JAX worker dies silently).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from orbslam2_tpu_torch.runtime.native import TokenQueue
from orbslam2_tpu_torch.runtime.system import System


class StreamNode:
    """Subscribe-style wrapper: push frames in, poses come out via
    ``on_pose`` (the ROS node's publish step)."""

    def __init__(self, system: System,
                 on_pose: Optional[Callable] = None,
                 queue_capacity: int = 4):
        self.system = system
        self.on_pose = on_pose
        self._q = TokenQueue(queue_capacity)
        self._payloads = {}
        self._tok = 0
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self.error: Optional[BaseException] = None
        self.dropped = 0
        self.processed = 0

    # ----------------------------------------------------------- lifecycle
    def start(self):
        self._running = True
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="stream-node")
        self._worker.start()

    def stop(self, timeout: float = 60.0):
        """Close the queue, let the worker drain it, and join it; raise the
        worker's exception if it had one, or if it is still running after
        ``timeout`` seconds."""
        self._running = False
        self._q.close()
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                raise RuntimeError(f"stream node: the worker is still "
                                   f"running after {timeout} s")
        if self.error is not None:
            raise RuntimeError("stream node: the worker failed") \
                from self.error

    # ------------------------------------------------------------ callbacks
    def on_image_mono(self, image: np.ndarray, timestamp: float):
        self._enqueue(("mono", image, None, timestamp))

    def on_image_stereo(self, left: np.ndarray, right: np.ndarray,
                        timestamp: float):
        self._enqueue(("stereo", left, right, timestamp))

    def on_image_rgbd(self, image: np.ndarray, depth: np.ndarray,
                      timestamp: float):
        self._enqueue(("rgbd", image, depth, timestamp))

    def _enqueue(self, payload):
        with self._lock:
            tok = self._tok
            self._tok += 1
            self._payloads[tok] = payload
        if self._q.push_latest(tok):
            self.dropped += 1   # live backpressure: drop the oldest frame

    # ---------------------------------------------------------------- loop
    def _loop(self):
        try:
            self._run()
        except Exception as e:              # kept for stop() to raise
            self.error = e

    def _run(self):
        while True:
            tok = self._q.pop(timeout_ms=200)
            if tok is None:
                if not self._running:
                    return
                continue
            with self._lock:
                payload = self._payloads.pop(tok, None)
                # purge payloads whose tokens were dropped from the queue
                stale = [t for t in self._payloads if t < tok]
                for t in stale:
                    self._payloads.pop(t, None)
            if payload is None:
                continue
            kind, a, b, t = payload
            if kind == "mono":
                out = self.system.track_monocular(a, t)
            elif kind == "stereo":
                out = self.system.track_stereo(a, b, t)
            else:
                out = self.system.track_rgbd(a, b, t)
            self.processed += 1
            if self.on_pose is not None:
                self.on_pose(out, t)


def run_device_loop(system: System, device, node: Optional[StreamNode] = None,
                    max_frames: Optional[int] = None) -> int:
    """Pull-driven loop for grab()-style sources (RealSenseDevice / webcams)
    — the Test/Live driver shape.  ``device`` is the frame source, not a
    torch device.  Returns frames processed."""
    n = 0
    while max_frames is None or n < max_frames:
        frame = device.grab()
        if frame is None:
            break
        img, depth, t = frame
        if node is not None:
            node.on_image_rgbd(img, depth, t)
        else:
            system.track_rgbd(img, depth, t)
        n += 1
    return n
