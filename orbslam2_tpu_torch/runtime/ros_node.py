"""ROS image-transport adapters — the Test/Replay/ROS node equivalents
(ros_mono.cc / ros_stereo.cc / ros_rgbd.cc).

Port of ``orbslam2_tpu/runtime/ros_node.py``: the same decoding, bit for
bit (``decode_image_msg``), and the same four nodes over the port's
``System``.  The stereo node rectifies on the host through the port's
``ops/rectify.py``, its rectifier built on the System's device.

Layering: message DECODING and the per-frame callback path are plain
Python (testable without ROS; fake messages duck-type sensor_msgs/Image),
while TRANSPORT (rospy init, topic subscription, the stereo/RGBD
ApproximateTimeSynchronizer) binds only inside ``spin()``, so the module
imports cleanly on hosts without a ROS install and degrades with a clear
error only when asked to actually subscribe.

Parity map:
  RosMonoNode    ros_mono.cc:46-77   /camera/image_raw → TrackMonocular
  RosStereoNode  ros_stereo.cc:40-139 left/right sync, optional
                 do_rectify from the LEFT./RIGHT. settings blocks
                 (ros_stereo.cc:73-106 initUndistortRectifyMap)
  RosRgbdNode    ros_rgbd.cc         rgb+depth sync → TrackRGBD
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def decode_image_msg(msg) -> np.ndarray:
    """sensor_msgs/Image → [H, W] float32 grayscale (or [H, W] depth in
    native units for 16UC1/32FC1).  Mirrors cv_bridge's role
    (ros_mono.cc:62 cv_bridge::toCvShare) for the encodings the reference
    nodes consume."""
    enc = getattr(msg, "encoding", "mono8")
    h, w = int(msg.height), int(msg.width)
    buf = msg.data
    if isinstance(buf, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(buf, np.uint8)
    else:
        raw = np.asarray(buf, np.uint8)
    step = int(getattr(msg, "step", 0)) or None
    if enc in ("mono8", "8UC1"):
        row = step or w
        img = raw.reshape(h, row)[:, :w].astype(np.float32)
    elif enc in ("rgb8", "bgr8"):
        row = step or (3 * w)
        px = raw.reshape(h, row)[:, :3 * w].reshape(h, w, 3).astype(
            np.float32)
        if enc == "bgr8":
            px = px[..., ::-1]
        # BT.601, matching Tracking::GrabImage* cvtColor
        img = 0.299 * px[..., 0] + 0.587 * px[..., 1] + 0.114 * px[..., 2]
    elif enc in ("mono16", "16UC1"):
        row = step or (2 * w)
        img = raw.reshape(h, row)[:, :2 * w].view(np.uint16).reshape(
            h, w).astype(np.float32)
    elif enc == "32FC1":
        row = step or (4 * w)
        img = raw.reshape(h, row)[:, :4 * w].view(np.float32).reshape(h, w)
    else:
        raise ValueError(f"unsupported encoding {enc!r}")
    return img


def _stamp(msg) -> float:
    st = getattr(getattr(msg, "header", None), "stamp", None)
    if st is None:
        return 0.0
    try:
        return float(st.to_sec())
    except AttributeError:
        return float(getattr(st, "secs", 0)) + 1e-9 * float(
            getattr(st, "nsecs", 0))


class RosMonoNode:
    """ros_mono.cc: subscribe an image topic, feed TrackMonocular."""

    def __init__(self, system, topic: str = "/camera/image_raw"):
        self.system = system
        self.topic = topic

    def callback(self, msg) -> Optional[np.ndarray]:
        return self.system.track_monocular(decode_image_msg(msg),
                                           _stamp(msg))

    def spin(self):
        import rospy
        from sensor_msgs.msg import Image
        rospy.init_node("orbslam2_tpu_mono", anonymous=True)
        rospy.Subscriber(self.topic, Image, self.callback, queue_size=1)
        rospy.spin()


class RosStereoNode:
    """ros_stereo.cc: synchronized left/right subscription with optional
    rectification from the settings' LEFT./RIGHT. blocks."""

    def __init__(self, system, left_topic: str = "/camera/left/image_raw",
                 right_topic: str = "/camera/right/image_raw",
                 do_rectify: bool = False,
                 settings_file: Optional[str] = None):
        self.system = system
        self.left_topic = left_topic
        self.right_topic = right_topic
        self.rect = None
        if do_rectify:
            from orbslam2_tpu_torch.ops.rectify import load_rectification
            self.rect = load_rectification(
                settings_file, device=getattr(system, "device", None))
            if self.rect is None:
                raise ValueError(
                    "do_rectify=True but settings carry no LEFT./RIGHT. "
                    "blocks (ros_stereo.cc:78-92 aborts the same way)")

    def callback(self, msg_l, msg_r) -> Optional[np.ndarray]:
        left = decode_image_msg(msg_l)
        right = decode_image_msg(msg_r)
        if self.rect is not None:
            left, right = self.rect(left, right)
        return self.system.track_stereo(left, right, _stamp(msg_l))

    def spin(self):
        import message_filters
        import rospy
        from sensor_msgs.msg import Image
        rospy.init_node("orbslam2_tpu_stereo", anonymous=True)
        subs = [message_filters.Subscriber(self.left_topic, Image),
                message_filters.Subscriber(self.right_topic, Image)]
        sync = message_filters.ApproximateTimeSynchronizer(
            subs, queue_size=10, slop=0.1)       # ros_stereo.cc:133-135
        sync.registerCallback(self.callback)
        rospy.spin()


class RosRgbdNode:
    """ros_rgbd.cc: synchronized rgb + registered-depth subscription."""

    def __init__(self, system, rgb_topic: str = "/camera/rgb/image_raw",
                 depth_topic: str = "/camera/depth_registered/image_raw",
                 depth_factor: Optional[float] = None):
        self.system = system
        self.rgb_topic = rgb_topic
        self.depth_topic = depth_topic
        if depth_factor is None:
            depth_factor = getattr(system.cfg.camera, "depth_map_factor",
                                   1.0) or 1.0
        self.depth_factor = depth_factor

    def callback(self, msg_rgb, msg_d) -> Optional[np.ndarray]:
        gray = decode_image_msg(msg_rgb)
        depth = decode_image_msg(msg_d)
        if msg_d.encoding in ("mono16", "16UC1"):
            depth = depth / self.depth_factor
        return self.system.track_rgbd(gray, depth, _stamp(msg_rgb))

    def spin(self):
        import message_filters
        import rospy
        from sensor_msgs.msg import Image
        rospy.init_node("orbslam2_tpu_rgbd", anonymous=True)
        subs = [message_filters.Subscriber(self.rgb_topic, Image),
                message_filters.Subscriber(self.depth_topic, Image)]
        sync = message_filters.ApproximateTimeSynchronizer(
            subs, queue_size=10, slop=0.1)
        sync.registerCallback(self.callback)
        rospy.spin()


class RosMonoARNode:
    """ros_mono_ar.cc (Test/Replay/ROS/ORB_SLAM2/src/AR/ros_mono_ar.cc:
    1-169): monocular tracking + the AR demo — every tracked frame is
    rendered with the anchored virtual cubes (ViewerAR's role), and the
    two menu actions (Insert Cube / Clear All) anchor/drop cubes on
    RANSAC-detected map planes (utils/ar.ArDemo).

    ``callback`` returns the ANNOTATED frame (the reference hands the
    image + pose to ViewerAR; headless consumers read ``last_ar_frame``
    or an optional publisher hook).
    """

    def __init__(self, system, topic: str = "/camera/image_raw",
                 cube_size: float = 0.05, publish_fn=None):
        from orbslam2_tpu_torch.utils.ar import ArDemo
        self.system = system
        self.topic = topic
        self.demo = ArDemo(getattr(system, "engine", system),
                           cube_size=cube_size)
        self.publish_fn = publish_fn         # e.g. a rospy Publisher.publish
        self.last_ar_frame: Optional[np.ndarray] = None

    # menu actions (ViewerAR.cc:159-180)
    def insert_cube(self) -> bool:
        return self.demo.insert_cube()

    def clear_cubes(self) -> None:
        self.demo.clear()

    def callback(self, msg) -> Optional[np.ndarray]:
        gray = decode_image_msg(msg)
        Tcw = self.system.track_monocular(gray, _stamp(msg))
        out = self.demo.render(gray, Tcw)
        self.last_ar_frame = out
        if self.publish_fn is not None:
            self.publish_fn(out)
        return out

    def spin(self):
        import rospy
        from sensor_msgs.msg import Image
        rospy.init_node("orbslam2_tpu_mono_ar", anonymous=True)
        rospy.Subscriber(self.topic, Image, self.callback, queue_size=1)
        rospy.spin()
