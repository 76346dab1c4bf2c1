"""Live drivers (Test/Live/* equivalents) over the port's ``System``.

Port of ``tools/live/live.py``:

  mono      — mono_camera.cc: webcam/video → TrackMonocular at source
              rate, trajectory saved on exit
  ird       — Live/IRD/realsense.cc: RealSense IRD (or recorded-stream
              adapter) → TrackRGBD, map save enabled
  multicam  — Multicam/multicam.cc: D435i frames drive SLAM while the
              T265's own odometry is recorded alongside; BOTH
              trajectories are saved for cross-validation
              (multicam.cc:53-100)
  uwb       — UWB/uwb.cc: SLAM position + UWB multi-ranging fused log
  uwb_bias  — UWB/uwb_bias.cc: the ranging bias against known distances

Sources are device ids, video paths, or callables (``tools/grab/grab.py``
conventions; this module keeps its own copy of ``open_source``, so that
nothing it imports lies outside the package), so every driver runs
against recorded streams when no hardware is present.  Each driver builds
its ``System`` on ``device``: the CUDA card unless another is named
(``device="cpu"``, ``--device cpu``)::

    python -m orbslam2_tpu_torch.tools.live mono SOURCE SETTINGS
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from orbslam2_tpu_torch.config import MONOCULAR, RGBD
from orbslam2_tpu_torch.runtime.system import System


# open_source and its helper: a copy of tools/grab/grab.py's, which the
# JAX drivers reach through a sys.path insert
def _cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        return None


def open_source(src) -> Callable[[], Optional[Tuple[np.ndarray, float]]]:
    """Normalize a frame source to a nullary callable → (frame, t)|None."""
    if callable(src):
        return src
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("cv2 unavailable and source is not a callable")
    cap = cv2.VideoCapture(int(src) if str(src).isdigit() else src)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open capture source {src!r}")

    def read():
        ok, frame = cap.read()
        if not ok:
            return None
        t = cap.get(cv2.CAP_PROP_POS_MSEC) / 1e3 or time.time()
        if frame.ndim == 3:
            frame = frame.mean(axis=-1)
        return frame.astype(np.float32), t

    return read


def run_mono_live(src, settings: Optional[str],
                  traj_out: str = "CameraTrajectory.txt",
                  max_frames: Optional[int] = None, device=None) -> int:
    """mono_camera.cc loop: capture → TrackMonocular."""
    sys_ = System(None, settings, sensor=MONOCULAR, device=device)
    read = open_source(src)
    n = 0
    while max_frames is None or n < max_frames:
        out = read()
        if out is None:
            break
        frame, t = out
        sys_.track_monocular(frame, t)
        n += 1
    sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return n


def run_ird_live(ird_source, settings: Optional[str],
                 traj_out: str = "CameraTrajectory.txt",
                 max_frames: Optional[int] = None,
                 save_map: bool = True, device=None) -> int:
    """Live/IRD/realsense.cc loop: (ir, depth, t) triplets → TrackRGBD.
    ``ird_source``: callable → (ir, depth, t)|None, or a RealSenseDevice
    (utils/sensors) whose grab() has that contract."""
    sys_ = System(None, settings, sensor=RGBD, save_map=save_map,
                  device=device)
    grab = getattr(ird_source, "grab", ird_source)
    n = 0
    while max_frames is None or n < max_frames:
        out = grab()
        if out is None:
            break
        ir, depth, t = out
        sys_.track_rgbd(ir, depth, t)
        n += 1
    sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return n


def run_multicam(ird_source, odom_source, settings: Optional[str],
                 slam_traj_out: str = "CameraTrajectory_D435i.txt",
                 odom_traj_out: str = "CameraTrajectory_T265.txt",
                 max_frames: Optional[int] = None, device=None) -> int:
    """multicam.cc: the D435i IRD stream drives SLAM; the T265's built-in
    odometry poses are logged alongside so the two trajectories can be
    cross-validated offline (multicam.cc:92-100 saves both)."""
    sys_ = System(None, settings, sensor=RGBD, device=device)
    grab = getattr(ird_source, "grab", ird_source)
    odom: List = []
    n = 0
    while max_frames is None or n < max_frames:
        out = grab()
        if out is None:
            break
        ir, depth, t = out
        sys_.track_rgbd(ir, depth, t)
        pose = odom_source()
        if pose is not None:
            odom.append((t, np.asarray(pose)))
        n += 1
    sys_.save_trajectory_tum(slam_traj_out)
    from orbslam2_tpu_torch.utils import trajectory as traj_mod
    traj_mod.save_tum(odom_traj_out, [t for t, _ in odom],
                      [T for _, T in odom])
    sys_.shutdown()
    return n


def run_uwb(ird_source, settings: Optional[str], anchors: dict,
            log_out: str = "uwb_fusion.txt",
            max_frames: Optional[int] = None, device=None) -> int:
    """UWB/uwb.cc: per frame, SLAM position + UWB multi-ranging to the
    anchor set (dict id → [3] position), logged for offline fusion
    (uwb.cc:40-52)."""
    from orbslam2_tpu_torch.utils.sensors import UwbNode

    sys_ = System(None, settings, sensor=RGBD, device=device)
    node = UwbNode(node_id=0, anchors=anchors)
    grab = getattr(ird_source, "grab", ird_source)
    n = 0
    with open(log_out, "w") as f:
        while max_frames is None or n < max_frames:
            out = grab()
            if out is None:
                break
            ir, depth, t = out
            Tcw = sys_.track_rgbd(ir, depth, t)
            if Tcw is not None:
                pos = -Tcw[:3, :3].T @ Tcw[:3, 3]
                ranges = node.multi_range_with(pos)
                f.write(f"{t:.6f} " + " ".join(f"{p:.4f}" for p in pos)
                        + " " + " ".join(f"{r.distance_m:.4f}"
                                         for r in ranges) + "\n")
            n += 1
    sys_.shutdown()
    return n


def run_uwb_bias(uwb_node, target_id: int, true_distances_cm,
                 n_measurements: int = 400, reject_above_cm: float = 800.0,
                 out=None):
    """UWB/uwb_bias.cc (Test/Live/UWB/uwb_bias.cc): bias characterization
    — for each known ground-truth distance, collect ``n_measurements``
    valid readings from the target node (readings ≥ reject_above_cm are
    discarded, :36-40), average them, and emit (true_cm, measured_cm)
    pairs for offline bias fitting (matlab/uwbIntegration.m consumes
    these).

    ``true_distances_cm``: iterable of ground-truth distances; the
    reference reads them interactively (cin >> distance, -1 stops).
    Returns the list of (true_cm, average_measured_cm).
    """
    rows = []
    for true_cm in true_distances_cm:
        if true_cm == -1:                        # interactive stop token
            break
        # place the node true_cm away from the target anchor along x
        anchor = np.asarray(uwb_node.anchors[target_id], np.float64)
        pos = anchor + np.array([true_cm / 100.0, 0.0, 0.0])
        readings = []
        while len(readings) < n_measurements:
            for r in uwb_node.multi_range_with(pos):
                if r.node_id != target_id:
                    continue
                cm = r.distance_m * 100.0
                if cm < reject_above_cm:         # uwb_bias.cc:36
                    readings.append(cm)
        avg = float(np.mean(readings[:n_measurements]))
        rows.append((true_cm, avg))
        if out is not None:
            out.write(f"{true_cm} {avg:.2f}\n")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "orbslam2_tpu_torch.tools.live")
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("mono")
    m.add_argument("source")
    m.add_argument("settings", nargs="?", default=None)
    m.add_argument("--out", default="CameraTrajectory.txt")
    m.add_argument("--max-frames", type=int, default=None)
    m.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    i = sub.add_parser("ird")
    i.add_argument("replay_dir", help="recorded RealSense sequence dir")
    i.add_argument("settings", nargs="?", default=None)
    i.add_argument("--out", default="CameraTrajectory.txt")
    i.add_argument("--max-frames", type=int, default=None)
    i.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    if a.cmd == "mono":
        n = run_mono_live(a.source, a.settings, a.out, a.max_frames,
                          device=a.device)
    else:
        from orbslam2_tpu_torch.utils.sensors import (Modality,
                                                      RealSenseDevice)
        dev = RealSenseDevice(Modality.IRD, replay_dir=a.replay_dir)
        dev.start()
        n = run_ird_live(dev, a.settings, a.out, a.max_frames,
                         device=a.device)
    print(f"processed {n} frames")


if __name__ == "__main__":
    main()
