"""Replay drivers: dataset → System → trajectory, with per-frame timing.

Port of ``orbslam2_tpu/tools/replay.py``, which mirrors the reference's
Test/Replay drivers (mono_tum.cc, stereo_kitti.cc, stereo_euroc.cc,
rgbd_tum.cc, mono_kitti.cc, mono_euroc.cc, stereo_isl.cc, IRD
realsense.cc, QRCode qrCode.cc; SURVEY.md §2.3): load a sequence
(``utils/datasets.py``), feed frames (optionally paced to their
timestamps), log per-frame latency as Tools/Benchmarks/Replay/*/
benchmark.cc does ("``... duration: N ms``", median and mean at exit),
and save the trajectory for offline ATE.  Each driver builds the port's
``System`` on ``device``: the CUDA card unless another is named
(``device="cpu"``).

A frame's time ends when its pose is on the host; a frame that returns
None (lost, or not initialized) ends in a synchronize of the engine's
card, so that it is not timed at its enqueue.  Loading, decoding and
rectifying a frame fall outside its time, as in the JAX package.

The command line has one subcommand per script of the JAX package's
``tools/replay/`` (the same names, arguments and flags, plus
``--device``)::

    python -m orbslam2_tpu_torch.tools.replay stereo_kitti SEQ SETTINGS
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import MONOCULAR, RGBD, STEREO
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
           pace: bool = False, warmup: int = 2,
           log_every: int = 0) -> ReplayReport:
    """Feed a frame iterator into a System.

    kind: "stereo" → (left, right, t); "rgbd"/"ird" → (img, depth, t);
    "mono" → (img, t).  The first ``warmup`` frames are tracked but not
    timed.  ``pace`` sleeps out the gap to the next timestamp (gaps of
    0-2 s); ``log_every`` prints every n-th frame's ms to stderr.
    """
    rep = ReplayReport()
    timer = StageTimer()
    on_card = system.device.type == "cuda"
    t_prev = None
    for i, frame in enumerate(frames):
        t = frame[-1]
        if pace and t_prev is not None:
            dt = t - t_prev
            if 0 < dt < 2.0:
                time.sleep(dt)
        t_prev = t

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
        if log_every and i % log_every == 0:
            # per-frame line, benchmark.cc:88 style
            print(f"SLAM.Track duration: {ms:.1f} ms", file=sys.stderr)
    return rep


def _take(it, n):
    for i, x in enumerate(it):
        if i >= n:
            return
        yield x


def run_kitti_stereo(seq_dir: str, settings: Optional[str],
                     traj_out: Optional[str] = None,
                     max_frames: Optional[int] = None,
                     pace: bool = False, device=None) -> ReplayReport:
    from orbslam2_tpu_torch.utils.datasets import iter_kitti_stereo
    sys_ = System(None, settings, sensor=STEREO, device=device)
    frames = iter_kitti_stereo(seq_dir)
    if max_frames:
        frames = _take(frames, max_frames)
    rep = replay(sys_, frames, "stereo", pace=pace)
    if traj_out:
        sys_.save_trajectory_kitti(traj_out)
    sys_.shutdown()
    return rep


def run_tum_rgbd(seq_dir: str, settings: Optional[str],
                 traj_out: Optional[str] = None,
                 max_frames: Optional[int] = None,
                 pace: bool = False, device=None) -> ReplayReport:
    from orbslam2_tpu_torch.utils.datasets import iter_tum_rgbd
    sys_ = System(None, settings, sensor=RGBD, device=device)
    frames = iter_tum_rgbd(seq_dir)
    if max_frames:
        frames = _take(frames, max_frames)
    rep = replay(sys_, frames, "rgbd", pace=pace)
    if traj_out:
        sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return rep


def run_tum_mono(seq_dir: str, settings: Optional[str],
                 traj_out: Optional[str] = None,
                 max_frames: Optional[int] = None,
                 pace: bool = False, device=None) -> ReplayReport:
    from orbslam2_tpu_torch.utils.datasets import iter_tum_rgbd
    sys_ = System(None, settings, sensor=MONOCULAR, device=device)
    frames = ((rgb, t) for rgb, _d, t in iter_tum_rgbd(seq_dir))
    if max_frames:
        frames = _take(frames, max_frames)
    rep = replay(sys_, frames, "mono", pace=pace)
    if traj_out:
        sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return rep


def run_euroc_stereo(mav_dir: str, settings: Optional[str],
                     timestamp_file: Optional[str] = None,
                     traj_out: Optional[str] = None,
                     max_frames: Optional[int] = None,
                     pace: bool = False, device=None) -> ReplayReport:
    from orbslam2_tpu_torch.ops.rectify import load_rectification
    from orbslam2_tpu_torch.utils.datasets import iter_euroc_stereo
    sys_ = System(None, settings, sensor=STEREO, device=device)
    frames = iter_euroc_stereo(mav_dir, timestamp_file)
    if max_frames:
        frames = _take(frames, max_frames)
    # stereo rectification from the LEFT./RIGHT. blocks, on the host as
    # the JAX driver does (the reference remaps every frame,
    # stereo_euroc.cc:72-100,165); without it EuRoC's unrectified pairs
    # cannot run row-banded stereo
    rect = load_rectification(settings, device=device) if settings else None
    if rect is not None:
        def _rectified(it):
            for left, right, t in it:
                rl, rr = rect(left, right)
                yield rl, rr, t
        frames = _rectified(frames)
    rep = replay(sys_, frames, "stereo", pace=pace)
    if traj_out:
        sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return rep


def run_synthetic_stereo(n_frames: int = 40, seed: int = 0,
                         traj_out: Optional[str] = None,
                         device=None) -> ReplayReport:
    """Synthetic replay: the default capacity (``CapacityConfig()``: 512
    keyframe slots, 32,768 points), 1000 features, loop closing on, over
    a straight 0.25 m-a-frame walk through a sprite scene."""
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


def run_kitti_mono(seq_dir: str, settings: Optional[str],
                   traj_out: Optional[str] = None,
                   max_frames: Optional[int] = None,
                   pace: bool = False, device=None) -> ReplayReport:
    """mono_kitti.cc: KITTI image_0 as a monocular sequence."""
    from orbslam2_tpu_torch.utils.datasets import iter_kitti_stereo
    sys_ = System(None, settings, sensor=MONOCULAR, device=device)
    frames = ((left, t) for left, _r, t in iter_kitti_stereo(seq_dir))
    if max_frames:
        frames = _take(frames, max_frames)
    rep = replay(sys_, frames, "mono", pace=pace)
    if traj_out:
        sys_.save_keyframe_trajectory_tum(traj_out)   # mono_kitti.cc:138
    sys_.shutdown()
    return rep


def run_euroc_mono(mav_dir: str, settings: Optional[str],
                   timestamp_file: Optional[str] = None,
                   traj_out: Optional[str] = None,
                   max_frames: Optional[int] = None,
                   pace: bool = False, device=None) -> ReplayReport:
    """mono_euroc.cc: EuRoC cam0 as a monocular sequence."""
    from orbslam2_tpu_torch.utils.datasets import iter_euroc_stereo
    sys_ = System(None, settings, sensor=MONOCULAR, device=device)
    frames = ((left, t) for left, _r, t in iter_euroc_stereo(
        mav_dir, timestamp_file))
    if max_frames:
        frames = _take(frames, max_frames)
    rep = replay(sys_, frames, "mono", pace=pace)
    if traj_out:
        sys_.save_keyframe_trajectory_tum(traj_out)   # mono_euroc.cc:119
    sys_.shutdown()
    return rep


def run_isl_stereo(left_dir: str, right_dir: str, times_file: str,
                   settings: Optional[str],
                   traj_out: Optional[str] = None,
                   max_frames: Optional[int] = None,
                   device=None) -> ReplayReport:
    """stereo_isl.cc: custom ISL stereo layout with replayer=true — the
    frame clock waits out a running GBA instead of racing it
    (System.cc:169-183; ctor at stereo_isl.cc:76)."""
    from orbslam2_tpu_torch.utils.datasets import iter_isl_stereo
    sys_ = System(None, settings, sensor=STEREO, replayer=True,
                  device=device)
    frames = iter_isl_stereo(left_dir, right_dir, times_file)
    if max_frames:
        frames = _take(frames, max_frames)
    rep = replay(sys_, frames, "stereo")
    if traj_out:
        sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return rep


def run_ird_realsense(sequence_dir: str, settings: Optional[str],
                      traj_out: Optional[str] = None,
                      max_frames: Optional[int] = None,
                      depth_extension: str = "png",
                      save_map: bool = True, device=None) -> ReplayReport:
    """Test/Replay/IRD/realsense.cc: recorded RealSense IR+depth sequence
    through the RGBD entry, with map save enabled (realsense.cc:94).  A
    settings file without ``DepthMapFactor`` parses as 1.0, so its depth
    is read in raw units, as in the JAX package (ROADMAP, "JAX behaviours
    the port mirrors")."""
    from orbslam2_tpu_torch.utils.datasets import iter_ird_realsense
    sys_ = System(None, settings, sensor=RGBD, save_map=save_map,
                  device=device)
    cfg = sys_.cfg
    frames = iter_ird_realsense(sequence_dir, depth_extension,
                                cfg.camera.depth_map_factor or 1000.0)
    if max_frames:
        frames = _take(frames, max_frames)
    rep = replay(sys_, frames, "ird")
    if traj_out:
        sys_.save_trajectory_tum(traj_out)
    sys_.shutdown()
    return rep


def run_qrcode_replay(image_paths, out_file: str = "QRCodes.txt"):
    """Test/Replay/QRCode/qrCode.cc: detect/decode QR codes per frame,
    accumulate the landmark list, save QRCodes.txt (a host tool: no
    System, no device)."""
    from orbslam2_tpu_torch.utils.markers import QrCodeTracker

    tracker = QrCodeTracker()
    if not tracker.available:
        print("cv2 QRCodeDetector unavailable; no-op", file=sys.stderr)
        return tracker
    from orbslam2_tpu_torch.utils.datasets import _imread_gray
    for p in image_paths:
        img = _imread_gray(p) if isinstance(p, str) else p
        tracker.track(img, None)
    tracker.save(out_file)
    return tracker


# ------------------------------------------------------------ command line
def _parser() -> argparse.ArgumentParser:
    """One subcommand per script of the JAX package's tools/replay/, with
    its positional arguments and flags, plus --device."""
    ap = argparse.ArgumentParser(prog="python -m "
                                 "orbslam2_tpu_torch.tools.replay")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, positional, out, label, pace=True, timestamps=False):
        p = sub.add_parser(name)
        p.set_defaults(label=label)
        for arg in positional:
            p.add_argument(arg)
        p.add_argument("settings", nargs="?", default=None)
        if timestamps:
            p.add_argument("--timestamps", default=None)
        p.add_argument("--out", default=out)
        p.add_argument("--max-frames", type=int, default=None)
        if pace:
            p.add_argument("--pace", action="store_true")
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")
        return p

    cam, kf = "CameraTrajectory.txt", "KeyFrameTrajectory.txt"
    st, rgbd, mono = "TrackStereo", "TrackRGBD", "TrackMonocular"
    add("stereo_kitti", ["sequence_dir"], cam, st)
    add("rgbd_tum", ["sequence_dir"], cam, rgbd)
    add("mono_tum", ["sequence_dir"], kf, mono)
    add("stereo_euroc", ["mav_dir"], cam, st, timestamps=True)
    add("mono_kitti", ["seq_dir"], kf, mono)
    add("mono_euroc", ["mav_dir"], kf, mono, timestamps=True)
    add("stereo_isl", ["left_dir", "right_dir", "times_file"], cam, st,
        pace=False)
    ird = add("ird_realsense", ["sequence_dir"], cam, rgbd, pace=False)
    ird.add_argument("--depth-ext", default="png")
    ird.add_argument("--no-save-map", action="store_true")
    qr = sub.add_parser("qrcode_replay")
    qr.add_argument("images", nargs="+")
    qr.add_argument("--out", default="QRCodes.txt")
    return ap


def main(argv=None):
    a = _parser().parse_args(argv)
    if a.cmd == "qrcode_replay":
        tracker = run_qrcode_replay(a.images, a.out)
        for m in getattr(tracker, "codes", []):
            print(m)
        return
    dev = a.device
    runs = {
        "stereo_kitti": lambda: run_kitti_stereo(
            a.sequence_dir, a.settings, a.out, a.max_frames, a.pace,
            device=dev),
        "rgbd_tum": lambda: run_tum_rgbd(
            a.sequence_dir, a.settings, a.out, a.max_frames, a.pace,
            device=dev),
        "mono_tum": lambda: run_tum_mono(
            a.sequence_dir, a.settings, a.out, a.max_frames, a.pace,
            device=dev),
        "stereo_euroc": lambda: run_euroc_stereo(
            a.mav_dir, a.settings, a.timestamps, a.out, a.max_frames,
            a.pace, device=dev),
        "mono_kitti": lambda: run_kitti_mono(
            a.seq_dir, a.settings, a.out, a.max_frames, a.pace, device=dev),
        "mono_euroc": lambda: run_euroc_mono(
            a.mav_dir, a.settings, a.timestamps, a.out, a.max_frames,
            a.pace, device=dev),
        "stereo_isl": lambda: run_isl_stereo(
            a.left_dir, a.right_dir, a.times_file, a.settings, a.out,
            a.max_frames, device=dev),
        "ird_realsense": lambda: run_ird_realsense(
            a.sequence_dir, a.settings, a.out, a.max_frames, a.depth_ext,
            save_map=not a.no_save_map, device=dev),
    }
    runs[a.cmd]().print_summary(a.label)


if __name__ == "__main__":
    main()
