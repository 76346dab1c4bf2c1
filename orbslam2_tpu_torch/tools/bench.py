"""The bench legs on the port: per-card frame rates of SLAM and LOC modes.

Port of ``bench.py``: the same configuration, world, walks and random
draws (one ``default_rng(0)``: the world, the 172 stereo frames, the 124
mono frames, then the 60 RGB-D frames), the same legs and the same JSON
keys, with the port's differences named under ``deviations``.

    python -m orbslam2_tpu_torch.tools.bench [--device cuda|cpu]
        [--ird-yaml REFERENCE/Config/RealSense-D435i-IRD.yaml]

It runs on the CUDA card (``--device cuda``, the default) and raises
where torch finds none; ``--device cpu`` runs on the CPU, where no
device time is measured.  Legs, each a function of a configuration, its
frame counts and a device (``chip_smoke.py`` phases 11, 12, 14 and 18
call them at cut depths):

  * stereo SLAM (``slam_leg``): ``WindowedSlamEngine(window=4)``, loop
    closing on, 28 warm-up frames, then 3 passes of 48, each ending in
    ``flush()`` and a synchronize;
  * stereo LOC (``loc_leg``): ``streaming.make_window_tracker(cfg, 8)``
    on the SLAM map, 24 windows a pass, 3 passes;
  * mono SLAM (``mono_leg``): 28 warm-up frames, 2 passes of 48;
  * RGB-D (``rgbd_leg``): 60 frames at 0.12 m, 12 warm-up, under the
    reference's YAML where ``--ird-yaml`` names it, else the bench camera
    with ``sensor=RGBD``;
  * oracle (``oracle_leg``): the SLAM leg's poses against the cv2-only
    proxy SLAM of ``tools/benchmarks/proxy_slam.py`` on the same frames;
  * scaling (``scaling_leg``): ``tools/scaling.measure_scaling`` on every
    local card, where there are two or more;
  * device time (``device_times``): one profiled call each of the LOC
    window tracker, the SLAM window tracker, the mapping step and the
    loop-detection step on the live state, after every timed pass.

The line before the last holds each leg's ATE and launches; the last
line is one JSON object.  A leg that raises, or that misses its bars
(stereo SLAM and RGB-D: no frame lost and an ATE bar; LOC: 30 map
inliers a frame), ends the run non-zero.  Keys are null, each with its
reason under ``null_reasons``, only where the reference YAML, cv2 or a
second card is missing, or where the mono engine ended LOST: its passes
then timed relocalization attempts, not tracking.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       MONOCULAR, OrbConfig, RGBD, STEREO,
                                       SlamConfig)
from orbslam2_tpu_torch.ops import hamming_top2 as ht2
from orbslam2_tpu_torch.runtime import streaming, tracking
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.tools.scale_demo import device_line
from orbslam2_tpu_torch.utils import render_pool, synthetic, trajectory

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CAMERA_RATE_FPS = 30.0  # fastest camera config in the reference repo
WINDOW = 8              # frames per LOC window
SLAM_WINDOW = 4         # frames per SLAM window
PROFILE_FRAME = 40      # bench.py's device-time payload frame
CV2_PROXY_ATE = 0.1127  # the cv2 proxy's ATE, first 76 frames (BENCH_r05)
RGBD_STEP = 0.12        # m between RGB-D frames
SCALING_KEYS = ("scaling_devices", "scaling_mode", "scaling_unsharded_ms",
                "scaling_sharded_ms", "scaling_efficiency_pct",
                "scaling_shapes")
DEVICE_KEYS = ("slam_device_ms_per_frame", "mapping_device_ms_per_kf",
               "detect_device_ms_per_kf", "slam_device_limit_fps",
               "loc_device_limit_fps")
ORACLE_KEYS = ("oracle_repo_ate_m", "oracle_cv2proxy_ate_m",
               "oracle_repo_beats_proxy")
IRD_KEYS = ("ird_yaml_fps", "ird_yaml_kf_per_frame", "ird_yaml_config")
RGBD_KEYS = ("rgbd_fps", "rgbd_kf_per_frame")
MONO_KEYS = ("mono_slam_fps", "mono_pass_fps", "mono_kf_per_frame")


class Depths(NamedTuple):
    """Frame counts of the legs; the defaults are bench.py's."""
    warmup: int = 28            # past the first keyframe-culling window
    measure: int = 48           # frames a timed pass
    slam_passes: int = 3
    loc_windows: int = 24       # LOC windows a pass
    loc_passes: int = 3
    mono_passes: int = 2
    rgbd_frames: int = 60
    rgbd_warmup: int = 12

    def lengths(self):
        """(stereo, mono, RGB-D) frames bench.py draws: 172, 124, 60."""
        return (self.warmup + self.slam_passes * self.measure,
                self.warmup + self.mono_passes * self.measure,
                self.rgbd_frames)

    def oracle_frames(self) -> int:
        """The span of bench.py's ATE: warm-up and one pass (76)."""
        return self.warmup + self.measure


DEPTHS = Depths()


def bench_config() -> SlamConfig:
    """``bench.py:86-100``: 640×480 stereo, 1000 ORB features, 128
    keyframes, 16k map points, local BA over 8 keyframes / 2048 points."""
    return SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=128, max_map_points=1 << 14,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=STEREO)


def rgbd_config(cfg: SlamConfig, ird_yaml: Optional[str] = None):
    """(config, True) of bench.py's RGB-D leg, the reference's
    ``RealSense-D435i-IRD.yaml`` at ``ird_yaml`` unchanged at ``cfg``'s
    capacity; without one, (the bench camera with ``sensor=RGBD``,
    False).  The reference checkout is not part of this repository."""
    if ird_yaml:
        return (SlamConfig.from_yaml(ird_yaml, sensor=RGBD).replace(
            capacity=cfg.capacity), True)
    return cfg.replace(sensor=RGBD), False


def stereo_poses(n: int):
    return synthetic.straight_trajectory(n, step=0.25)


def mono_poses(n: int):
    """Sideways-dominant: the mono bootstrap needs parallax."""
    return [synthetic.look_ahead_pose(np.array([0.18 * i, 0.0, 0.04 * i]))
            for i in range(n)]


def rgbd_poses(n: int):
    return synthetic.straight_trajectory(n, step=RGBD_STEP)


class BenchFrames(NamedTuple):
    stereo: List            # (left, right) float32 [H, W]
    mono: List              # float32 [H, W]
    rgbd: List              # (gray, depth) float32 [H, W]
    stereo_gt: List         # Tcw of each frame
    mono_gt: List
    rgbd_gt: List


def bench_frames(cfg: SlamConfig, depths: Depths = DEPTHS,
                 counts: Optional[Sequence[int]] = None,
                 rgbd_camera: Optional[CameraConfig] = None) -> BenchFrames:
    """bench.py's frames, bit for bit, rendered on host threads.

    One generator draws, in bench.py's order, the world, then the noise
    of the ``depths.lengths()`` stereo, mono and RGB-D frames.  ``counts``
    (default: those lengths; none larger) says how many of each walk to
    return: the first ones are rendered, the noise of the rest is drawn
    and dropped.  The RGB-D frames are seen by ``rgbd_camera`` (default:
    ``cfg``'s)."""
    lengths = depths.lengths()
    counts = lengths if counts is None else tuple(counts)
    if any(n > length for n, length in zip(counts, lengths)):
        raise ValueError(f"bench_frames: counts {counts} past bench.py's "
                         f"walks {lengths}")
    walks = (
        (stereo_poses, synthetic.render_world_stereo, 2, {}),
        (mono_poses, synthetic.render_world, 1, {}),
        (rgbd_poses, synthetic.render_world, 1, {"with_depth": True}))
    cams = (cfg.camera, cfg.camera, rgbd_camera or cfg.camera)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    frames, gts = [], []
    for (poses, render, images, kw), n, length, cam in zip(
            walks, counts, lengths, cams):
        gts.append(poses(n))
        frames.append(render_pool.render_frames(render, world, cam, gts[-1],
                                                rng, images=images, **kw))
        for _ in range(images * (length - n)):
            rng.normal(0.0, 1.0, (cam.height, cam.width))
    return BenchFrames(*frames, *gts)


# ------------------------------------------------------------- helpers --
def ate(poses_est, poses_gt) -> float:
    """RMSE of camera centres, no alignment (stereo and RGB-D have
    metric scale), over the frames with an estimate; nan if none."""
    errs = [np.sum((-Te[:3, :3].T @ Te[:3, 3]
                    + Tg[:3, :3].T @ Tg[:3, 3]) ** 2)
            for Te, Tg in zip(poses_est, poses_gt) if Te is not None]
    return float(np.sqrt(np.mean(errs))) if errs else float("nan")


def mono_ate(eng, poses_gt):
    """Similarity-aligned ATE (mono has no scale) over the frames that
    have a trajectory entry, from the one that initialized on, and their
    count; nan under three frames."""
    entries = eng.trajectory
    pairs = [(Te, Tg) for Te, Tg, e in zip(
        eng.frame_poses(), poses_gt[len(poses_gt) - len(entries):], entries)
        if Te is not None and not e.lost]
    if len(pairs) < 3:
        return float("nan"), len(pairs)
    est = trajectory.centers_from_poses([Te for Te, _ in pairs])
    gt = trajectory.centers_from_poses([Tg for _, Tg in pairs])
    return trajectory.ate_rmse(est, gt, align=True, with_scale=True), \
        len(pairs)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> Dict[str, int]:
    return dict(ht2.hamming_top2.launches_by_site)


def device_events(prof):
    """(name, device µs) of every device event of a finished profile, from
    the raw kineto events: ``prof.events()`` first builds a tree over all
    of a window's events, CPU ones included, which takes longer than the
    window itself."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_hidden_event()]


def profiled(fn):
    """(CUDA kernels launched, their summed device ms, wall ms,
    ``cudaStreamSynchronize`` calls) of one call of ``fn`` under
    torch.profiler; the profiler's own cost is in the wall time, so
    compare device ms with an unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [us for _, us in device_events(prof)]
    syncs = sum(e.name() == "cudaStreamSynchronize"
                for e in prof.profiler.kineto_results.events())
    return len(kernels), sum(kernels) / 1e3, wall_ms, syncs


def _passes(track, start, measure, passes, eng, dev):
    """Timed passes of ``measure`` frames from ``start``, each ending in
    ``flush()`` and a synchronize: (fps per pass, keyframes per pass)."""
    pass_fps, kf_counts = [], []
    for _ in range(passes):
        kf0 = eng.stats["kf_inserted"]
        t0 = time.perf_counter()
        for i in range(start, start + measure):
            track(i)
        eng.flush()
        _sync(dev)
        pass_fps.append(measure / (time.perf_counter() - t0))
        kf_counts.append(eng.stats["kf_inserted"] - kf0)
        start += measure
    return pass_fps, kf_counts


# ---------------------------------------------------------------- legs --
def slam_leg(cfg: SlamConfig, frames, poses_gt, depths: Depths = DEPTHS,
             device=None, log: Callable[[str], None] = print) -> Dict:
    """bench.py:102-123: ``WindowedSlamEngine(window=4)``, loop closing
    on, ``depths.warmup`` frames, then ``depths.slam_passes`` passes of
    ``depths.measure``.  ``hamming_top2`` launches are counted from the
    engine's first frame."""
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, device=device,
                             window=SLAM_WINDOW)
    dev = eng.device
    ht2.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(depths.warmup):
        eng.track_stereo(*frames[i], 0.1 * i)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    pass_fps, kf_counts = _passes(
        lambda i: eng.track_stereo(*frames[i], 0.1 * i), depths.warmup,
        depths.measure, depths.slam_passes, eng, dev)
    launches = _launches()
    n = depths.warmup + depths.slam_passes * depths.measure
    n_o = depths.oracle_frames()
    est = eng.frame_poses()
    res = {
        "engine": eng, "frames": n, "warm_s": warm_s, "pass_fps": pass_fps,
        "fps": float(np.median(pass_fps)), "kf_counts": kf_counts,
        "kf_per_frame": float(np.median(kf_counts)) / depths.measure,
        "n_lost": sum(T is None for T in est),
        "ate_m": ate(est[:n_o], poses_gt[:n_o]),
        "ate_all_m": ate(est, poses_gt[:n]), "launches": launches}
    fps = res["fps"]
    log(f"[bench-slam] {n} frames (warm-up {depths.warmup} frames "
        f"{warm_s:.1f} s): pass fps {[round(f, 3) for f in pass_fps]}, "
        f"median {fps:.3f} fps = {1e3 / fps:.1f} ms/frame, KFs per frame "
        f"{res['kf_per_frame']:.4f} (per pass {kf_counts}), KFs inserted "
        f"{eng.stats['kf_inserted']}, live {eng.n_kfs}, loops closed "
        f"{eng.stats['loops_closed']}, lost {res['n_lost']}, ATE "
        f"{res['ate_m']:.4f} m over bench.py's first {n_o} frames (cv2 "
        f"proxy {CV2_PROXY_ATE}), {res['ate_all_m']:.4f} m over all; "
        f"hamming_top2 launches by path {launches}")
    return res


def loc_leg(eng: WindowedSlamEngine, frames, poses_gt,
            depths: Depths = DEPTHS,
            log: Callable[[str], None] = print) -> Dict:
    """bench.py:160-190: ``make_window_tracker(cfg, 8)`` on the SLAM
    engine's map over frames ``depths.warmup`` .. +8, ``depths.loc_windows``
    windows a pass (each a host buffer uploaded, as bench.py's
    ``device_put``), ``depths.loc_passes`` passes.  Every window starts
    from the SLAM estimate of the two frames before and the map points of
    the last one's reference keyframe; bench.py chains its windows over
    the one repeated buffer, which sends the tracker 1.75 m back at every
    boundary.  A first, untimed window gives the ATE and the inliers."""
    first = depths.warmup
    dev = eng.device
    track = streaming.make_window_tracker(eng.cfg, WINDOW, device=dev)
    est = eng.frame_poses()
    ref = eng.trajectory[first - 1].ref_kf
    state_T = torch.as_tensor(np.stack([est[first - 1], est[first - 2]]),
                              dtype=torch.float32, device=dev)
    assoc0 = eng.ms.kf_mp[ref]
    flat = streaming.pack_window_uint8(frames[first:first + WINDOW])
    sm = track(eng.ms, flat, state_T, assoc0, ref).summaries.cpu().numpy()
    ht2.reset_launch_counts()
    rates, worst = [], []
    for _ in range(depths.loc_passes):
        t0 = time.perf_counter()
        for _ in range(depths.loc_windows):
            s = track(eng.ms, flat, state_T, assoc0, ref).summaries.cpu()
            worst.append(int(s[:, 34].min()))
        rates.append(WINDOW * depths.loc_windows
                     / (time.perf_counter() - t0))
    launches = _launches()
    fps = float(np.median(rates))
    err = ate([sm[i, :16].reshape(4, 4) for i in range(WINDOW)],
              poses_gt[first:first + WINDOW])
    log(f"[bench-loc] {depths.loc_windows} windows of {WINDOW} a pass: pass "
        f"fps {[round(f, 3) for f in rates]}, median {fps:.3f} fps = "
        f"{1e3 / fps:.1f} ms/frame; map inliers per frame "
        f"{sm[:, 34].astype(int).tolist()} (fewest in any window "
        f"{min(worst)}), ATE {err:.4f} m over the window; hamming_top2 "
        f"launches {launches}")
    return {"tracker": track, "flat": flat, "state_T": state_T,
            "assoc0": assoc0, "ref": ref, "pass_fps": rates, "fps": fps,
            "inliers": sm[:, 34].astype(int).tolist(),
            "fewest_inliers": min(worst), "ate_m": err, "launches": launches}


def mono_leg(cfg: SlamConfig, frames, poses_gt, depths: Depths = DEPTHS,
             device=None, log: Callable[[str], None] = print) -> Dict:
    """bench.py:199-231: ``WindowedSlamEngine(MONOCULAR, window=4)``,
    loop closing on, ``depths.warmup`` frames, then ``depths.mono_passes``
    passes of ``depths.measure``; keyframes a frame as bench.py counts
    them (inserted over all frames)."""
    cfg = cfg.replace(sensor=MONOCULAR)
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, device=device,
                             window=SLAM_WINDOW)
    dev = eng.device
    ht2.reset_launch_counts()
    for i in range(depths.warmup):
        eng.track_monocular(frames[i], 0.1 * i)
    _sync(dev)
    pass_fps, kf_counts = _passes(
        lambda i: eng.track_monocular(frames[i], 0.1 * i), depths.warmup,
        depths.measure, depths.mono_passes, eng, dev)
    launches = _launches()
    n = depths.warmup + depths.mono_passes * depths.measure
    err, n_tracked = mono_ate(eng, poses_gt[:n])
    fps = float(np.median(pass_fps))
    res = {"engine": eng, "frames": n, "pass_fps": pass_fps, "fps": fps,
           "kf_counts": kf_counts,
           "kf_per_frame": eng.stats["kf_inserted"] / n, "ate_m": err,
           "n_tracked": n_tracked, "state": eng.state,
           "relocalized": eng.stats["reloc"], "launches": launches}
    log(f"[bench-mono] {n} frames: pass fps "
        f"{[round(f, 3) for f in pass_fps]}, median {fps:.3f} fps = "
        f"{1e3 / fps:.1f} ms/frame, KFs per frame "
        f"{res['kf_per_frame']:.4f} (as bench.py: inserted over all {n}; "
        f"per pass {kf_counts}), live KFs {eng.n_kfs}, loops closed "
        f"{eng.stats['loops_closed']}, relocalized {eng.stats['reloc']}, "
        f"tracked {n_tracked}, state {eng.state}, similarity-aligned ATE "
        f"{err:.4f} m; hamming_top2 launches by path {launches}")
    return res


def rgbd_leg(cfg: SlamConfig, frames, poses_gt, depths: Depths = DEPTHS,
             device=None, log: Callable[[str], None] = print) -> Dict:
    """bench.py:233-262 (an RGB-D ``cfg``): ``WindowedSlamEngine(window=
    4)``, loop closing on, ``depths.rgbd_frames`` frames at 30 fps
    timestamps, ``depths.rgbd_warmup`` of them warm-up, the rest timed to
    a ``flush()`` and a synchronize; keyframes a frame over all frames."""
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, device=device,
                             window=SLAM_WINDOW)
    dev = eng.device
    n, warm = depths.rgbd_frames, depths.rgbd_warmup
    ht2.reset_launch_counts()
    for i in range(warm):
        eng.track_rgbd(*frames[i], i / 30.0)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(warm, n):
        eng.track_rgbd(*frames[i], i / 30.0)
    eng.flush()
    _sync(dev)
    fps = (n - warm) / (time.perf_counter() - t0)
    launches = _launches()
    est = eng.frame_poses()
    res = {"engine": eng, "fps": fps,
           "kf_per_frame": eng.stats["kf_inserted"] / n,
           "n_lost": sum(T is None for T in est),
           "ate_m": ate(est, poses_gt[:n]), "launches": launches}
    log(f"[bench-rgbd] {n} frames at {RGBD_STEP} m, {warm} warm-up: "
        f"{fps:.3f} fps = "
        f"{1e3 / fps:.1f} ms/frame over {n - warm} frames, KFs per frame "
        f"{res['kf_per_frame']:.4f} (as bench.py: inserted over all {n}), "
        f"live KFs {eng.n_kfs}, lost {res['n_lost']}, ATE "
        f"{res['ate_m']:.4f} m; hamming_top2 launches by path {launches}")
    return res


# ---------------------------------------------------------------- bars --
RGBD_ATE_BAR = 0.15     # m, the RGB-D leg's ATE bar


def check_slam(res: Dict) -> None:
    """The stereo SLAM leg's bars: no frame lost, ATE over bench.py's
    oracle span under the cv2 proxy's."""
    if res["n_lost"] or not res["ate_m"] < CV2_PROXY_ATE:
        raise AssertionError(f"bench-slam: lost {res['n_lost']}, ATE "
                             f"{res['ate_m']} (need < {CV2_PROXY_ATE})")


def check_loc(res: Dict, cfg: SlamConfig) -> None:
    """The LOC leg's bars: every frame of every window tracks at least
    the local-map threshold (30) of map inliers; ATE over the first
    window under the cv2 proxy's."""
    if res["fewest_inliers"] < cfg.tracking.local_map_tracking_threshold:
        raise AssertionError(f"bench-loc: a frame tracked only "
                             f"{res['fewest_inliers']} map inliers")
    if not res["ate_m"] < CV2_PROXY_ATE:
        raise AssertionError(f"bench-loc: ATE {res['ate_m']} m")


def check_rgbd(res: Dict) -> None:
    """The RGB-D leg's bars: no frame lost, ATE under 0.15 m."""
    if res["n_lost"] or not res["ate_m"] < RGBD_ATE_BAR:
        raise AssertionError(f"bench-rgbd: lost {res['n_lost']}, ATE "
                             f"{res['ate_m']} (need < {RGBD_ATE_BAR})")


def mono_leg_keys(mono: Dict, frames: int):
    """The mono leg's keys and null reasons: bench.py's rates and
    keyframes a frame, or, where the engine ended LOST, None with the
    reason (its passes then timed relocalization attempts, not
    tracking)."""
    if mono["state"] != tracking.LOST:
        return {"mono_slam_fps": mono["fps"],
                "mono_pass_fps": mono["pass_fps"],
                "mono_kf_per_frame": mono["kf_per_frame"]}, {}
    reason = (f"the mono engine ended LOST: {mono['n_tracked']} of {frames} "
              f"frames tracked, {mono['relocalized']} relocalized; its "
              f"passes timed relocalization attempts (pass fps "
              f"{mono['pass_fps']}, keyframes a frame "
              f"{mono['kf_per_frame']})")
    return dict.fromkeys(MONO_KEYS), dict.fromkeys(MONO_KEYS, reason)


def rgbd_leg_keys(rgbd: Dict, from_yaml: bool):
    """The RGB-D leg's keys and null reasons: bench.py's ``ird_yaml_*``
    where the reference YAML ran, else the port's ``rgbd_*``."""
    if from_yaml:
        keys = {"ird_yaml_fps": rgbd["fps"],
                "ird_yaml_kf_per_frame": rgbd["kf_per_frame"],
                "ird_yaml_config": "RealSense-D435i-IRD.yaml (unchanged)",
                **dict.fromkeys(RGBD_KEYS)}
        return keys, dict.fromkeys(
            RGBD_KEYS, "the reference YAML ran under ird_yaml_*")
    keys = {"rgbd_fps": rgbd["fps"], "rgbd_kf_per_frame": rgbd["kf_per_frame"],
            **dict.fromkeys(IRD_KEYS)}
    return keys, dict.fromkeys(
        IRD_KEYS, "no reference RealSense-D435i-IRD.yaml given (--ird-yaml):"
                  " its leg ran as rgbd_* on the bench camera with "
                  "sensor=RGBD")


def _proxy_slam():
    """``tools/benchmarks/proxy_slam.py`` (cv2 and numpy only), loaded from
    its file: that folder is no package."""
    path = os.path.join(REPO, "tools", "benchmarks", "proxy_slam.py")
    spec = importlib.util.spec_from_file_location("proxy_slam", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_leg(cfg: SlamConfig, slam_poses, frames, poses_gt, n: int):
    """bench.py:266-296: ATE of the SLAM leg's poses and of the cv2-only
    proxy SLAM's on the first ``n`` uint8 frames.  Returns (keys, null
    reasons): where cv2 does not import, the keys are None."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        reason = f"cv2 does not import ({e}): no proxy SLAM"
        return dict.fromkeys(ORACLE_KEYS), dict.fromkeys(ORACLE_KEYS, reason)
    repo_ate = ate(slam_poses[:n], poses_gt[:n])
    u8 = [(left.astype(np.uint8), right.astype(np.uint8))
          for left, right in frames[:n]]
    proxy_ate = ate(_proxy_slam().run_proxy_slam(u8, cfg.camera),
                    poses_gt[:n])
    return {"oracle_repo_ate_m": repo_ate, "oracle_cv2proxy_ate_m": proxy_ate,
            "oracle_repo_beats_proxy": bool(repo_ate <= proxy_ate)}, {}


def scaling_leg(dev: torch.device):
    """bench.py:298-305 through the port's ``tools/scaling.py`` on every
    local card, where there are two or more.  Returns (keys, null
    reasons)."""
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        from orbslam2_tpu_torch.tools.scaling import measure_scaling

        return measure_scaling(), {}
    reason = (f"{torch.cuda.device_count()} CUDA device(s): scaling needs "
              f"two or more" if dev.type == "cuda"
              else "a CPU run: scaling is measured across cards")
    return dict.fromkeys(SCALING_KEYS), dict.fromkeys(SCALING_KEYS, reason)


def device_times(slam: Dict, loc: Dict, frames) -> Dict:
    """bench.py:125-158, 191-196 by ``torch.profiler`` on the card: the
    summed kernel device time of one call each, on the live state, of the
    LOC window tracker, then (``WindowedSlamEngine.stereo_steps``) the
    SLAM window tracker (bench.py's payload: frame 40's pair four
    times), the mapping step on that window's first frame and the
    loop-detection step on the reference keyframe.  No step adopts its
    result, so each reads the map the timed passes left."""
    eng = slam["engine"]
    _, dev_l, _, _ = profiled(lambda: loc["tracker"](
        eng.ms, loc["flat"], loc["state_T"], loc["assoc0"],
        loc["ref"]).summaries.cpu())
    window, mapping, detect = eng.stereo_steps(*frames[PROFILE_FRAME])
    _, dev_w, _, _ = profiled(window)
    _, dev_m, _, _ = profiled(mapping)
    _, dev_d, _, _ = profiled(detect)
    per_frame_ms = (dev_w / SLAM_WINDOW
                    + slam["kf_per_frame"] * (dev_m + dev_d))
    return {"slam_device_ms_per_frame": dev_w / SLAM_WINDOW,
            "mapping_device_ms_per_kf": dev_m,
            "detect_device_ms_per_kf": dev_d,
            "slam_device_limit_fps": 1e3 / per_frame_ms,
            "loc_device_limit_fps": 1e3 * WINDOW / dev_l}


def reference_fps():
    """(fps, source) of the baseline: the measured cv2 proxy of the
    reference (tools/benchmarks/reference_proxy.json), else the camera
    rate (bench.py:58-65)."""
    p = os.path.join(REPO, "tools", "benchmarks", "reference_proxy.json")
    try:
        with open(p) as f:
            return float(json.load(f)["value"]), "measured cv2 proxy"
    except (OSError, ValueError, KeyError):
        return CAMERA_RATE_FPS, "camera-rate claim"


# ----------------------------------------------------------------- run --
def run(device="cuda", cfg: Optional[SlamConfig] = None,
        depths: Depths = DEPTHS,
        log: Callable[[str], None] = print,
        ird_yaml: Optional[str] = None) -> Dict:
    """Every leg at ``depths`` (bench.py's by default), then the device
    times; returns bench.py's JSON keys and the port's (module
    docstring).  ``device`` is the card unless it is ``"cpu"``;
    ``ird_yaml`` is the reference's RGB-D settings file, if any."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: --device cuda and torch finds no CUDA "
                           "device; pass --device cpu to run on the CPU")
    t_run = time.perf_counter()
    smi = device_line(dev)

    def say(s):
        log(f"{s} ({smi})")

    say(f"[bench] torch {torch.__version__}")
    if dev.type == "cuda":
        from orbslam2_tpu_torch.kernels import build

        t0 = time.perf_counter()
        build.load("hamming_top2")
        say(f"[bench] hamming_top2 kernel built and loaded before the timed "
            f"legs in {time.perf_counter() - t0:.2f} s")
    cfg = cfg or bench_config()
    cfg_rgbd, from_yaml = rgbd_config(cfg, ird_yaml)
    t0 = time.perf_counter()
    fr = bench_frames(cfg, depths, rgbd_camera=cfg_rgbd.camera)
    say(f"[bench] rendered {depths.lengths()} stereo, mono and RGB-D frames "
        f"in {time.perf_counter() - t0:.1f} s")

    slam = slam_leg(cfg, fr.stereo, fr.stereo_gt, depths, dev, say)
    check_slam(slam)
    loc = loc_leg(slam["engine"], fr.stereo, fr.stereo_gt, depths, say)
    check_loc(loc, cfg)
    mono = mono_leg(cfg, fr.mono, fr.mono_gt, depths, dev, say)
    del mono["engine"]
    rgbd = rgbd_leg(cfg_rgbd, fr.rgbd, fr.rgbd_gt, depths, dev, say)
    del rgbd["engine"]
    check_rgbd(rgbd)
    reasons: Dict[str, str] = {}
    mono_keys, why = mono_leg_keys(mono, depths.lengths()[1])
    reasons.update(why)
    oracle, why = oracle_leg(cfg, slam["engine"].frame_poses(), fr.stereo,
                             fr.stereo_gt, depths.oracle_frames())
    reasons.update(why)
    scaling, why = scaling_leg(dev)
    reasons.update(why)
    # every profiled call after every timed pass: a profiler session
    # slowed the same process's later calls (PERF.md §7)
    if dev.type == "cuda":
        dev_keys = device_times(slam, loc, fr.stereo)
    else:
        dev_keys = dict.fromkeys(DEVICE_KEYS)
        reasons.update(dict.fromkeys(
            DEVICE_KEYS, "a CPU run: no device time is measured"))
    rgbd_keys, why = rgbd_leg_keys(rgbd, from_yaml)
    reasons.update(why)

    ref_fps, ref_src = reference_fps()
    fps, loc_fps = slam["fps"], loc["fps"]
    out = {
        "metric": "slam_mode_fps_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / ref_fps,
        "headline_is": f"median of {depths.slam_passes} passes",
        "baseline_fps": ref_fps,
        "baseline_source": ref_src,
        "slam_kf_per_frame": slam["kf_per_frame"],
        "slam_pass_fps": slam["pass_fps"],
        "slam_best_fps": max(slam["pass_fps"]),
        "loc_mode_fps": loc_fps,
        "loc_pass_fps": loc["pass_fps"],
        "loc_vs_baseline": loc_fps / ref_fps,
        "vs_camera_rate": fps / CAMERA_RATE_FPS,
        **dev_keys,
        **mono_keys, **rgbd_keys, **oracle, **scaling,
        "hamming_top2_launches": {
            "slam": slam["launches"], "loc": loc["launches"],
            "mono": mono["launches"], "rgbd": rgbd["launches"]},
        "device": smi,
        "deviations": deviations(from_yaml),
        "null_reasons": reasons,
    }
    say(f"[bench] {time.perf_counter() - t_run:.1f} s in all; ATE: stereo "
        f"SLAM {slam['ate_m']:.4f} m over the first "
        f"{depths.oracle_frames()} frames ({slam['ate_all_m']:.4f} over "
        f"all), LOC {loc['ate_m']:.4f} m over its window, mono "
        f"{mono['ate_m']:.4f} m similarity-aligned, RGB-D "
        f"{rgbd['ate_m']:.4f} m; hamming_top2 launches by leg "
        f"{out['hamming_top2_launches']}")
    return out


def deviations(from_yaml: bool) -> List[str]:
    """Each way the port's run differs from bench.py's, in a few words."""
    out = [
        "no prewarm(): the port compiles nothing ahead",
        "LOC: every window starts from the SLAM estimate of frames 27 and "
        "26 (bench.py chains its windows over one repeated buffer of "
        "frames 28-35, 1.75 m back at each boundary)",
        "device-time keys (slam_device_ms_per_frame, "
        "mapping_device_ms_per_kf, detect_device_ms_per_kf, "
        "slam_device_limit_fps, loc_device_limit_fps): the summed kernel "
        "time of one torch.profiler call each after the timed passes, not "
        "K-chained TPU programs",
        "no *_error keys (device_time_error, mono_error, ird_yaml_error, "
        "oracle_error): a leg that raises ends the run non-zero",
        "scaling_* from orbslam2_tpu_torch.tools.scaling over every local "
        "card, null on one",
        "oracle: null where cv2 does not import",
        "numbers unrounded",
        "a leg past its bar (check_slam, check_loc, check_rgbd: a frame "
        "lost, an ATE over its bar, a LOC frame under 30 map inliers) "
        "ends the run non-zero",
        "mono_slam_fps, mono_pass_fps, mono_kf_per_frame: null with the "
        "reason where the mono engine ended LOST (its passes timed "
        "relocalization attempts)",
    ]
    if not from_yaml:
        out.append("RGB-D: no reference YAML given (--ird-yaml): the bench "
                   "camera with sensor=RGBD over bench.py's 60 frames at "
                   "0.12 m under rgbd_fps, rgbd_kf_per_frame; ird_yaml_* "
                   "null")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m orbslam2_tpu_torch.tools.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--ird-yaml", default=None, metavar="PATH",
                    help="the reference's Config/RealSense-D435i-IRD.yaml: "
                         "bench.py's ird_yaml_* leg; without it the RGB-D "
                         "leg runs the bench camera with sensor=RGBD")
    a = ap.parse_args(argv)
    out = run(a.device, log=lambda s: print(s, flush=True),
              ird_yaml=a.ird_yaml)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
