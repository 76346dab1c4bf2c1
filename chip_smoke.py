"""Run the PyTorch/CUDA port's stereo SLAM main path once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device    — card name and power limit, torch and CUDA versions;
  2. build     — compile every hand-written kernel from the checkout;
  3. kernels   — each kernel against its plain PyTorch version on the
                 card, bit-exact, at the main path's shapes and edge
                 cases, and their median times from CUDA events;
  4. slice     — SlamEngine(STEREO, loop closing off) over 40 frames of
                 the bench scene at 640×480, 1000 features, 128 keyframes,
                 16k map points, with a one-frame camera shake that makes
                 the engine take TrackReferenceKeyFrame (the path that
                 reaches hamming_top2); never lost, ≥ 3 keyframes, ATE <
                 0.15 m, ≥ 300 live map points, and every kernel of the
                 path launched by this run;
  5. live call — the engine's TrackReferenceKeyFrame step on the live map,
                 held against the same call with the matcher's plain
                 version.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# tolerance of every kernel-vs-plain comparison: integer outputs, exact
MAX_ABS_ERR = 0

N_FRAMES = 40
# A one-frame camera shake (a yaw jolt, as a handheld or vehicle-mounted
# rig meets): the motion model mispredicts there and on the frames after,
# so the engine falls back to TrackReferenceKeyFrame on its main path.
SHAKE_FRAME, SHAKE_YAW = 20, 0.12


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device (torch.cuda."
                           "is_available() is False); it does not run on "
                           "the CPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)
    return smi


def phase_build():
    from orbslam2_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load("hamming_top2")
    dt = time.perf_counter() - t0
    print(f"[build] hamming_top2.cu → {build.library_path('hamming_top2')} "
          f"in {dt:.2f} s", flush=True)


def _cuda_ms(fn, reps=200, warmup=10):
    """Mean ms per call over ``reps`` back-to-back calls, from CUDA events
    (the wrapper's host cost included, as the main path pays it)."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernels(smi):
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     hamming_top2_reference)

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def words(n):
        return torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8),
                                             dtype=np.uint32).view(np.int32)
                                ).to(dev)

    def mask(n, p=0.9):
        return torch.from_numpy(rng.random(n) < p).to(dev)

    cases = {}
    for A, B in [(1024, 1024), (600, 512), (256, 300), (1024, 16384)]:
        cases[f"{A}x{B}"] = (words(A), mask(A), words(B), mask(B))
    a, av, b, bv = words(64), mask(64), words(700), mask(700)
    av[:3] = False
    cases["all-invalid rows"] = (a, av, b, bv)
    cases["all-invalid bank"] = (a, mask(64), b,
                                 torch.zeros(700, dtype=torch.bool,
                                             device=dev))
    cases["B=1"] = (a, mask(64), words(1), torch.ones(1, dtype=torch.bool,
                                                      device=dev))
    # ties: the bank holds each of 40 descriptors three times, and the
    # queries are copies of bank rows, so best and second tie at 0
    base = words(40)
    tie_bank = torch.cat([base, base, base])
    cases["duplicated descriptors"] = (
        tie_bank[torch.from_numpy(rng.permutation(120)[:50]).to(dev)
                 ].contiguous(),
        mask(50, 1.0), tie_bank, mask(120, 1.0))

    max_err = 0
    for name, (a, av, b, bv) in cases.items():
        got = hamming_top2(a, av, b, bv)
        ref = hamming_top2_reference(a, av, b, bv)
        torch.cuda.synchronize()
        err = max(int(torch.max(torch.abs(g.long() - r.long())))
                  for g, r in zip(got, ref))
        max_err = max(max_err, err)
        if err > MAX_ABS_ERR:
            raise AssertionError(f"hamming_top2 vs plain at {name}: max "
                                 f"|diff| {err}")
        print(f"[kernels] hamming_top2 {name}: bit-exact vs plain "
              f"(A={a.shape[0]}, B={b.shape[0]})", flush=True)
    a, av, b, bv = cases["1024x1024"]
    ms = _cuda_ms(lambda: hamming_top2(a, av, b, bv))
    plain_ms = _cuda_ms(lambda: hamming_top2_reference(a, av, b, bv))
    print(f"[kernels] hamming_top2 1024x1024 per call: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms ({smi})", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def bench_config():
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, STEREO, SlamConfig)
    return SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=128, max_map_points=1 << 14,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=STEREO)


def ate(poses_est, poses_gt):
    errs = [np.sum((-Te[:3, :3].T @ Te[:3, 3]
                    + Tg[:3, :3].T @ Tg[:3, 3]) ** 2)
            for Te, Tg in zip(poses_est, poses_gt) if Te is not None]
    return float(np.sqrt(np.mean(errs)))


def shaken_trajectory():
    """The bench corridor walk, with the camera yawed at SHAKE_FRAME."""
    from orbslam2_tpu_torch.utils import synthetic

    poses = synthetic.straight_trajectory(N_FRAMES, step=0.25)
    c, s = np.cos(SHAKE_YAW), np.sin(SHAKE_YAW)
    yaw = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                   poses[0].dtype)
    poses[SHAKE_FRAME] = yaw @ poses[SHAKE_FRAME]   # camera centre unmoved
    return poses


def _timed(fn, log):
    """``fn`` timed to its end on the card (ms appended to ``log``)."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.append(1e3 * (time.perf_counter() - t0))
        return out
    return run


def phase_slice(smi):
    from orbslam2_tpu_torch.ops.hamming_top2 import hamming_top2
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cfg = bench_config()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses_gt = shaken_trajectory()
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses_gt]
    eng = SlamEngine(cfg, enable_loop_closing=False, device="cuda")
    # per-layer wall ms, each call ended by a synchronize
    layers = {"frontend": [], "track_body": [], "track_ref_kf": [],
              "track (fallback re-run)": [], "mapping_step": []}
    fns = eng.fns
    eng.frontend = _timed(eng.frontend, layers["frontend"])
    eng.fns = fns._replace(
        track_body=_timed(fns.track_body, layers["track_body"]),
        track_ref_kf=_timed(fns.track_ref_kf, layers["track_ref_kf"]),
        track=_timed(fns.track, layers["track (fallback re-run)"]))
    eng.f_mapping_step = _timed(eng.f_mapping_step, layers["mapping_step"])

    hamming_top2.launches = 0          # the main path's count starts here
    frame_ms = []
    t_start = time.perf_counter()
    for i, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        Tcw = eng.track_stereo(left, right, 0.1 * i)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        if eng.state != tracking.OK or Tcw is None:
            raise AssertionError(f"slice: lost at frame {i} "
                                 f"(state {eng.state})")
        if Tcw.shape != (4, 4) or not np.all(np.isfinite(Tcw)):
            raise AssertionError(f"slice: bad pose at frame {i}: {Tcw}")
    total_s = time.perf_counter() - t_start
    engine_launches = hamming_top2.launches
    eng.fns = fns
    err = ate(eng.frame_poses(), poses_gt)
    n_pts = len(eng.map_points())
    n_kf = eng.stats["kf_inserted"]
    print(f"[slice] {N_FRAMES} frames: {N_FRAMES / total_s:.2f} fps "
          f"(first frame incl.), median {np.median(frame_ms):.1f} ms/frame, "
          f"median after frame 0 {np.median(frame_ms[1:]):.1f} ms, "
          f"KFs inserted {n_kf}, live map points {n_pts}, ATE {err:.4f} m, "
          f"hamming_top2 launches {engine_launches} ({smi})", flush=True)
    for name, ms in layers.items():
        if ms:
            print(f"[slice] layer {name}: {len(ms)} calls, median "
                  f"{np.median(ms):.1f} ms, total {np.sum(ms):.0f} ms",
                  flush=True)
    if n_kf < 3 or not err < 0.15 or n_pts < 300:
        raise AssertionError(f"slice: KFs {n_kf}, ATE {err}, points {n_pts}"
                             f" (need ≥3, <0.15 m, ≥300)")
    if engine_launches < 1:
        raise AssertionError("slice: the main path never launched the "
                             "hamming_top2 kernel")
    return eng, engine_launches


def phase_live_call(eng, engine_launches):
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.ops import matching
    from orbslam2_tpu_torch.runtime import tracking

    Tcw = torch.as_tensor(eng.last_Tcw, device=eng.device)
    before = ht2.hamming_top2.launches
    res = eng.fns.track_ref_kf(eng.ms, eng.last_fd, eng.ref_kf, Tcw)
    phase_launches = ht2.hamming_top2.launches - before
    if phase_launches < 1:
        raise AssertionError("TrackReferenceKeyFrame did not launch the "
                             "hamming_top2 kernel")
    # the same call with the matcher's top-2 pass run by the plain version
    matching.hamming_top2 = ht2.hamming_top2_reference
    try:
        res_plain = eng.fns.track_ref_kf(eng.ms, eng.last_fd, eng.ref_kf,
                                         Tcw)
    finally:
        matching.hamming_top2 = ht2.hamming_top2
    same = torch.equal(res.assoc, res_plain.assoc)
    sm = tracking.Summary.of(res)
    print(f"[live] TrackReferenceKeyFrame on the live map (ref KF "
          f"{eng.ref_kf}): {sm.n_matches_mm} matches, {sm.n_inliers_map} "
          f"inliers; hamming_top2 launches: engine run {engine_launches}, "
          f"this call {phase_launches}; matches equal to the plain "
          f"version: {same}", flush=True)
    if not same:
        raise AssertionError("track_ref_kf: kernel and plain matches differ")
    if sm.n_matches_mm < 15:
        raise AssertionError(f"track_ref_kf: only {sm.n_matches_mm} matches")


def main():
    smi = phase_device()
    phase_build()
    k = phase_kernels(smi)
    eng, engine_launches = phase_slice(smi)
    phase_live_call(eng, engine_launches)
    print(json.dumps({"kernels": [{
        "name": "hamming_top2", "route": "cuda",
        "source": "orbslam2_tpu_torch/csrc/hamming_top2.cu",
        "replaces": "orbslam2_tpu/ops/pallas_hamming.py:54",
        "launches": engine_launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
