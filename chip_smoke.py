"""Run the PyTorch/CUDA port's stereo SLAM main path once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device    — card name and power limit, torch and CUDA versions;
  2. build     — compile every hand-written kernel from the checkout;
  3. kernels   — each kernel against its plain PyTorch version on the
                 card, bit-exact, at the main path's shapes, long banks,
                 ragged edges, no query rows and ties;
  4. slice     — SlamEngine(STEREO, loop closing off; no device given,
                 so the card by default) over 40 frames of
                 the bench scene at 640×480, 1000 features, 128 keyframes,
                 16k map points, with a one-frame camera shake that makes
                 the engine take TrackReferenceKeyFrame (the path that
                 reaches hamming_top2); never lost, ≥ 3 keyframes, ATE <
                 0.15 m, ≥ 300 live map points, and every kernel of the
                 path launched by this run;
  5. live call — the engine's TrackReferenceKeyFrame step on the live map,
                 held against the same call with the matcher's plain
                 version;
  6. loop      — SlamEngine(STEREO, loop closing on) at the same widths over
                 the outward orbit (1.25 turns, 72 frames) of
                 tests/test_loop_closing.py, then finish_gba(): ≥ 85% of
                 frames tracked, ≥ 1 loop closed, a global BA launched and
                 merged, ATE < 0.5 m, and hamming_top2 launched from inside
                 the loop closer's match_for_sim3; per-layer median ms;
  7. live loop — match_for_sim3 on the closing (current, loop) keyframe
                 pair of the live map, held against the same call with the
                 plain version and the same generator state; then the
                 match_for_sim3, the loop-correction layers and one GBA
                 chunk timed warm on that pair (phase 6 timed their first
                 calls);
  8. reloc     — the phase-6 engine set LOST and shown a re-rendered early
                 frame must relocalize within 0.1 m, launching hamming_top2
                 from reloc_attempt; that reloc_attempt call is then run
                 again with the kernel and with the plain version, the same
                 generator state, and must give the same matches and pose;
  9. times     — each kernel at the main path's shape (1024×1024): the
                 wrapper's host µs per call, the wrapper-inclusive and the
                 plain version's ms per call (CUDA events; the kernels
                 line's ``ms`` and ``plain_ms``), then its device µs per
                 launch (torch.profiler, ``device_ms``; run last so that no
                 profiler session precedes a timed phase) against its
                 bound.
Every time printed carries the card's name and power limit.  The line
before the last is the kernels' JSON record (launches per path); the last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# tolerance of every kernel-vs-plain comparison: integer outputs, exact
MAX_ABS_ERR = 0
# H100 SXM: HBM rate; __popc issue rate per SM per clock (compute
# capability 9.0, CUDA C++ Programming Guide's throughput table)
HBM_BYTES_PER_S = 3.35e12
POPC_PER_SM_CLOCK = 16

N_FRAMES = 40
# phase 6: tests/test_loop_closing.py's orbit
ORBIT_FRAMES, ORBIT_TURNS, ORBIT_RADIUS, ORBIT_Z = 72, 1.25, 4.0, 10.0
RELOC_FRAME = 2
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


def phase_build(smi):
    from orbslam2_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load("hamming_top2")
    dt = time.perf_counter() - t0
    print(f"[build] hamming_top2.cu → {build.library_path('hamming_top2')} "
          f"in {dt:.2f} s ({smi})", flush=True)


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


def hamming_top2_bound(av, bv, sm_clock_mhz):
    """Least time on this card for hamming_top2 on these inputs: 8 __popc
    for each pair of valid descriptors (invalid pairs read 256 with no
    work) against the bytes read once and written once."""
    A, B = av.shape[0], bv.shape[0]
    ops = 8 * int(av.sum()) * int(bv.sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_s = ops / (POPC_PER_SM_CLOCK * sms * sm_clock_mhz * 1e6)
    nbytes = 32 * A + 32 * B + A + B + 3 * 4 * A
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes", ops, nbytes)


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
    # the main path's shape, others, long banks (64 and 1024 rows against
    # 16384 columns, 32 chunks), ragged edges and no query rows
    for A, B in [(1024, 1024), (600, 512), (256, 300), (1024, 16384),
                 (64, 16384), (1, 1), (1024, 1), (33, 1025), (0, 16)]:
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
    # the same across the bank's chunks: 4096 descriptors three times
    base = words(4096)
    tie_bank = torch.cat([base, base, base])
    cases["duplicated descriptors, long bank"] = (
        tie_bank[torch.from_numpy(rng.permutation(3 * 4096)[:64]).to(dev)
                 ].contiguous(),
        mask(64, 1.0), tie_bank, mask(3 * 4096, 1.0))

    max_err = 0
    for name, (a, av, b, bv) in cases.items():
        got = hamming_top2(a, av, b, bv)
        ref = hamming_top2_reference(a, av, b, bv)
        torch.cuda.synchronize()
        if any(g.shape != r.shape for g, r in zip(got, ref)):
            raise AssertionError(f"hamming_top2 vs plain at {name}: shapes "
                                 f"{[g.shape for g in got]} vs "
                                 f"{[r.shape for r in ref]}")
        err = max((int(torch.max(torch.abs(g.long() - r.long())))
                   for g, r in zip(got, ref) if g.numel()), default=0)
        max_err = max(max_err, err)
        if err > MAX_ABS_ERR:
            raise AssertionError(f"hamming_top2 vs plain at {name}: max "
                                 f"|diff| {err}")
        print(f"[kernels] hamming_top2 {name}: bit-exact vs plain "
              f"(A={a.shape[0]}, B={b.shape[0]})", flush=True)
    return max_err, cases["1024x1024"]


def phase_kernel_times(smi, main_inputs):
    from orbslam2_tpu_torch.kernels.bench_hamming_top2 import (device_us,
                                                               host_us)
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     hamming_top2_reference)

    a, av, b, bv = main_inputs
    wrapper_host_us = host_us(lambda: hamming_top2(a, av, b, bv))
    call_ms = _cuda_ms(lambda: hamming_top2(a, av, b, bv))
    plain_ms = _cuda_ms(lambda: hamming_top2_reference(a, av, b, bv))
    dev_us, recorded = device_us(lambda: hamming_top2(a, av, b, bv), n=200)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    bound_ms, bound_by, ops, nbytes = hamming_top2_bound(av, bv, clock)
    share = bound_ms / (dev_us / 1e3)
    print(f"[times] hamming_top2 1024x1024: device {dev_us:.3f} us per "
          f"launch (torch.profiler, mean of {recorded} recorded of 200), "
          f"wrapper-inclusive "
          f"{1e3 * call_ms:.3f} us per call (CUDA events), wrapper host "
          f"{wrapper_host_us:.2f} us per call, plain {plain_ms:.4f} ms; "
          f"bound {1e3 * bound_ms:.3f} us by {bound_by} ({ops} __popc at "
          f"{POPC_PER_SM_CLOCK}/clock/SM, SM clock {clock:.0f} MHz; "
          f"{nbytes} bytes), {100 * share:.1f}% of the bound ({smi})",
          flush=True)
    # ms: per call, wrapper included (CUDA events), as in every earlier
    # kernels line; device_ms: the kernel's own time (torch.profiler)
    return {"ms": call_ms, "device_ms": dev_us / 1e3,
            "device_launches_recorded": recorded,
            "host_us": wrapper_host_us, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": share,
            "sm_clock_mhz": clock}


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
    run.__wrapped__ = fn
    return run


def phase_slice(smi):
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cfg = bench_config()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses_gt = shaken_trajectory()
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses_gt]
    eng = SlamEngine(cfg, enable_loop_closing=False)
    if eng.device.type != "cuda":
        raise AssertionError(f"slice: SlamEngine chose {eng.device}, not "
                             f"the card")
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

    reset_launch_counts()               # the main path's count starts here
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
    by_site = dict(hamming_top2.launches_by_site)
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
                  f"{np.median(ms):.1f} ms, total {np.sum(ms):.0f} ms "
                  f"({smi})", flush=True)
    if n_kf < 3 or not err < 0.15 or n_pts < 300:
        raise AssertionError(f"slice: KFs {n_kf}, ATE {err}, points {n_pts}"
                             f" (need ≥3, <0.15 m, ≥300)")
    if engine_launches < 1:
        raise AssertionError("slice: the main path never launched the "
                             "hamming_top2 kernel")
    return eng, engine_launches, by_site


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


def orbit_scene(rng, n=1000, wall_radius=12.0, z_center=10.0):
    """Cylindrical wall of sprites around the orbit centre (a copy of
    tests/test_loop_closing.py:25-35; the test file imports jax)."""
    from orbslam2_tpu_torch.utils import synthetic

    scene = synthetic.make_scene(rng, n)
    a = rng.uniform(0, 2 * np.pi, n)
    r = wall_radius + rng.uniform(-1.5, 1.5, n)
    scene.points[:] = np.stack([r * np.sin(a), rng.uniform(-5.0, 5.0, n),
                                z_center - r * np.cos(a)], -1)
    return scene


def outward_orbit(n, radius=4.0, z_center=10.0, turns=1.0):
    """Camera circling the centre looking outward at the wall (a copy of
    tests/test_loop_closing.py:38-45)."""
    from orbslam2_tpu_torch.utils import synthetic

    poses = []
    for i in range(n):
        a = 2.0 * np.pi * turns * i / n
        t = np.array([radius * np.sin(a), 0.0,
                      z_center - radius * np.cos(a)])
        poses.append(synthetic.look_ahead_pose(t, yaw=np.pi + a))
    return poses


LOOP_LAYERS = ("detect_step", "match_for_sim3", "refine_sim3",
               "recount_matches", "correct_loop", "fuse_after_loop")


def phase_loop(smi):
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cfg = bench_config()
    rng = np.random.default_rng(0)
    scene = orbit_scene(rng, z_center=ORBIT_Z)
    poses_gt = outward_orbit(ORBIT_FRAMES, ORBIT_RADIUS, ORBIT_Z, ORBIT_TURNS)
    frames = [synthetic.render_stereo(scene, cfg.camera, T, rng, 1.0)
              for T in poses_gt]
    eng = SlamEngine(cfg)            # loop closing on, the card
    lc = eng.loop_closer
    layers = {name: [] for name in LOOP_LAYERS + ("gba_chunk", "gba_merge")}
    lc.fns = lc.fns._replace(**{name: _timed(getattr(lc.fns, name),
                                             layers[name])
                                for name in LOOP_LAYERS})
    lc.gba.f_chunk = _timed(lc.gba.f_chunk, layers["gba_chunk"])
    lc.gba.f_merge = _timed(lc.gba.f_merge, layers["gba_merge"])

    reset_launch_counts()               # the loop path's count starts here
    frame_ms, tracked = [], 0
    for i, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        Tcw = eng.track_stereo(left, right, 0.1 * i)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        if Tcw is not None:
            if Tcw.shape != (4, 4) or not np.all(np.isfinite(Tcw)):
                raise AssertionError(f"loop: bad pose at frame {i}: {Tcw}")
            tracked += 1
    t0 = time.perf_counter()
    eng.finish_gba()
    torch.cuda.synchronize()
    finish_ms = 1e3 * (time.perf_counter() - t0)
    launches = hamming_top2.launches
    by_site = dict(hamming_top2.launches_by_site)

    errs = []
    for Te, Tg in zip(eng.frame_poses(), poses_gt):
        if Te is None:
            continue
        Te = Te @ poses_gt[0]        # the engine's world is the first camera
        errs.append(np.sum((-Te[:3, :3].T @ Te[:3, 3]
                            + Tg[:3, :3].T @ Tg[:3, 3]) ** 2))
    err = float(np.sqrt(np.mean(errs)))
    gst = lc.gba.stats
    print(f"[loop] {ORBIT_FRAMES} orbit frames: tracked {tracked}, KFs "
          f"inserted {eng.stats['kf_inserted']}, live KFs {eng.n_kfs}, loops "
          f"closed {eng.stats['loops_closed']} (last {lc.last_loop}), GBA "
          f"{gst}, ATE {err:.4f} m, median {np.median(frame_ms):.1f} "
          f"ms/frame (max {np.max(frame_ms):.0f} ms), finish_gba "
          f"{finish_ms:.0f} ms, hamming_top2 launches {launches} by path "
          f"{by_site} ({smi})", flush=True)
    for name, ms in layers.items():
        if ms:
            print(f"[loop] layer {name}: {len(ms)} calls, median "
                  f"{np.median(ms):.1f} ms, max {np.max(ms):.1f} ms, total "
                  f"{np.sum(ms):.0f} ms ({smi})", flush=True)
    if tracked < 0.85 * ORBIT_FRAMES:
        raise AssertionError(f"loop: tracked only {tracked} frames")
    if eng.stats["loops_closed"] < 1:
        raise AssertionError(f"loop: no loop closed ({eng.stats})")
    if gst["launched"] < 1 or gst["merged"] < 1:
        raise AssertionError(f"loop: no global BA launched and merged "
                             f"({gst})")
    if not err < 0.5:
        raise AssertionError(f"loop: ATE {err} m (need < 0.5)")
    if by_site.get("match_for_sim3", 0) < 1:
        raise AssertionError("loop: match_for_sim3 never launched the "
                             "hamming_top2 kernel")
    lc.fns = lc.fns._replace(**{name: getattr(lc.fns, name).__wrapped__
                                for name in LOOP_LAYERS})
    lc.gba.f_chunk = lc.gba.f_chunk.__wrapped__
    lc.gba.f_merge = lc.gba.f_merge.__wrapped__
    return eng, poses_gt, scene, rng, by_site


def phase_live_loop_call(eng):
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.ops import matching

    lc = eng.loop_closer
    kf, cand = lc.last_loop
    state = lc.generator.get_state()
    before = ht2.hamming_top2.launches_by_site.get("match_for_sim3", 0)
    res, m = lc.fns.match_for_sim3(eng.ms, kf, cand, lc.generator)
    torch.cuda.synchronize()
    n_launch = ht2.hamming_top2.launches_by_site.get("match_for_sim3",
                                                     0) - before
    g = torch.Generator(device="cuda")
    g.set_state(state)
    matching.hamming_top2 = ht2.hamming_top2_reference
    try:
        res_p, m_p = lc.fns.match_for_sim3(eng.ms, kf, cand, g)
    finally:
        matching.hamming_top2 = ht2.hamming_top2
    same_m = torch.equal(m, m_p)
    same_inl = torch.equal(res.inliers, res_p.inliers)
    print(f"[live-loop] match_for_sim3 KF {kf} ↔ loop KF {cand} on the live "
          f"map: {int((m >= 0).sum())} matches, {int(res.n_inliers)} RANSAC "
          f"inliers, ok {bool(res.ok)}; kernel launches {n_launch}; matches "
          f"equal to the plain version: {same_m}, inlier masks equal: "
          f"{same_inl}", flush=True)
    if n_launch < 1:
        raise AssertionError("match_for_sim3 did not launch hamming_top2")
    if not (same_m and same_inl):
        raise AssertionError("match_for_sim3: kernel and plain differ")
    return res


def phase_warm_loop_layers(eng, res, smi, reps=3):
    """The loop-correction layers again on the live pair, warm: phase 6
    timed each one's first call on the card (first-use library set-up
    included).  Results are dropped; the map is not changed."""
    lc = eng.loop_closer
    f = lc.fns
    kf, cand = lc.last_loop
    ms = eng.ms
    z8 = torch.zeros(8, dtype=torch.int32, device=eng.device)
    g = torch.Generator(device=eng.device)
    g.set_state(lc.generator.get_state())
    calls = {
        "match_for_sim3": lambda: f.match_for_sim3(ms, kf, cand, g),
        "refine_sim3": lambda: f.refine_sim3(ms, kf, cand, res.s12, res.R12,
                                             res.t12),
        "recount_matches": lambda: f.recount_matches(
            ms, kf, cand, res.s12, res.R12, res.t12),
        "correct_loop": lambda: f.correct_loop(
            ms, kf, cand, res.s12, res.R12, res.t12, z8, z8, z8.bool()),
        "fuse_after_loop": lambda: f.fuse_after_loop(ms, kf, cand),
        "gba_chunk": lambda: lc.gba.f_chunk(
            ms, torch.ones(ms.K * ms.N, dtype=torch.bool,
                           device=eng.device), True),
    }
    for name, fn in calls.items():
        log = []
        for _ in range(reps):
            _timed(fn, log)()
        print(f"[warm] {name}: median {np.median(log):.1f} ms over {reps} "
              f"warm calls ({smi})", flush=True)


def phase_reloc(eng, poses_gt, scene, rng, smi):
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.utils import synthetic

    if eng.n_kfs <= 5:
        raise AssertionError(f"reloc: only {eng.n_kfs} live keyframes")
    T_back = poses_gt[RELOC_FRAME]
    left, right = synthetic.render_stereo(scene, eng.cfg.camera, T_back, rng,
                                          1.0)
    eng.state = tracking.LOST
    eng.velocity = None
    n_reloc = eng.stats["reloc"]
    lc = eng.loop_closer
    attempt = lc.fns.reloc_attempt
    calls = []                         # (arguments, generator state)

    def recorded(*args):
        calls.append((args, args[-1].get_state()))
        return attempt(*args)

    lc.fns = lc.fns._replace(reloc_attempt=recorded)
    reset_launch_counts()              # the relocalization path's count
    t0 = time.perf_counter()
    try:
        Tcw = eng.track_stereo(left, right, 99.0)
        torch.cuda.synchronize()
    finally:
        lc.fns = lc.fns._replace(reloc_attempt=attempt)
    dt = 1e3 * (time.perf_counter() - t0)
    by_site = dict(hamming_top2.launches_by_site)
    if Tcw is None or eng.stats["reloc"] != n_reloc + 1:
        raise AssertionError("reloc: the engine did not relocalize")
    Te = Tcw @ poses_gt[0]
    d = float(np.linalg.norm(-Te[:3, :3].T @ Te[:3, 3]
                             + T_back[:3, :3].T @ T_back[:3, 3]))
    print(f"[reloc] LOST → relocalized on a re-render of frame "
          f"{RELOC_FRAME}: centre error {d:.4f} m, {dt:.0f} ms, "
          f"hamming_top2 launches by path {by_site} ({smi})", flush=True)
    if not d < 0.1:
        raise AssertionError(f"reloc: centre error {d} m (need < 0.1)")
    if by_site.get("reloc_attempt", 0) < 1:
        raise AssertionError("reloc: reloc_attempt never launched the "
                             "hamming_top2 kernel")
    live_reloc_call(eng, attempt, *calls[-1])
    return by_site


def live_reloc_call(eng, attempt, args, state):
    """The reloc_attempt call that relocalized, again on the live map: its
    descriptor matches and its result with the kernel and with the plain
    version, each from the generator state that call started from."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.ops import matching

    match = matching.match_descriptors

    def run(top2):
        seen = []

        def recorded(*a, **k):
            out = match(*a, **k)
            seen.append(out[0])
            return out

        g = torch.Generator(device=eng.device)
        g.set_state(state)
        matching.hamming_top2, matching.match_descriptors = top2, recorded
        try:
            Tcw, n, assoc = attempt(*args[:-1], g)
            torch.cuda.synchronize()
        finally:
            matching.hamming_top2 = ht2.hamming_top2
            matching.match_descriptors = match
        return seen, Tcw, int(n), assoc

    m, Tcw, n, assoc = run(ht2.hamming_top2)
    m_p, Tcw_p, n_p, assoc_p = run(ht2.hamming_top2_reference)
    same_m = len(m) == len(m_p) == 1 and torch.equal(m[0], m_p[0])
    same = same_m and n == n_p and torch.equal(assoc, assoc_p) and \
        torch.equal(Tcw, Tcw_p)
    print(f"[live-reloc] reloc_attempt against KF {args[-2]} on the live "
          f"map: {int((m[0] >= 0).sum())} matches, {n} inliers; matches "
          f"equal to the plain version: {same_m}, inliers, associations and "
          f"pose equal: {same}", flush=True)
    if not same:
        raise AssertionError("reloc_attempt: kernel and plain differ")


def main():
    smi = phase_device()
    phase_build(smi)
    max_err, main_inputs = phase_kernels(smi)
    eng, engine_launches, slice_sites = phase_slice(smi)
    phase_live_call(eng, engine_launches)
    del eng
    eng, poses_gt, scene, rng, loop_sites = phase_loop(smi)
    res = phase_live_loop_call(eng)
    phase_warm_loop_layers(eng, res, smi)
    reloc_sites = phase_reloc(eng, poses_gt, scene, rng, smi)
    k = phase_kernel_times(smi, main_inputs)
    by_path = {"slice (phase 4)": slice_sites, "loop (phase 6)": loop_sites,
               "reloc (phase 8)": reloc_sites}
    print(json.dumps({"kernels": [{
        "name": "hamming_top2", "route": "cuda",
        "source": "orbslam2_tpu_torch/csrc/hamming_top2.cu",
        "replaces": "orbslam2_tpu/ops/pallas_hamming.py:54",
        "launches": sum(sum(v.values()) for v in by_path.values()),
        "launches_by_path": by_path, "max_abs_err": max_err, **k,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
