"""Run the PyTorch/CUDA port's SLAM paths once on one GPU.

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
 10. windowed  — WindowedSlamEngine(window=4, loop closing off) over
                 phase 4's jolted corridor: the in-window
                 TrackReferenceKeyFrame fallback launches hamming_top2
                 (site window/track_ref_kf), and each of its matching calls,
                 replayed with the plain version, gives the same output;
                 never lost, ATE < 0.15 m;
 11. bench SLAM — bench.py's stereo SLAM leg: the bench world and its
                 walk, WindowedSlamEngine(window=4, loop closing on), 28
                 warm-up frames, then one pass of 48 frames (bench.py:
                 three; cut to keep the run inside its limit),
                 each ending in flush() and a synchronize: fps per pass and
                 their median, ms per frame, keyframes per frame, ATE over
                 bench.py's first 76 frames (< 0.1127 m, the cv2 proxy's),
                 never lost, hamming_top2 launches by path;
 12. bench LOC — bench.py's stereo LOC leg: make_window_tracker(cfg, 8) on
                 the phase-11 map over frames 28-35, 1 window a pass
                 (bench.py runs 24; cut to keep the run inside its limit),
                 three passes: fps; every frame ≥ 30 map inliers, ATE over
                 the window < 0.1127 m; then one LOC window and the SLAM
                 engine's next window under torch.profiler (kernels and
                 device ms per frame);
 13. RGB-D     — SlamEngine(RGBD, loop closing off) over phase 4's shaken
                 corridor rendered with depth: never lost, ATE < 0.15 m,
                 hamming_top2 launched from track_ref_kf, each of those
                 matching calls replayed with the plain version equal;
 14. bench RGB-D — bench.py's RGB-D leg: WindowedSlamEngine(window=4, loop
                 closing on), 36 frames at 0.12 m, 12 warm-up, 24 timed
                 (bench.py: 60 and 48; cut to keep the run inside its
                 limit) ending in flush() and a synchronize: fps, keyframes per
                 frame, ATE (< 0.15 m), never lost; the bench camera with
                 sensor=RGBD (the leg's reference YAML is not here);
 15. localization — phase 13's map in localization mode (a LoopCloser
                 attached, its DB holding the map's keyframes): 12 frames
                 past the map (VO-mode frames counted), then LOST and a
                 re-render of frame 2 must relocalize within 0.1 m,
                 launching hamming_top2 from reloc_attempt (that call
                 replayed with the plain version); the map must not grow;
                 phase 14's windowed engine tracks one window in the mode
                 and inserts no keyframe;
 16. GBA solvers — one robust GBA chunk on a perturbed RGB-D map of the
                 default CapacityConfig() (512 keyframe slots, 32,768
                 points): through CG (gba_chunk's choice past 256 slots)
                 and forced through the dense Schur solve; ms (CUDA
                 events) and peak device memory of each, agreement within
                 stated tolerances, kernels and device ms per CG step;
 17. mono      — SlamEngine(MONOCULAR, loop closing off) over
                 tests/test_mono.py's scene and 25-frame sideways walk at
                 640×480, 2000 features (that test's; at 1000 the scene
                 never passes the bootstrap's 100-match gate), 128
                 keyframes, 16k points: the frame that initialized, H or
                 F, the bootstrap's points, per-layer ms of the bootstrap
                 and the frames after it; ends OK, similarity-aligned ATE
                 < 0.03 × path length; track_ref_kf's matching calls
                 replayed with the plain version;
 18. bench mono — bench.py's mono leg: WindowedSlamEngine(MONOCULAR,
                 window=4, loop closing on), the bench world along
                 look_ahead_pose((0.18 i, 0, 0.04 i)), 28 warm-up frames,
                 two passes of 48 each ending in flush() and a
                 synchronize: fps per pass, ms and keyframes a frame, loops
                 closed, similarity-aligned ATE, launches by site (every
                 matching call that launched the kernel replayed with the
                 plain version), one window under torch.profiler; must
                 not end LOST;
 19. system    — the System facade (runtime/system.py) at the bench widths,
                 loop closing on, no device given: track_stereo over the
                 first 24 frames of phase 4's shaken corridor (median ms a
                 frame); the TUM, KITTI and keyframe-TUM savers' line
                 counts; the pose covariance (6×6, symmetric, eigenvalues
                 ≥ −1e-8) and its world-frame form (the same spectrum);
                 save_map (ms, MB) and the file read back on the card bit
                 for bit (load_map ms); a fresh System with map_file set
                 starts LOST in localization mode, relocalizes a re-render
                 of frame 8 within 0.1 m, launching hamming_top2 from
                 reloc_attempt (that call replayed with the plain
                 version), and one more frame leaves the map as it was;
                 change_calibration to slightly other intrinsics and 4
                 frames more; System(RGBD).track_ird over 6 frames of
                 phase 13's depth corridor (HPose within 0.15 m of the
                 remapped truth); tools.replay.run_synthetic_stereo at the
                 default capacity over 12 frames (median and mean ms);
                 track_ref_kf's
                 matching calls replayed with the plain version;
 20. async     — AsyncSlamEngine (runtime/pipeline.py: the mapping worker
                 on its own CUDA stream, loop closing on, no device given)
                 over phase 4's 40 jolted corridor frames: the caller's ms a
                 frame (track_stereo to a synchronize of its own stream;
                 median and worst beside phase 4's median), the worker's
                 mapping-step ms, keyframes queued / mapped / dropped, jobs
                 mapped without local BA, the deepest queue, the share of
                 keyframe decisions that met a busy mapper; ATE < 0.15 m,
                 never lost; hamming_top2 launched from track_ref_kf on the
                 tracking thread; then phase 6's orbit, run on at its
                 step for 14 frames more (86, ~1.5 turns), through a second
                 AsyncSlamEngine: ≥ 85% tracked, ≥ 1 loop closed and its
                 global BA merged, ATE < 0.5 m, hamming_top2 launched from
                 match_for_sim3 on the worker thread; every matching call
                 of both runs replayed with the plain version;
                 StereoRectifier on a 752×480 EuRoC-like calibration:
                 remap_pair on the card within 1e-3 of the host path, ms a
                 pair for each path; once phase 9's timed part is done, a
                 third AsyncSlamEngine over the corridor's first 16 frames,
                 the last 8 under torch.profiler: kernels and device ms
                 per CUDA stream and the device time both streams were
                 busy at once;
 21. drivers   — phase 4's 40 jolted corridor frames and phase 13's RGB-D
                 frames written to disk with utils/png.write_png as KITTI,
                 TUM (gray as RGB, depth at factor 5000, 0 past 13.107 m;
                 the share blanked printed) and EuRoC layouts (zero
                 distortion, R = I, P = K), each with a settings file of
                 the bench camera and 1000 features; run_kitti_stereo,
                 run_tum_rgbd and run_euroc_stereo (no device given):
                 all 40 frames tracked, ATE < 0.15 m from the trajectory
                 file read back, the KITTI and TUM runs' track_ref_kf
                 launches replayed with the plain version equal;
                 ReplayReport's median and mean ms beside phase 4's, PNG
                 decode ms a frame, EuRoC host-rectify and remap_pair ms
                 a pair; a StreamNode (queue of 4) over a fresh System: 16
                 frames each pushed after the last pose (16 processed, 0
                 dropped), then 24 at once (processed + dropped = 24, ≥ 1
                 dropped), stop() clean, ms a processed frame;
                 ArDemo.insert_cube on that map (or test_extras.py's plane
                 scene if it has < 50 points seen > 5 times), detect_plane
                 with fixed hypotheses on the card against a CPU copy
                 (normal up to sign, d, origin within 1e-4), its ms;
 22. vocabulary — default_vocabulary(force_rebuild=True, path=<tmp>), no
                 device given: the default harvest on the card (views,
                 descriptors, ms a view to render and to extract, the
                 real-raster bank's size: empty where matplotlib is
                 missing; ≥ 500 descriptors a view on average), then the
                 k=10, levels=4 tree built on the card, every k-majority
                 assignment a hamming_top2 launch (site vocab_build; no
                 launch elsewhere), written as the JAX package's npz
                 (uint32 centroids, float32 idf) and loaded back equal;
                 the first 2 views extracted again on the CPU (the share
                 of descriptors bit-equal); the same build on the CPU
                 (the plain version) on the same descriptors: every level
                 and idf bit-equal, seconds of each build; a corridor
                 view's BoW similarity to itself re-rendered with fresh
                 noise beats its similarity to another world's view by
                 more than 0.1 (tests/test_place_recognition.py:47); last
                 of the run, hamming_top2 at the root group's shape (every
                 descriptor against 10 centroids): device µs per launch
                 against its bound, wrapper-inclusive and plain ms;
 23. mesh      — parallel/* with 4 shards on cuda:0 (JAX's virtual
                 devices of one host): phase 16's perturbed capacity map,
                 one robust CG chunk through distributed_bundle_adjust
                 against phase 16's unsharded CG chunk within phase 16's
                 bars, the 4 shards' poses bit-equal, ms (CUDA events) and
                 peak memory; the same chunk on the map with its point
                 slots shuffled, so that every shard owns live points,
                 within the same bars and bit-equal across shards; a
                 GbaManager with the mesh launched, waited and merged
                 (stats["distributed"] == 1; one active shard, the map as
                 it lies) within the same bars of the unsharded manager's
                 merge; phase 19's saved
                 map: every live keyframe through detect_step of a
                 LoopCloser with the mesh and of one without (one card:
                 no mesh), candidates and covisibility rows equal, BoW
                 vectors and scores within 1e-6; System.load_map into a
                 System whose loop closer has the mesh leaves the DB
                 sharded and relocalizes a re-render of frame 8 within
                 0.1 m (hamming_top2 from reloc_attempt, that call
                 replayed with the plain version); then
                 tools/scaling.measure_scaling on the mesh, printed as a
                 JSON line, and its problem solved on the mesh within
                 5e-4 of one shard (its points fill every shard's block),
                 the shards' poses bit-equal;
 24. map scale — WindowedSlamEngine(window=4, loop closing on, no device
                 given) at tools/scale_demo.py's full configuration: 1024
                 keyframe slots, 131,072 points, 1000 features, its
                 320×240 camera and local-BA sizes, over
                 tests/test_scale_circuit.py's room and 300-frame circuit
                 (its depth; the capacity, which sets every map tensor's
                 width, stays full) through scale_demo.run_circuit with no
                 flush() before the end (as that test): fps, keyframes,
                 live points, allocated and peak memory every 50 frames;
                 the loop-closing frame's ms; the global BA's
                 chunks (ms, solver: CG) and, on the final map, one chunk
                 alone and one covisibility() call (ms, peak bytes; 8 rows
                 against the host's point sets); that test's bars: ≥ 95%
                 tracked, ≥ 1 loop closed and its GBA merged, n_kfs ≤
                 1024, ≥ 30 keyframes inserted, ATE < 1.5 m; every
                 hamming_top2 matching call replayed with the plain
                 version equal;
  9. times     — each kernel at the main path's shape (1024×1024): the
                 wrapper's host µs per call, the wrapper-inclusive and the
                 plain version's ms per call (CUDA events; the kernels
                 line's ``ms`` and ``plain_ms``), then its device µs per
                 launch (torch.profiler, ``device_ms``) against its bound.
                 The wrapper's host µs is also taken at the end of phase 3
                 and after phase 20's profiled window (the kernels line's
                 ``host_us_by_point``).
No profiler session of phase 20, 9 or 22 precedes a timed measurement:
phases run in the order 1-8, 10-19, 20's corridor, orbit and rectify, 21,
22, 23, 24, 9's timed part, 20's profiled window, 9's device times, 22's
root-shape kernel times.  (Phases 12, 16 and 18
profile windows of their own, before phase 19.)
Every time printed carries the card's name and power limit.  The line
before the last is the kernels' JSON record (launches per path); the last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import threading
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


class _Clock:
    """Wall seconds of each stretch of main(), printed as it ends."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def lap(self, what):
        now = time.perf_counter()
        print(f"[clock] {what} {now - self.t:.1f} s (script "
              f"{now - self.t0:.1f} s)", flush=True)
        self.t = now


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


def _max_sm_clock_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


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
    # the wrapper's costs before any engine ran or any profiler session
    return max_err, cases["1024x1024"], _wrapper_times(cases["1024x1024"])


def _wrapper_times(main_inputs):
    """(wrapper host µs per call, wrapper-inclusive ms per call from CUDA
    events) of hamming_top2 on ``main_inputs``."""
    from orbslam2_tpu_torch.kernels.bench_hamming_top2 import host_us
    from orbslam2_tpu_torch.ops.hamming_top2 import hamming_top2

    a, av, b, bv = main_inputs
    return (host_us(lambda: hamming_top2(a, av, b, bv)),
            _cuda_ms(lambda: hamming_top2(a, av, b, bv)))


def phase_kernel_times(smi, main_inputs):
    """Phase 9, its timed part: the wrapper's host µs and the
    wrapper-inclusive and plain ms per call (CUDA events), after phases
    4-20's timed parts and before phase 20's profiled window."""
    from orbslam2_tpu_torch.ops.hamming_top2 import hamming_top2_reference

    a, av, b, bv = main_inputs
    wrapper_host_us, call_ms = _wrapper_times(main_inputs)
    plain_ms = _cuda_ms(lambda: hamming_top2_reference(a, av, b, bv))
    return {"ms": call_ms, "host_us": wrapper_host_us, "plain_ms": plain_ms}


def phase_kernel_device(smi, main_inputs, k, early):
    """Phase 9, last: the wrapper's times once more, after phase 20's
    profiled window (beside phase 3's ``early`` and the timed part's
    ``k``: what each span of the run did to the wrapper's host cost),
    then the kernel's device µs per launch under torch.profiler against
    its bound.  Returns ``k`` with the device numbers added."""
    from orbslam2_tpu_torch.kernels.bench_hamming_top2 import device_us
    from orbslam2_tpu_torch.ops.hamming_top2 import hamming_top2

    a, av, b, bv = main_inputs
    late = _wrapper_times(main_inputs)
    points = {"phase 3 (no engine, no profiler yet)": early,
              "phase 9 (after phases 4-20's timed parts)":
                  (k["host_us"], k["ms"]),
              "after phase 20's profiled window": late}
    print(f"[times] hamming_top2 1024x1024 wrapper host us / "
          f"wrapper-inclusive us per call (CUDA events): "
          + "; ".join(f"{name} {h:.2f} / {1e3 * ms:.3f}"
                      for name, (h, ms) in points.items())
          + f" ({smi})", flush=True)
    dev_us, recorded = device_us(lambda: hamming_top2(a, av, b, bv), n=200)
    clock = _max_sm_clock_mhz()
    bound_ms, bound_by, ops, nbytes = hamming_top2_bound(av, bv, clock)
    share = bound_ms / (dev_us / 1e3)
    print(f"[times] hamming_top2 1024x1024: device {dev_us:.3f} us per "
          f"launch (torch.profiler, mean of {recorded} recorded of 200), "
          f"wrapper-inclusive "
          f"{1e3 * k['ms']:.3f} us per call (CUDA events), wrapper host "
          f"{k['host_us']:.2f} us per call, plain {k['plain_ms']:.4f} ms; "
          f"bound {1e3 * bound_ms:.3f} us by {bound_by} ({ops} __popc at "
          f"{POPC_PER_SM_CLOCK}/clock/SM, SM clock {clock:.0f} MHz; "
          f"{nbytes} bytes), {100 * share:.1f}% of the bound ({smi})",
          flush=True)
    # ms: per call, wrapper included (CUDA events), as in every earlier
    # kernels line; device_ms: the kernel's own time (torch.profiler)
    return {**k, "device_ms": dev_us / 1e3,
            "device_launches_recorded": recorded,
            "host_us_by_point": {n: h for n, (h, _) in points.items()},
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


def _device_events(prof):
    """(name, device µs) of every device event of a finished profile, from
    the raw kineto events: ``prof.events()`` first builds a tree over all
    of a window's events, CPU ones included, which takes longer than the
    window itself."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_hidden_event()]


def _profiled(fn):
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
    kernels = [us for _, us in _device_events(prof)]
    syncs = sum(e.name() == "cudaStreamSynchronize"
                for e in prof.profiler.kineto_results.events())
    return len(kernels), sum(kernels) / 1e3, wall_ms, syncs


@contextlib.contextmanager
def _no_hamming_syncs():
    """Within the block, every call of ``hamming.hamming_matrix`` (the one
    that ``masked_hamming_matrix`` and every caller reach) made while no
    other Python thread runs (the mode is process-wide) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside it
    raises.  Yields [calls checked, calls made beside another thread].
    The mode is first shown to catch the blocking copy of a Python
    scalar to the card."""
    from orbslam2_tpu_torch.ops import hamming

    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.tensor(128.0, device="cuda")
        raise AssertionError("sync debug mode let a blocking host copy by")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain, calls = hamming.hamming_matrix, [0, 0]

    def checked(a, b):
        if threading.active_count() > 1:
            calls[1] += 1
            return plain(a, b)
        calls[0] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return plain(a, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    hamming.hamming_matrix = checked
    try:
        yield calls
    finally:
        hamming.hamming_matrix = plain


def _top_kernels(fn, n=3):
    """[(kernel name, device ms, launches)] of the ``n`` kernels that took
    the most device time in one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for name, us in _device_events(prof):
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us / 1e3, c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(name[:60], round(t, 3), c) for name, (t, c) in ranked]


def phase_slice(smi):
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    cfg = bench_config()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses_gt = shaken_trajectory()
    frames = render_pool.render_frames(synthetic.render_world_stereo, world,
                                       cfg.camera, poses_gt, rng)
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
    return eng, engine_launches, by_site, frames, np.median(frame_ms[1:])


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


def outward_orbit(n, radius=4.0, z_center=10.0, turns=1.0, stop=None):
    """Camera circling the centre looking outward at the wall (a copy of
    tests/test_loop_closing.py:38-45): ``turns`` over ``n`` frames; with
    ``stop``, frames 0 to ``stop`` - 1 at the same step."""
    from orbslam2_tpu_torch.utils import synthetic

    poses = []
    for i in range(n if stop is None else stop):
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
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    cfg = bench_config()
    rng = np.random.default_rng(0)
    scene = orbit_scene(rng, z_center=ORBIT_Z)
    poses_gt = outward_orbit(ORBIT_FRAMES, ORBIT_RADIUS, ORBIT_Z, ORBIT_TURNS)
    frames = render_pool.render_frames(synthetic.render_stereo, scene,
                                       cfg.camera, poses_gt, rng)
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
    return eng, poses_gt, scene, rng, by_site, frames


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


# phases 10-12: the bench.py stereo legs (bench.py:61-64, 86-196)
# bench.py runs three stereo passes and 24 LOC windows a pass; the script
# runs fewer, to stay well inside its time limit
BENCH_WARMUP, BENCH_PASS, BENCH_PASSES = 28, 48, 1
BENCH_FRAMES = BENCH_WARMUP + BENCH_PASSES * BENCH_PASS
BENCH_ORACLE_FRAMES = 76       # the span of bench.py's ATE (warm-up + 1 pass)
CV2_PROXY_ATE = 0.1127         # the cv2 proxy's ATE there (BENCH_r05)
LOC_WINDOW, LOC_WINDOWS = 8, 1      # bench.py: 24 windows a pass


def _record_matches(*sites):
    """Wrap the matcher so that calls made at the launch sites ``sites``
    are kept (inputs and kernel outputs) for a replay; returns (records,
    restore).  The inputs are kept as copies: most are rows of a map
    tensor (``ms.kf_desc[kf]``), and a view would keep that version of
    the whole [K, N, 8] map tensor alive on the card (33.5 MB at 1024
    slots, for every recorded call)."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.ops import matching

    match = matching.match_descriptors
    records = []

    def copy(x):
        return x.clone() if torch.is_tensor(x) else x

    def recording(*args, **kwargs):
        out = match(*args, **kwargs)
        # the site is per thread, and unset on a thread that named none
        if getattr(ht2._site, "name", None) in sites:
            records.append((tuple(map(copy, args)),
                            {k: copy(v) for k, v in kwargs.items()}, out))
        return out

    matching.match_descriptors = recording

    def restore():
        matching.match_descriptors = match

    return records, restore


def phase_windowed_fallback(smi, frames):
    """Phase 10: the windowed engine over phase 4's jolted corridor (its
    frames, rendered there); its in-window fallback must launch
    hamming_top2, and every such matching call, replayed with the plain
    version, must give the same output."""
    from orbslam2_tpu_torch.models import frame as frame_mod
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine

    cfg = bench_config()
    poses_gt = shaken_trajectory()
    # per-layer wall ms: the window tracker builds its own frontend and
    # tracking steps, so the builders are wrapped while the engine is made
    layers = {"frontend": [], "track_body": [], "track_ref_kf": [],
              "window mapping step": []}
    make_fns, make_front = (tracking.make_tracking_fns,
                            frame_mod.make_frontend_stereo)

    def timed_fns(c):
        fns = make_fns(c)
        return fns._replace(track_body=_timed(fns.track_body,
                                              layers["track_body"]),
                            track_ref_kf=_timed(fns.track_ref_kf,
                                                layers["track_ref_kf"]))

    tracking.make_tracking_fns = timed_fns
    frame_mod.make_frontend_stereo = lambda c: _timed(make_front(c),
                                                      layers["frontend"])
    try:
        eng = WindowedSlamEngine(cfg, enable_loop_closing=False)
    finally:
        tracking.make_tracking_fns = make_fns
        frame_mod.make_frontend_stereo = make_front
    eng.f_window_kf = _timed(eng.f_window_kf, layers["window mapping step"])
    if eng.device.type != "cuda":
        raise AssertionError(f"windowed: the engine chose {eng.device}")
    records, restore = _record_matches("window/track_ref_kf")
    ht2.reset_launch_counts()          # the windowed path's count
    t0 = time.perf_counter()
    try:
        for i, (left, right) in enumerate(frames):
            eng.track_stereo(left, right, 0.1 * i)
        eng.flush()
        torch.cuda.synchronize()
    finally:
        restore()
    dt = time.perf_counter() - t0
    by_site = dict(ht2.hamming_top2.launches_by_site)
    est = eng.frame_poses()
    n_lost = sum(T is None for T in est)
    err = ate(est, poses_gt)
    same = _replay_plain(records)
    print(f"[windowed] {N_FRAMES} jolted corridor frames in windows of "
          f"{eng.window}: {N_FRAMES / dt:.2f} fps, KFs inserted "
          f"{eng.stats['kf_inserted']}, lost {n_lost}, ATE {err:.4f} m; "
          f"hamming_top2 launches by path {by_site}; {len(records)} "
          f"in-window fallback matching calls replayed with the plain "
          f"version: equal {same} ({smi})", flush=True)
    for name, ms in layers.items():
        if ms:
            print(f"[windowed] layer {name}: {len(ms)} calls, median "
                  f"{np.median(ms):.1f} ms, total {np.sum(ms):.0f} ms "
                  f"({smi})", flush=True)
    if by_site.get("window/track_ref_kf", 0) < 1 or not records:
        raise AssertionError("windowed: the in-window fallback never "
                             "launched the hamming_top2 kernel")
    if not same:
        raise AssertionError("windowed: kernel and plain differ on the "
                             "in-window fallback's live input")
    if n_lost or not err < 0.15:
        raise AssertionError(f"windowed: lost {n_lost}, ATE {err}")
    return by_site


def _replay_plain(records):
    """Every recorded matching call again with the plain version: True
    when each gives the kernel's matches and distances."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.ops import matching

    same = True
    matching.hamming_top2 = ht2.hamming_top2_reference
    try:
        for args, kwargs, (m, d) in records:
            m_p, d_p = matching.match_descriptors(*args, **kwargs)
            same = same and torch.equal(m, m_p) and torch.equal(d, d_p)
    finally:
        matching.hamming_top2 = ht2.hamming_top2
    return same


def phase_bench_slam(smi):
    """Phase 11: bench.py's stereo SLAM leg on the port (bench.py:86-121):
    WindowedSlamEngine(window=4), loop closing on, 28 warm-up frames,
    then BENCH_PASSES passes of 48 frames (bench.py runs three), each
    ending in flush() and a synchronize."""
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    cfg = bench_config()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    # BENCH_FRAMES for the leg, then one window more for phase 12's profile
    poses_gt = synthetic.straight_trajectory(BENCH_FRAMES + 4, step=0.25)
    t0 = time.perf_counter()
    frames = render_pool.render_frames(synthetic.render_world_stereo, world,
                                       cfg.camera, poses_gt, rng)
    render_s = time.perf_counter() - t0
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=4)
    reset_launch_counts()              # the bench SLAM leg's count
    t0 = time.perf_counter()
    for i in range(BENCH_WARMUP):
        eng.track_stereo(*frames[i], 0.1 * i)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pass_fps, kf_counts, start = [], [], BENCH_WARMUP
    for _ in range(BENCH_PASSES):
        kf_before = eng.stats["kf_inserted"]
        t0 = time.perf_counter()
        for i in range(start, start + BENCH_PASS):
            eng.track_stereo(*frames[i], 0.1 * i)
        eng.flush()
        torch.cuda.synchronize()
        pass_fps.append(BENCH_PASS / (time.perf_counter() - t0))
        kf_counts.append(eng.stats["kf_inserted"] - kf_before)
        start += BENCH_PASS
    by_site = dict(hamming_top2.launches_by_site)
    est = eng.frame_poses()
    n_lost = sum(T is None for T in est)
    ate_oracle = ate(est[:BENCH_ORACLE_FRAMES],
                     poses_gt[:BENCH_ORACLE_FRAMES])
    ate_all = ate(est, poses_gt[:BENCH_FRAMES])
    fps = float(np.median(pass_fps))
    print(f"[bench-slam] {BENCH_FRAMES} frames (rendered with 4 more in "
          f"{render_s:.1f} "
          f"s; warm-up {BENCH_WARMUP} frames {warm_s:.1f} s): pass fps "
          f"{[round(f, 3) for f in pass_fps]}, median {fps:.3f} fps = "
          f"{1e3 / fps:.1f} ms/frame, KFs per frame "
          f"{np.median(kf_counts) / BENCH_PASS:.4f} (per pass {kf_counts}), "
          f"KFs inserted {eng.stats['kf_inserted']}, live {eng.n_kfs}, "
          f"loops closed {eng.stats['loops_closed']}, lost {n_lost}, ATE "
          f"{ate_oracle:.4f} m over bench.py's first {BENCH_ORACLE_FRAMES} "
          f"frames (cv2 proxy {CV2_PROXY_ATE}), {ate_all:.4f} m over all; "
          f"hamming_top2 launches by path {by_site} ({smi})", flush=True)
    if n_lost or not ate_oracle < CV2_PROXY_ATE:
        raise AssertionError(f"bench-slam: lost {n_lost}, ATE {ate_oracle} "
                             f"(need < {CV2_PROXY_ATE})")
    return eng, frames, poses_gt, by_site, {
        "slam_fps": fps, "pass_fps": pass_fps, "ate_m": ate_oracle}


def phase_bench_loc(eng, frames, poses_gt, smi):
    """Phase 12: bench.py's stereo LOC leg (bench.py:160-196):
    make_window_tracker(cfg, 8) on the phase-11 map over frames 28-35,
    LOC_WINDOWS windows a pass (bench.py runs 24), three passes.  Each
    window starts from the SLAM estimate of frames 27 and 26 and the map
    points of frame 27's reference keyframe (bench.py chains windows over
    one repeated buffer, which sends the tracker 1.75 m back at every
    window boundary).  Last, one LOC window and the SLAM engine's next
    window under torch.profiler: kernels and device ms per frame."""
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime import streaming

    first = BENCH_WARMUP
    track = streaming.make_window_tracker(eng.cfg, LOC_WINDOW)
    if track.device.type != "cuda":
        raise AssertionError(f"bench-loc: the tracker chose {track.device}")
    est = eng.frame_poses()
    ref = eng.trajectory[first - 1].ref_kf
    state_T = torch.as_tensor(np.stack([est[first - 1], est[first - 2]]),
                              dtype=torch.float32, device="cuda")
    assoc0 = eng.ms.kf_mp[ref]
    flat = torch.from_numpy(streaming.pack_window_uint8(
        frames[first:first + LOC_WINDOW])).cuda()
    res = track(eng.ms, flat, state_T, assoc0, ref)      # first use
    torch.cuda.synchronize()
    reset_launch_counts()              # the LOC leg's count
    rates, worst = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(LOC_WINDOWS):
            sm = track(eng.ms, flat, state_T, assoc0, ref).summaries.cpu()
            worst.append(int(sm[:, 34].min()))
        rates.append(LOC_WINDOW * LOC_WINDOWS / (time.perf_counter() - t0))
    by_site = dict(hamming_top2.launches_by_site)
    fps = float(np.median(rates))
    sm = res.summaries.cpu().numpy()
    est_loc = [sm[i, :16].reshape(4, 4) for i in range(LOC_WINDOW)]
    err = ate(est_loc, poses_gt[first:first + LOC_WINDOW])
    print(f"[bench-loc] {LOC_WINDOWS} windows of {LOC_WINDOW} a pass: pass "
          f"fps {[round(f, 3) for f in rates]}, median {fps:.3f} fps = "
          f"{1e3 / fps:.1f} ms/frame; map inliers per frame "
          f"{sm[:, 34].astype(int).tolist()} (fewest in any window "
          f"{min(worst)}), ATE {err:.4f} m over the window; hamming_top2 "
          f"launches {by_site} ({smi})", flush=True)
    if min(worst) < eng.cfg.tracking.local_map_tracking_threshold:
        raise AssertionError(f"bench-loc: a frame tracked only {min(worst)} "
                             f"map inliers")
    if not err < CV2_PROXY_ATE:
        raise AssertionError(f"bench-loc: ATE {err} m")
    # after every timed pass: one LOC window, then the SLAM engine's next
    # window (frames 172-175, tracked and retired), under the profiler
    t_prof = time.perf_counter()
    n_loc, dev_loc, wall_loc, _ = _profiled(
        lambda: track(eng.ms, flat, state_T, assoc0, ref).summaries.cpu())

    def slam_window():
        for i in range(BENCH_FRAMES, BENCH_FRAMES + 4):
            eng.track_stereo(*frames[i], 0.1 * i)
        eng.flush()

    kf0 = eng.stats["kf_inserted"]
    with _no_hamming_syncs() as n_hamming:
        n_slam, dev_slam, wall_slam, syncs = _profiled(slam_window)
    prof_s = time.perf_counter() - t_prof
    print(f"[profile] LOC window of {LOC_WINDOW}: {n_loc / LOC_WINDOW:.0f} "
          f"kernels and {dev_loc / LOC_WINDOW:.1f} ms of device time a "
          f"frame ({wall_loc / LOC_WINDOW:.1f} ms wall under the profiler; "
          f"busy {100 * dev_loc / LOC_WINDOW * fps / 1e3:.1f}% of the "
          f"unprofiled {1e3 / fps:.1f} ms); SLAM window of 4 with "
          f"{eng.stats['kf_inserted'] - kf0} keyframe(s): "
          f"{n_slam / 4:.0f} kernels and {dev_slam / 4:.1f} ms of device "
          f"time a frame ({wall_slam / 4:.1f} ms wall under the profiler), "
          f"{syncs / 4:.2f} cudaStreamSynchronize a frame, none in the "
          f"{n_hamming[0]} Hamming matrix calls checked ({n_hamming[1]} "
          f"made beside another thread); the two profiled windows "
          f"took {prof_s:.1f} s with the traces' reading ({smi})",
          flush=True)
    if n_hamming[0] < 1:
        raise AssertionError(f"profile: no Hamming matrix call checked for "
                             f"syncs ({n_hamming[1]} beside a thread)")
    return by_site, {"loc_fps": fps, "pass_fps": rates}


# phases 13-16: RGB-D, localization mode, the GBA solvers
LOC_NEXT = 12                  # corridor frames tracked in localization mode
RGBD_FRAMES, RGBD_WARMUP, RGBD_STEP = 36, 12, 0.12   # bench.py: 60, 12
GBA_FRAMES = 20


def rgbd_config(capacity=None):
    """The bench camera and widths with ``sensor=RGBD``."""
    from orbslam2_tpu_torch.config import RGBD

    cfg = bench_config()
    return dataclasses.replace(cfg, sensor=RGBD,
                               capacity=capacity or cfg.capacity)


def render_rgbd(world, cam, poses, rng):
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    return render_pool.render_frames(synthetic.render_world, world, cam,
                                     poses, rng, images=1, with_depth=True)


def phase_rgbd_slice(smi):
    """Phase 13: SlamEngine(RGBD, loop closing off) over phase 4's shaken
    corridor, rendered with depth; never lost, ATE < 0.15 m, hamming_top2
    launched from track_ref_kf, and each of those matching calls, replayed
    with the plain version, gives the same output."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cfg = rgbd_config()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses_gt = shaken_trajectory()
    frames = render_rgbd(world, cfg.camera, poses_gt, rng)
    eng = SlamEngine(cfg, enable_loop_closing=False)
    if eng.device.type != "cuda":
        raise AssertionError(f"rgbd: SlamEngine chose {eng.device}")
    records, restore = _record_matches("track_ref_kf")
    ht2.reset_launch_counts()          # the RGB-D path's count
    frame_ms = []
    try:
        for i, (gray, depth) in enumerate(frames):
            t0 = time.perf_counter()
            Tcw = eng.track_rgbd(gray, depth, 0.1 * i)
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            if eng.state != tracking.OK or Tcw is None:
                raise AssertionError(f"rgbd: lost at frame {i}")
            if not np.all(np.isfinite(Tcw)):
                raise AssertionError(f"rgbd: bad pose at frame {i}: {Tcw}")
    finally:
        restore()
    by_site = dict(ht2.hamming_top2.launches_by_site)
    err = ate(eng.frame_poses(), poses_gt)
    same = _replay_plain(records)
    print(f"[rgbd] {N_FRAMES} shaken corridor frames, RGB-D: median "
          f"{np.median(frame_ms[1:]):.1f} ms/frame after frame 0, KFs "
          f"inserted {eng.stats['kf_inserted']}, live map points "
          f"{len(eng.map_points())}, ATE {err:.4f} m; hamming_top2 "
          f"launches by path {by_site}; {len(records)} track_ref_kf "
          f"matching calls replayed with the plain version: equal {same} "
          f"({smi})", flush=True)
    if by_site.get("track_ref_kf", 0) < 1 or not records:
        raise AssertionError("rgbd: track_ref_kf never launched "
                             "hamming_top2")
    if not same:
        raise AssertionError("rgbd: kernel and plain differ on "
                             "track_ref_kf's live input")
    if not err < 0.15:
        raise AssertionError(f"rgbd: ATE {err} m (need < 0.15)")
    return eng, world, rng, poses_gt, by_site, frames


def phase_bench_rgbd(smi):
    """Phase 14: bench.py's RGB-D leg (bench.py:233-262) on the port:
    WindowedSlamEngine(window=4, loop closing on) over RGBD_FRAMES frames
    at step 0.12, 12 warm-up frames, then the rest timed (bench.py: 60
    frames, 48 timed) ending in flush() and a synchronize.  The leg's YAML
    (Config/RealSense-D435i-IRD.yaml of the reference) is not in the
    repository, so the bench camera and widths run with sensor=RGBD; the
    world is the bench's, made from a fresh default_rng(0)."""
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cfg = rgbd_config()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    # one window more for phase 15
    poses_gt = synthetic.straight_trajectory(RGBD_FRAMES + 4, step=RGBD_STEP)
    frames = render_rgbd(world, cfg.camera, poses_gt, rng)
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=4)
    reset_launch_counts()              # the bench RGB-D leg's count
    for i in range(RGBD_WARMUP):
        eng.track_rgbd(*frames[i], i / 30.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RGBD_WARMUP, RGBD_FRAMES):
        eng.track_rgbd(*frames[i], i / 30.0)
    eng.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_site = dict(hamming_top2.launches_by_site)
    est = eng.frame_poses()
    n_lost = sum(T is None for T in est)
    err = ate(est, poses_gt[:RGBD_FRAMES])
    n_timed = RGBD_FRAMES - RGBD_WARMUP
    fps = n_timed / dt
    kf_per_frame = eng.stats["kf_inserted"] / RGBD_FRAMES
    print(f"[bench-rgbd] {RGBD_FRAMES} frames at {RGBD_STEP} m, "
          f"{RGBD_WARMUP} warm-up: {fps:.3f} fps = {1e3 / fps:.1f} ms/frame "
          f"over {n_timed} frames, KFs per frame {kf_per_frame:.4f} (as "
          f"bench.py: inserted over all {RGBD_FRAMES}), live KFs "
          f"{eng.n_kfs}, lost {n_lost}, ATE {err:.4f} m; hamming_top2 "
          f"launches by path {by_site} ({smi})", flush=True)
    if n_lost or not err < 0.15:
        raise AssertionError(f"bench-rgbd: lost {n_lost}, ATE {err}")
    return eng, frames, poses_gt, by_site, {
        "rgbd_fps": fps, "kf_per_frame": kf_per_frame, "ate_m": err}


def phase_localization(eng, world, rng, poses_gt, win, smi):
    """Phase 15: localization mode on phase 13's RGB-D map.  The slice
    ran with loop closing off, so a LoopCloser is attached and each live
    keyframe registered in its DB, as on_keyframe would have done.  The
    engine tracks the next LOC_NEXT corridor frames (the VO path; the
    VO-mode frames are counted), then, set LOST, a re-render of frame
    RELOC_FRAME must relocalize within 0.1 m, launching hamming_top2 from
    reloc_attempt (that call is replayed with the plain version); the map
    must not grow.  Last, phase 14's windowed engine in localization mode
    tracks one window and must insert no keyframe."""
    from orbslam2_tpu_torch.models import vocabulary as voc_mod
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     reset_launch_counts)
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser
    from orbslam2_tpu_torch.utils import synthetic

    cfg = eng.cfg
    lc = LoopCloser(cfg, voc_mod.default_vocabulary(
        k=cfg.capacity.vocab_k, levels=cfg.capacity.vocab_levels),
        eng.device)
    for kf in torch.nonzero(eng.ms.kf_valid).flatten().tolist():
        lc.add_keyframe(eng.ms, kf)
    eng.loop_closer = lc
    eng.localization_only = True

    def map_size():
        return (eng.n_kfs, eng.stats["kf_inserted"],
                int(eng.ms.kf_valid.sum()), int(eng.ms.mp_valid.sum()))

    size0 = map_size()
    body, vo = eng.fns.track_loc_body, []

    def counted(*args):
        res = body(*args)
        vo.append(float(res.summary[39]) < 10)
        return res

    eng.fns = eng.fns._replace(track_loc_body=counted)
    nxt = synthetic.straight_trajectory(N_FRAMES + LOC_NEXT,
                                        step=0.25)[N_FRAMES:]
    frames = render_rgbd(world, cfg.camera, nxt, rng)
    reset_launch_counts()              # the localization path's count
    est, frame_ms = [], []
    for i, (gray, depth) in enumerate(frames):
        t0 = time.perf_counter()
        est.append(eng.track_rgbd(gray, depth, 0.1 * (N_FRAMES + i)))
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    eng.fns = eng.fns._replace(track_loc_body=body)
    n_tracked = sum(T is not None for T in est)
    err = ate(est, nxt) if n_tracked else float("nan")

    T_back = poses_gt[RELOC_FRAME]
    gray, depth = render_rgbd(world, cfg.camera, [T_back], rng)[0]
    eng.state = tracking.LOST
    eng.velocity = None
    attempt, calls = lc.fns.reloc_attempt, []

    def recorded(*args):
        calls.append((args, args[-1].get_state()))
        return attempt(*args)

    lc.fns = lc.fns._replace(reloc_attempt=recorded)
    try:
        Tcw = eng.track_rgbd(gray, depth, 99.0)
        torch.cuda.synchronize()
    finally:
        lc.fns = lc.fns._replace(reloc_attempt=attempt)
    by_site = dict(hamming_top2.launches_by_site)
    if Tcw is None:
        raise AssertionError("localization: the engine did not relocalize")
    d = float(np.linalg.norm(-Tcw[:3, :3].T @ Tcw[:3, 3]
                             + T_back[:3, :3].T @ T_back[:3, 3]))
    grew = map_size() != size0

    # the windowed engine: one window in localization mode
    kf0, n0 = win["eng"].stats["kf_inserted"], win["eng"].n_kfs
    win["eng"].localization_only = True
    track, windows = win["eng"].f_track_window, []
    win["eng"].f_track_window = lambda *a: windows.append(1) or track(*a)
    for i in range(RGBD_FRAMES, RGBD_FRAMES + 4):
        win["eng"].track_rgbd(*win["frames"][i], i / 30.0)
    win["eng"].flush()
    torch.cuda.synchronize()
    win["eng"].f_track_window = track
    win_est = win["eng"].frame_poses()[RGBD_FRAMES:]
    win_ok = (win["eng"].stats["kf_inserted"] == kf0
              and win["eng"].n_kfs == n0 and len(windows) == 1)
    print(f"[localization] {LOC_NEXT} corridor frames past the map: "
          f"tracked {n_tracked}, {sum(vo)} in VO mode, ATE {err:.4f} m, "
          f"median {np.median(frame_ms):.1f} ms/frame; LOST → relocalized "
          f"on a re-render of frame {RELOC_FRAME}: centre error {d:.4f} m; "
          f"map (live KFs, KFs inserted, KF slots, points) {size0} → "
          f"{map_size()}; windowed engine, one window: KFs inserted "
          f"{kf0} → {win['eng'].stats['kf_inserted']}, ATE "
          f"{ate(win_est, win['poses'][RGBD_FRAMES:]):.4f} m; hamming_top2 "
          f"launches by path {by_site} ({smi})", flush=True)
    if grew:
        raise AssertionError(f"localization: the map grew {size0} → "
                             f"{map_size()}")
    if not d < 0.1:
        raise AssertionError(f"localization: centre error {d} m")
    if by_site.get("reloc_attempt", 0) < 1:
        raise AssertionError("localization: reloc_attempt never launched "
                             "hamming_top2")
    if not win_ok:
        raise AssertionError("localization: the windowed engine inserted "
                             "a keyframe or tracked no window")
    live_reloc_call(eng, attempt, *calls[-1])
    return by_site, {"vo_frames": sum(vo), "tracked": n_tracked}


def phase_gba_solvers(smi):
    """Phase 16: one GBA chunk (5 robust LM iterations) on an RGB-D map of
    the default CapacityConfig() (512 keyframe slots, 32,768 points; the
    first GBA_FRAMES corridor frames), its keyframes (but the gauge) and
    points perturbed from a seeded generator so that the chunk has work
    to do: through the CG solver (gba_chunk's choice past 256 slots), then
    forced through the dense Schur solve (the port's path before CG).
    Each is run once warm-up and once timed (CUDA events), with its peak
    device memory.  Poses agree within 1e-4, points nearer than 20 m from
    the gauge camera within 1e-3 m, all within 2e-2 of their range (far
    stereo depth is barely observed).  Then one CG solve is profiled at 8
    and 16 steps: kernels and device ms per CG step."""
    from orbslam2_tpu_torch.config import CapacityConfig
    from orbslam2_tpu_torch.ops import bundle
    from orbslam2_tpu_torch.runtime import gba
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import lie, synthetic

    cfg = rgbd_config(CapacityConfig())
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses_gt = synthetic.straight_trajectory(GBA_FRAMES, step=0.25)
    eng = SlamEngine(cfg, enable_loop_closing=False)
    for i, (gray, depth) in enumerate(render_rgbd(world, cfg.camera,
                                                  poses_gt, rng)):
        if eng.track_rgbd(gray, depth, 0.1 * i) is None:
            raise AssertionError(f"gba: lost at frame {i}")
    ms, dev = eng.ms, eng.device
    K, N, P = ms.K, ms.N, ms.P
    g = torch.Generator(device=dev).manual_seed(1)
    moved = ms.kf_valid.clone()
    moved[0] = False
    xi = torch.randn(K, 6, device=dev, generator=g) * torch.tensor(
        [0.01] * 3 + [0.05] * 3, device=dev)
    ms = ms._replace(
        kf_pose=torch.where(moved[:, None, None],
                            lie.se3_exp(xi) @ ms.kf_pose, ms.kf_pose),
        mp_pos=ms.mp_pos + 0.05 * torch.randn(
            ms.mp_pos.shape, device=dev, generator=g)
        * ms.mp_valid[:, None])
    obs = torch.ones(K * N, dtype=torch.bool, device=dev)
    chunk, _ = gba.make_gba_fns(cfg)
    ba = bundle.bundle_adjust

    def run(solver):
        if solver == "dense":
            bundle.bundle_adjust = lambda *a, **k: ba(*a, **{**k,
                                                           "solver": "dense"})
        try:
            chunk(ms, obs, True)                       # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out, _ = chunk(ms, obs, True)
            b.record()
            b.synchronize()
        finally:
            bundle.bundle_adjust = ba
        return (out, a.elapsed_time(b),
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)

    solves = []
    cg_solve = bundle._schur_solve_cg

    def counting(*args):
        solves.append(1)
        return cg_solve(*args)

    bundle._schur_solve_cg = counting
    try:
        out_cg, ms_cg, gib_cg = run("cg")
    finally:
        bundle._schur_solve_cg = cg_solve
    n_solves = len(solves) // 2                  # warm-up and timed
    out_d, ms_d, gib_d = run("dense")
    kv, pv = ms.kf_valid, ms.mp_valid
    pose_gap, near_gap, rel_gap, n_near = _map_gaps(cfg, ms, out_cg, out_d)

    per_step, top = {}, []

    def probe(*args):
        if not per_step:
            for n in (8, 16):
                k, dev_ms, _, _ = _profiled(
                    lambda: cg_solve(*args[:-1], n))
                per_step[n] = (k, dev_ms)
            top.extend(_top_kernels(lambda: cg_solve(*args[:-1], 16)))
        return cg_solve(*args)

    bundle._schur_solve_cg = probe
    try:
        chunk(ms, obs, True)
    finally:
        bundle._schur_solve_cg = cg_solve
    k_step = (per_step[16][0] - per_step[8][0]) / 8
    ms_step = (per_step[16][1] - per_step[8][1]) / 8
    print(f"[gba] one robust chunk at {K} KF slots ({int(kv.sum())} live), "
          f"{P} point slots ({int(pv.sum())} live), {K * N} observation "
          f"rows: CG {ms_cg:.1f} ms, peak +{gib_cg:.3f} GiB ({n_solves} "
          f"CG solves of 48 steps); dense {ms_d:.1f} ms, peak +{gib_d:.3f} "
          f"GiB; |Δpose| {pose_gap:.2e}, points nearer than 20 m "
          f"|Δ| {near_gap:.2e} m ({n_near}), all |Δ|/range "
          f"{rel_gap:.2e}; a CG step: {k_step:.1f} kernels, {ms_step:.4f} "
          f"ms of device time (torch.profiler, 16 vs 8 steps); a 16-step "
          f"solve's top kernels by device ms {top} ({smi})", flush=True)
    if not solves:
        raise AssertionError("gba: the chunk did not take the CG solver")
    if not _within_gba_bars(pose_gap, near_gap, rel_gap):
        raise AssertionError(f"gba: CG and dense differ: poses {pose_gap}, "
                             f"near points {near_gap} m, relative "
                             f"{rel_gap}")
    return {"cg_ms": ms_cg, "dense_ms": ms_d, "cg_gib": gib_cg,
            "dense_gib": gib_d, "kernels_per_cg_step": k_step,
            "device_ms_per_cg_step": ms_step,
            # phase 23 runs the same chunk sharded on this map
            "case": {"cfg": cfg, "ms": ms, "out_cg": out_cg}}


def _map_gaps(cfg, ms, a, b):
    """How far two BA results ``a`` and ``b`` of the map ``ms`` lie apart:
    the largest pose entry difference over live keyframes, the largest
    point gap (m) among live points nearer than th_depth · baseline (20 m)
    to the gauge camera, the largest gap relative to the range, and the
    count of near points."""
    from orbslam2_tpu_torch.utils import lie

    kv, pv = ms.kf_valid, ms.mp_valid
    pose_gap = float(torch.max(torch.abs(a.kf_pose[kv] - b.kf_pose[kv])))
    c0 = lie.se3_inv(ms.kf_pose[0])[:3, 3]
    xa, xb = a.mp_pos[pv], b.mp_pos[pv]
    gap = torch.linalg.norm(xa - xb, dim=1)
    rng_m = torch.linalg.norm(xb - c0, dim=1)
    near = rng_m < cfg.camera.th_depth * cfg.camera.baseline
    near_gap = float(gap[near].max()) if bool(near.any()) else 0.0
    return pose_gap, near_gap, float((gap / rng_m).max()), int(near.sum())


def _within_gba_bars(pose_gap, near_gap, rel_gap):
    """Phase 16's bars: poses within 1e-4, points nearer than 20 m within
    1e-3 m, all within 2e-2 of their range (far stereo depth is barely
    observed)."""
    return pose_gap < 1e-4 and near_gap < 1e-3 and rel_gap < 2e-2


# phases 17-18: mono (tests/test_mono.py:81-107; bench.py:199-231)
MONO_FRAMES = 25
MONO_PASS, MONO_WARMUP = 48, 28


def mono_config(n_features=1000):
    """The bench camera and capacity with ``sensor=MONOCULAR``."""
    from orbslam2_tpu_torch.config import MONOCULAR, OrbConfig

    return dataclasses.replace(bench_config(), sensor=MONOCULAR,
                               orb=OrbConfig(n_features=n_features))


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def mono_ate(eng, poses_gt):
    """Similarity-aligned ATE (mono has no scale) over the frames that have
    a trajectory entry, from the one that initialized on, and their
    count."""
    from orbslam2_tpu_torch.utils import trajectory

    entries = eng.trajectory
    pairs = [(Te, Tg) for Te, Tg, e in zip(
        eng.frame_poses(), poses_gt[len(poses_gt) - len(entries):], entries)
        if Te is not None and not e.lost]
    est = trajectory.centers_from_poses([Te for Te, _ in pairs])
    gt = trajectory.centers_from_poses([Tg for _, Tg in pairs])
    return trajectory.ate_rmse(est, gt, align=True, with_scale=True), \
        len(pairs)


def phase_mono_slice(smi):
    """Phase 17: SlamEngine(MONOCULAR, loop closing off) over
    tests/test_mono.py's scene and sideways walk (25 frames at (0.3 i, 0,
    0.1 i)), at the bench's 640×480, 128 keyframes and 16k points, with
    that test's 2000 features: at 1000 features this scene gives 36-60
    SearchForInitialization matches a frame pair, under the bootstrap's
    100, and neither package initializes.  Per-layer ms of the bootstrap
    (SearchForInitialization, the H/F initializer, mono_build, which
    holds the initializer, and the initial local BA) and of the frames
    after it; the engine must end OK with a similarity-aligned ATE under
    0.03 × the path length (the test's own bar); every track_ref_kf
    matching call is replayed with the plain version."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.ops import initializer
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    cfg = mono_config(n_features=2000)
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, 1800, extent=(14.0, 9.0, 9.0),
                                 z_near=2.5)
    poses_gt = [synthetic.look_ahead_pose(np.array([0.3 * i, 0.0, 0.1 * i]))
                for i in range(MONO_FRAMES)]
    frames = [_u8(f) for f in render_pool.render_frames(
        synthetic.render, scene, cfg.camera, poses_gt, rng, images=1)]
    eng = SlamEngine(cfg, enable_loop_closing=False)
    if eng.device.type != "cuda":
        raise AssertionError(f"mono: SlamEngine chose {eng.device}")
    layers = {name: [] for name in (
        "search_for_initialization", "initialize_mono", "mono_build",
        "local_ba (bootstrap)", "track_body", "track_ref_kf",
        "mapping_step")}
    fns = eng.fns
    eng.fns = fns._replace(
        mono_match=_timed(fns.mono_match, layers["search_for_initialization"]),
        mono_build=_timed(fns.mono_build, layers["mono_build"]),
        track_body=_timed(fns.track_body, layers["track_body"]),
        track_ref_kf=_timed(fns.track_ref_kf, layers["track_ref_kf"]))
    eng.mapping_fns.local_ba = _timed(eng.mapping_fns.local_ba,
                                      layers["local_ba (bootstrap)"])
    eng.f_mapping_step = _timed(eng.f_mapping_step, layers["mapping_step"])
    init_fn, inits = initializer.initialize_mono, []

    def init_timed(*args, **kwargs):
        res = _timed(init_fn, layers["initialize_mono"])(*args, **kwargs)
        inits.append(res)
        return res

    initializer.initialize_mono = init_timed
    records, restore = _record_matches("track_ref_kf")
    ht2.reset_launch_counts()          # the mono slice's count
    frame_ms, first = [], None
    try:
        for i, img in enumerate(frames):
            t0 = time.perf_counter()
            Tcw = eng.track_monocular(img, 0.1 * i)
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            if Tcw is not None:
                if Tcw.shape != (4, 4) or not np.all(np.isfinite(Tcw)):
                    raise AssertionError(f"mono: bad pose at frame {i}")
                if first is None:
                    first = i
                    n_boot = eng.stats["mp_created"]
    finally:
        restore()
        initializer.initialize_mono = init_fn
    by_site = dict(ht2.hamming_top2.launches_by_site)
    eng.fns = fns
    if first is None:
        raise AssertionError(f"mono: never initialized ({eng.stats})")
    used_h = bool(inits[-1].used_h)
    err, n_tracked = mono_ate(eng, poses_gt)
    path = 0.32 * MONO_FRAMES          # tests/test_mono.py:116
    same = _replay_plain(records)
    print(f"[mono] {MONO_FRAMES} frames of tests/test_mono.py's scene at "
          f"{cfg.orb.n_features} features: initialized at frame {first} "
          f"after {len(inits)} initializer run(s), model "
          f"{'H' if used_h else 'F'} (used_h {used_h}), {n_boot} bootstrap "
          f"points; state {eng.state}, tracked {n_tracked}, KFs inserted "
          f"{eng.stats['kf_inserted']}, live map points "
          f"{len(eng.map_points())}; median {np.median(frame_ms):.1f} "
          f"ms/frame, after the bootstrap "
          f"{np.median(frame_ms[first + 1:]):.1f} ms; similarity-aligned "
          f"ATE {err:.4f} m (bar {0.03 * path:.3f}); track_ref_kf launches "
          f"{by_site.get('track_ref_kf', 0)} (by path {by_site}), "
          f"{len(records)} matching calls replayed with the plain version: "
          f"equal {same} ({smi})", flush=True)
    for name, ms in layers.items():
        if ms:
            print(f"[mono] layer {name}: {len(ms)} calls, median "
                  f"{np.median(ms):.1f} ms, total {np.sum(ms):.0f} ms "
                  f"({smi})", flush=True)
    if eng.state != tracking.OK:
        raise AssertionError(f"mono: the engine ended in state {eng.state}")
    if not err < 0.03 * path:
        raise AssertionError(f"mono: ATE {err} m (need < {0.03 * path})")
    if not same:
        raise AssertionError("mono: kernel and plain differ on "
                             "track_ref_kf's live input")
    return by_site, {"first": first, "used_h": used_h, "ate_m": err,
                     "ms": float(np.median(frame_ms[first + 1:]))}


def phase_bench_mono(smi):
    """Phase 18: bench.py's mono leg (bench.py:199-231) on the port:
    WindowedSlamEngine(MONOCULAR, window=4), loop closing on, the bench
    world rendered gray along look_ahead_pose((0.18 i, 0, 0.04 i)), 28
    warm-up frames, then two passes of 48, each ending in flush() and a
    synchronize.  The world and frames come from a fresh default_rng(0)
    (bench.py continues its stereo leg's generator).  fps per pass, ms
    and keyframes a frame (bench.py's mono_kf_per_frame: inserted over
    all frames), loops closed, the similarity-aligned ATE, launches by
    site, every matching call that launched the kernel (track_ref_kf per
    frame or in a window, match_for_sim3, reloc_attempt) replayed with the
    plain version; then one more window under torch.profiler.  The engine
    must not end LOST."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime import tracking
    from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    cfg = mono_config()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    n_m = MONO_WARMUP + 2 * MONO_PASS
    # the leg's frames, then one window more for the profile
    poses_gt = [synthetic.look_ahead_pose(np.array([0.18 * i, 0.0, 0.04 * i]))
                for i in range(n_m + 4)]
    t0 = time.perf_counter()
    frames = [_u8(f) for f in render_pool.render_frames(
        synthetic.render_world, world, cfg.camera, poses_gt, rng, images=1)]
    render_s = time.perf_counter() - t0
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=4)
    if eng.device.type != "cuda":
        raise AssertionError(f"bench-mono: the engine chose {eng.device}")
    records, restore = _record_matches(
        "track_ref_kf", "window/track_ref_kf", "match_for_sim3",
        "reloc_attempt")
    ht2.reset_launch_counts()          # the bench mono leg's count
    try:
        for i in range(MONO_WARMUP):
            eng.track_monocular(frames[i], 0.1 * i)
        torch.cuda.synchronize()
        pass_fps, kf_counts, start = [], [], MONO_WARMUP
        for _ in range(2):
            kf0 = eng.stats["kf_inserted"]
            t0 = time.perf_counter()
            for i in range(start, start + MONO_PASS):
                eng.track_monocular(frames[i], 0.1 * i)
            eng.flush()
            torch.cuda.synchronize()
            pass_fps.append(MONO_PASS / (time.perf_counter() - t0))
            kf_counts.append(eng.stats["kf_inserted"] - kf0)
            start += MONO_PASS
    finally:
        restore()
    by_site = dict(ht2.hamming_top2.launches_by_site)
    kf_per_frame = eng.stats["kf_inserted"] / n_m
    err, n_tracked = mono_ate(eng, poses_gt[:n_m])
    state = eng.state
    same = _replay_plain(records)

    def window():
        for i in range(n_m, n_m + 4):
            eng.track_monocular(frames[i], 0.1 * i)
        eng.flush()

    kf0 = eng.stats["kf_inserted"]
    n_k, dev_ms, wall_ms, _ = _profiled(window)
    fps = float(np.median(pass_fps))
    print(f"[bench-mono] {n_m} frames (rendered with 4 more in "
          f"{render_s:.1f} s): pass fps {[round(f, 3) for f in pass_fps]}, "
          f"median {fps:.3f} fps = {1e3 / fps:.1f} ms/frame, KFs per frame "
          f"{kf_per_frame:.4f} (as bench.py: inserted over all {n_m}; per "
          f"pass {kf_counts}), live KFs {eng.n_kfs}, loops closed "
          f"{eng.stats['loops_closed']}, relocalized "
          f"{eng.stats['reloc']}, tracked {n_tracked}, state {state}, "
          f"similarity-aligned ATE {err:.4f} m; hamming_top2 launches by "
          f"path {by_site}, {len(records)} matching calls replayed with the "
          f"plain version: equal {same}; one window of 4 under the profiler "
          f"({eng.stats['kf_inserted'] - kf0} keyframe(s)): "
          f"{n_k / 4:.0f} kernels and {dev_ms / 4:.1f} ms of device time a "
          f"frame ({wall_ms / 4:.1f} ms wall under the profiler; busy "
          f"{100 * dev_ms / 4 * fps / 1e3:.1f}% of the unprofiled "
          f"{1e3 / fps:.1f} ms) ({smi})", flush=True)
    if state == tracking.LOST:
        raise AssertionError("bench-mono: the engine ended LOST")
    if not same:
        raise AssertionError("bench-mono: kernel and plain differ on a "
                             "live matching call")
    return by_site, {"mono_fps": fps, "pass_fps": pass_fps,
                     "kf_per_frame": kf_per_frame, "ate_m": err}


# phase 19: the System facade (orbslam2_tpu_torch/runtime/system.py)
SYS_FRAMES, SYS_RELOC_FRAME = 24, 8
SYS_CALIB_FRAMES, IRD_FRAMES, REPLAY_FRAMES = 4, 6, 12
IRD_BAR = 0.15                 # HPose world position against the truth, m


def _write_settings(path, cam):
    """A settings file with ``cam``'s intrinsics, in the form of
    tests/test_system.py:163-175."""
    with open(path, "w") as f:
        f.write(f"%YAML:1.0\nCamera.fx: {cam.fx}\nCamera.fy: {cam.fy}\n"
                f"Camera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
                f"Camera.bf: {cam.bf}\nCamera.fps: {cam.fps}\n"
                f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n"
                f"ThDepth: {cam.th_depth}\n")


def phase_system(smi, frames):
    """Phase 19: the public entry point.  System(STEREO) at the bench widths
    (loop closing on; no device given) over the first SYS_FRAMES frames
    of phase 4's shaken corridor (``frames``); the three trajectory
    savers; the pose covariance, also in TrackIRD's world frame; the map
    saved and read back on the card bit for bit; a fresh System with
    ``map_file`` set starts LOST in localization mode and relocalizes a
    re-render of frame SYS_RELOC_FRAME within 0.1 m (hamming_top2 from
    reloc_attempt), and one more frame leaves the map as it was;
    change_calibration to slightly other intrinsics, then SYS_CALIB_FRAMES
    frames more; System(RGBD).track_ird over IRD_FRAMES frames of phase
    13's depth corridor (HPose within IRD_BAR of the truth remapped as
    System.cc:298-319); tools.replay.run_synthetic_stereo at the default
    capacity.  The reloc_attempt call and every track_ref_kf matching
    call are replayed with the plain version afterwards."""
    import os
    import tempfile

    from orbslam2_tpu_torch.config import RGBD, STEREO
    from orbslam2_tpu_torch.models import map_state as M
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime import serialization, tracking
    from orbslam2_tpu_torch.runtime.system import System
    from orbslam2_tpu_torch.tools import replay as replay_mod
    from orbslam2_tpu_torch.utils import synthetic

    cfg = bench_config()
    poses_gt = shaken_trajectory()
    world = synthetic.make_world(np.random.default_rng(0))  # phase 4's
    rng = np.random.default_rng(19)
    records, restore = _record_matches("track_ref_kf")
    ht2.reset_launch_counts()          # the System path's count
    sys1 = System(None, None, STEREO, config=cfg)
    if sys1.device.type != "cuda":
        raise AssertionError(f"system: System chose {sys1.device}")
    frame_ms = []
    try:
        for i, (left, right) in enumerate(frames):
            t0 = time.perf_counter()
            Tcw = sys1.track_stereo(left, right, 0.1 * i)
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            if Tcw is None or sys1.get_tracking_state() != tracking.OK:
                raise AssertionError(f"system: lost at frame {i}")
    finally:
        restore()
    err = ate(sys1.engine.frame_poses(), poses_gt[:len(frames)])
    if not err < 0.15:
        raise AssertionError(f"system: ATE {err} m (need < 0.15)")

    cov = sys1.get_current_covariance()
    cov_w = sys1.get_current_covariance_world()
    eig = np.linalg.eigvalsh((cov + cov.T) / 2)
    cov_ok = (cov.shape == cov_w.shape == (6, 6)
              and np.allclose(cov, cov.T, rtol=0,
                              atol=1e-4 * np.abs(cov).max())
              and eig.min() >= -1e-8
              and np.allclose(np.sort(np.linalg.eigvalsh(cov_w)),
                              np.sort(np.linalg.eigvalsh(cov)), rtol=1e-4))
    if not cov_ok:
        raise AssertionError(f"system: covariance {cov}, eigenvalues {eig}")

    eng1 = sys1.engine
    with tempfile.TemporaryDirectory() as tmp:
        lines = {}
        for name, save in (("TUM", sys1.save_trajectory_tum),
                           ("KITTI", sys1.save_trajectory_kitti),
                           ("keyframe TUM",
                            sys1.save_keyframe_trajectory_tum)):
            path = os.path.join(tmp, name.replace(" ", "_") + ".txt")
            save(path)
            with open(path) as f:
                lines[name] = len(f.read().splitlines())
        want = {"TUM": len(frames), "KITTI": len(frames),
                "keyframe TUM": int(eng1.ms.kf_valid.sum())}
        if lines != want:
            raise AssertionError(f"system: trajectory lines {lines}, "
                                 f"want {want}")

        map_path = os.path.join(tmp, "map.npz")
        t0 = time.perf_counter()
        sys1.save_map(map_path)
        save_ms = 1e3 * (time.perf_counter() - t0)
        mb = os.path.getsize(map_path) / 1e6
        with open(map_path, "rb") as f:
            map_npz = f.read()             # phase 23 loads it again
        t0 = time.perf_counter()
        ms, db, counters = serialization.load_map(map_path)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        same = (ms.kf_desc.is_cuda and db.bow.is_cuda
                and all(torch.equal(getattr(ms, k), getattr(eng1.ms, k))
                        for k in M.MapState._fields)
                and torch.equal(db.bow, eng1.loop_closer.db.bow)
                and torch.equal(db.valid, eng1.loop_closer.db.valid)
                and counters == {"n_kfs": eng1.n_kfs,
                                 "kf_ordinal": eng1.kf_ordinal,
                                 "frame_id": eng1.frame_id})
        if not same:
            raise AssertionError("system: the map read back differs from "
                                 "the one saved")
        t0 = time.perf_counter()
        sys2 = System(None, None, STEREO,
                      config=cfg.replace(map_file=map_path))
        torch.cuda.synchronize()
        start_ms = 1e3 * (time.perf_counter() - t0)
    eng2 = sys2.engine
    if not (sys2.get_tracking_state() == tracking.LOST
            and eng2.localization_only):
        raise AssertionError("system: a System with map_file did not start "
                             "LOST in localization mode")

    lc = eng2.loop_closer
    attempt, calls = lc.fns.reloc_attempt, []

    def recorded(*args):
        calls.append((args, args[-1].get_state()))
        return attempt(*args)

    lc.fns = lc.fns._replace(reloc_attempt=recorded)
    T_back = poses_gt[SYS_RELOC_FRAME]
    t0 = time.perf_counter()
    try:
        Tcw = sys2.track_stereo(*synthetic.render_world_stereo(
            world, cfg.camera, T_back, rng, 1.0), 99.0)
        torch.cuda.synchronize()
    finally:
        lc.fns = lc.fns._replace(reloc_attempt=attempt)
    reloc_ms = 1e3 * (time.perf_counter() - t0)
    reloc_launches = ht2.hamming_top2.launches_by_site.get("reloc_attempt",
                                                           0)
    if Tcw is None or eng2.stats["reloc"] != 1:
        raise AssertionError("system: no relocalization on the loaded map")
    Te = Tcw @ poses_gt[0]
    d = float(np.linalg.norm(-Te[:3, :3].T @ Te[:3, 3]
                             + T_back[:3, :3].T @ T_back[:3, 3]))
    if not d < 0.1:
        raise AssertionError(f"system: relocalized {d} m off (need < 0.1)")
    if reloc_launches < 1:
        raise AssertionError("system: reloc_attempt never launched "
                             "hamming_top2")
    kfs = (eng2.n_kfs, eng2.stats["kf_inserted"])
    after = sys2.track_stereo(*synthetic.render_world_stereo(
        world, cfg.camera, poses_gt[SYS_RELOC_FRAME + 1], rng, 1.0), 99.1)
    if (eng2.n_kfs, eng2.stats["kf_inserted"]) != kfs:
        raise AssertionError("system: the map grew in localization mode")

    cam2 = dataclasses.replace(cfg.camera, fx=455.0, fy=455.0, cx=318.0,
                               cy=242.0, bf=151.0)
    with tempfile.TemporaryDirectory() as tmp:
        settings = os.path.join(tmp, "calibration.yaml")
        _write_settings(settings, cam2)
        n_kfs = sys1.engine.n_kfs
        sys1.change_calibration(settings)
    if sys1.cfg.camera.fx != cam2.fx or sys1.engine.n_kfs != n_kfs:
        raise AssertionError("system: change_calibration lost the map or "
                             "the new camera")
    for i in range(len(frames), len(frames) + SYS_CALIB_FRAMES):
        out = sys1.track_stereo(*synthetic.render_world_stereo(
            world, cam2, poses_gt[i], rng, 1.0), 0.1 * i)
        if out is None or sys1.get_tracking_state() != tracking.OK:
            raise AssertionError(f"system: lost at frame {i} after "
                                 f"change_calibration")

    rcfg = rgbd_config()
    sys3 = System(None, None, RGBD, config=rcfg)
    ird_err = []
    for i, (gray, depth) in enumerate(render_rgbd(
            world, rcfg.camera, poses_gt[:IRD_FRAMES], rng)):
        hp = sys3.track_ird(gray, depth, 0.1 * i)
        if hp is None:
            raise AssertionError(f"system: track_ird lost at frame {i}")
        Tg = poses_gt[i] @ np.linalg.inv(poses_gt[0])
        c = -Tg[:3, :3].T @ Tg[:3, 3]
        ird_err.append(float(np.linalg.norm(
            hp.position - np.array([c[2], -c[0], -c[1]]))))
    if not max(ird_err) < IRD_BAR:
        raise AssertionError(f"system: HPose {max(ird_err)} m off")

    t0 = time.perf_counter()
    rep = replay_mod.run_synthetic_stereo(n_frames=REPLAY_FRAMES)
    replay_s = time.perf_counter() - t0
    if rep.n_frames != REPLAY_FRAMES or rep.n_tracked != REPLAY_FRAMES:
        raise AssertionError(f"system: replay tracked {rep.n_tracked} of "
                             f"{rep.n_frames} frames")
    by_site = dict(ht2.hamming_top2.launches_by_site)

    same_ref = _replay_plain(records)
    print(f"[system] System.track_stereo over {len(frames)} shaken "
          f"corridor frames: median {np.median(frame_ms[1:]):.1f} ms/frame "
          f"after frame 0, KFs inserted {eng1.stats['kf_inserted']}, ATE "
          f"{err:.4f} m; trajectory lines {lines}; covariance eigenvalues "
          f"{eig.min():.3g}..{eig.max():.3g}, world frame equal spectrum; "
          f"{len(records)} track_ref_kf matching calls replayed with the "
          f"plain version: equal {same_ref} ({smi})", flush=True)
    print(f"[system] save_map {save_ms:.1f} ms, {mb:.3f} MB; load_map "
          f"{load_ms:.1f} ms (read back bit for bit: {same}); System with "
          f"map_file {start_ms:.1f} ms; relocalized a re-render of frame "
          f"{SYS_RELOC_FRAME} within {d:.4f} m in {reloc_ms:.1f} ms, the "
          f"next frame {'tracked' if after is not None else 'lost'}, map "
          f"unchanged ({smi})", flush=True)
    print(f"[system] change_calibration (fx {cfg.camera.fx} → {cam2.fx}): "
          f"KFs kept {n_kfs}, {SYS_CALIB_FRAMES} frames tracked after; "
          f"track_ird over {IRD_FRAMES} RGB-D frames: HPose world position "
          f"within {max(ird_err):.4f} m; replay driver "
          f"(run_synthetic_stereo, CapacityConfig(), {REPLAY_FRAMES} "
          f"frames): median {rep.median_ms:.1f} ms, mean {rep.mean_ms:.1f} "
          f"ms, tracked {rep.n_tracked}/{rep.n_frames}, {replay_s:.1f} s "
          f"with rendering; hamming_top2 launches by path {by_site} ({smi})",
          flush=True)
    if not same_ref:
        raise AssertionError("system: kernel and plain differ on "
                             "track_ref_kf's live input")
    live_reloc_call(eng2, attempt, *calls[-1])
    return by_site, {"ms": float(np.median(frame_ms[1:])),
                     "save_ms": save_ms, "load_ms": load_ms, "mb": mb,
                     "replay_median_ms": rep.median_ms,
                     "replay_mean_ms": rep.mean_ms, "map_npz": map_npz}


# phase 20: the async pipeline (orbslam2_tpu_torch/runtime/pipeline.py)
ASYNC_PROFILED = 8             # the corridor's last frames, profiled
# phase 6's orbit run on at its step to 86 frames (~1.5 turns): the async
# engine's keyframes are denser than the sync engine's (tracking sees a
# queued keyframe's points only once the worker publishes it), and its
# loop is detected later: at frames 58-71 of the 72, against the sync
# engine's 59 (orbslam2_tpu_torch/tools/async_orbit_spread.py; PERF.md §6,
# ROADMAP Queue 3)
ASYNC_ORBIT_EXTRA = 14
RECTIFY_W, RECTIFY_H, RECTIFY_TOL = 752, 480, 1e-3


def _spy_async(eng):
    """Wrap the async engine's hooks: keyframe decisions and whether they
    met a busy mapper, jobs queued and the queue's depth after each push,
    jobs mapped and their ba_ok, mapping-step ms (the worker's stream
    synchronized), and the thread each tracking / loop-matching call ran
    on."""
    import threading

    log = {"idle": [], "depth": [], "ba_ok": [], "map_ms": [],
           "threads": {}}
    idle, create, run = (eng._mapper_idle, eng._create_keyframe,
                         eng._run_mapping_step)
    step = eng.f_mapping_step

    def mapper_idle():
        out = idle()
        log["idle"].append(out)
        return out

    def create_keyframe(*args):
        create(*args)
        log["depth"].append(eng.kf_queue.size())

    def run_mapping_step(*args, **kwargs):
        log["ba_ok"].append(kwargs["ba_ok"])
        return run(*args, **kwargs)

    def mapping_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.current_stream().synchronize()     # the worker's stream
        log["map_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    def on_thread(name, fn):
        def call(*args, **kwargs):
            log["threads"].setdefault(name, set()).add(
                threading.current_thread().name)
            return fn(*args, **kwargs)
        return call

    eng._mapper_idle = mapper_idle
    eng._create_keyframe = create_keyframe
    eng._run_mapping_step = run_mapping_step
    eng.f_mapping_step = mapping_step
    eng.fns = eng.fns._replace(track_ref_kf=on_thread(
        "track_ref_kf", eng.fns.track_ref_kf))
    lc = eng.loop_closer
    lc.fns = lc.fns._replace(match_for_sim3=on_thread(
        "match_for_sim3", lc.fns.match_for_sim3))
    return log


def _stop_worker(eng):
    """After a failure before ``shutdown``: end the mapping worker, so that
    the script exits with its error and no thread left running."""
    if eng._worker is not None and eng._worker.is_alive():
        eng._running = False
        eng.kf_queue.close()
        eng._worker.join(timeout=120)


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(u, v):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(u) and j < len(v):
        total += max(0.0, min(u[i][1], v[j][1]) - max(u[i][0], v[j][0]))
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total


def _profile_streams(eng, fn):
    """One call of ``fn`` under torch.profiler: kernels and device ms per
    CUDA stream, and the device ms during which the tracking stream and
    the worker's stream both had work in flight.  Spin kernels launched
    on the worker's stream before and after ``fn`` mark that stream in
    the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def marker():
        with torch.cuda.stream(eng._stream):
            torch.cuda._sleep(1000)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker()
        t0 = time.perf_counter()
        fn()
        marker()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per = {}
    worker = None
    # the raw device events: prof.events() builds a tree over the window's
    # ~500k events first, which takes longer than the window itself
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        sid = e.device_resource_id()
        if "spin_kernel" in e.name():
            worker = sid
            continue
        t_us = e.start_ns() / 1e3
        per.setdefault(sid, []).append((t_us, t_us + e.duration_ns() / 1e3))
    if worker is None:
        raise AssertionError(f"async: the marker kernel on the worker's "
                             f"stream is not in the trace (device events "
                             f"on streams {sorted(per)})")
    ranked = sorted(per, key=lambda k: -sum(b - a for a, b in per[k]))
    tracking = next(k for k in ranked if k != worker)
    # 0 when the worker mapped nothing in the window
    both_ms = _overlap(_union(per[tracking]),
                       _union(per.get(worker, []))) / 1e3
    streams = {("worker" if k == worker else "tracking" if k == tracking
                else f"stream {k}"): (len(per[k]),
                                      sum(b - a for a, b in per[k]) / 1e3)
               for k in ranked}
    return streams, both_ms, wall_ms


def _new_async_engine():
    from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine

    eng = AsyncSlamEngine(bench_config())     # loop closing on, the card
    if eng.device.type != "cuda" or eng._stream is None:
        raise AssertionError(f"async: the engine chose {eng.device}, "
                             f"worker stream {eng._stream}")
    return eng


def phase_async(smi, frames, slice_ms):
    """Phase 20 (a): AsyncSlamEngine over phase 4's jolted corridor
    (``frames``), every frame timed, no profiler."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime import native, tracking

    eng = _new_async_engine()
    log = _spy_async(eng)
    records, restore = _record_matches("track_ref_kf")
    frame_ms = []
    ht2.reset_launch_counts()          # the async corridor's count
    t_start = time.perf_counter()
    eng.start()
    try:
        for i, (left, right) in enumerate(frames):
            t0 = time.perf_counter()
            Tcw = eng.track_stereo(left, right, 0.1 * i)
            torch.cuda.current_stream().synchronize()   # the tracking stream
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            if Tcw is None or eng.state != tracking.OK:
                raise AssertionError(f"async: lost at frame {i}")
        t_shut = time.perf_counter()
        eng.shutdown()
        torch.cuda.synchronize()
    finally:
        restore()
        _stop_worker(eng)
    t_end = time.perf_counter()
    by_site = dict(ht2.hamming_top2.launches_by_site)
    err = ate(eng.frame_poses(), shaken_trajectory())
    same = _replay_plain(records)
    idle = log["idle"]
    busy_share = idle.count(False) / max(len(idle), 1)
    queued, mapped = len(log["depth"]), len(log["ba_ok"])
    n_kf = eng.stats["kf_inserted"]
    timed = frame_ms[1:]
    print(f"[async] native queue {native.have_native()}; {len(frames)} "
          f"jolted corridor frames, the caller's ms a frame (track_stereo "
          f"to its stream's synchronize, frames 1-{len(frames) - 1}): "
          f"median {np.median(timed):.1f}, worst {np.max(timed):.1f} "
          f"(phase 4's median {slice_ms:.1f}); KFs inserted {n_kf} "
          f"({n_kf / len(frames):.4f} a frame), queued {queued}, mapped "
          f"{mapped}, dropped {queued - mapped}, mapped without local BA "
          f"{log['ba_ok'].count(False)}, deepest queue "
          f"{max(log['depth'], default=0)}; keyframe decisions "
          f"{len(idle)}, busy mapper {100 * busy_share:.1f}%; mapping "
          f"step median {np.median(log['map_ms']):.1f} ms over "
          f"{len(log['map_ms'])}; ATE {err:.4f} m; hamming_top2 launches "
          f"by path {by_site}, called from threads "
          f"{ {k: sorted(v) for k, v in log['threads'].items()} }; "
          f"{len(records)} track_ref_kf matching calls replayed with the "
          f"plain version: equal {same}; wall s: frames "
          f"{t_shut - t_start:.1f}, shutdown {t_end - t_shut:.1f}, replay "
          f"{time.perf_counter() - t_end:.1f} ({smi})", flush=True)
    if not err < 0.15:
        raise AssertionError(f"async: ATE {err} m (need < 0.15)")
    if by_site.get("track_ref_kf", 0) < 1 or not records:
        raise AssertionError("async: track_ref_kf never launched "
                             "hamming_top2")
    if log["threads"].get("track_ref_kf") != {"MainThread"}:
        raise AssertionError(f"async: track_ref_kf ran on "
                             f"{log['threads'].get('track_ref_kf')}")
    if not same:
        raise AssertionError("async: kernel and plain differ on "
                             "track_ref_kf's live input")
    return by_site, {"ms": float(np.median(timed)),
                     "worst_ms": float(np.max(timed)),
                     "kf_per_frame": n_kf / len(frames),
                     "busy_share": busy_share}


def phase_async_profiled(smi, frames):
    """Phase 20 (c), after every timed measurement of the script: a fresh
    AsyncSlamEngine over the corridor's first 2 × ASYNC_PROFILED frames,
    the last ASYNC_PROFILED of them under torch.profiler (kernels and
    device ms per stream, the device time both streams were busy at
    once).  Its launches are not counted: (a) drives the path."""
    eng = _new_async_engine()
    n = 2 * ASYNC_PROFILED

    def track(i):
        eng.track_stereo(*frames[i], 0.1 * i)
        torch.cuda.current_stream().synchronize()

    eng.start()
    try:
        for i in range(n - ASYNC_PROFILED):
            track(i)
        t0 = time.perf_counter()
        streams, both_ms, prof_ms = _profile_streams(
            eng, lambda: [track(i) for i in range(n - ASYNC_PROFILED, n)])
        t_trace = time.perf_counter() - t0
        eng.shutdown()
    finally:
        _stop_worker(eng)
    worker_ms = streams.get("worker", (0, 0.0))[1]
    print(f"[async] profiled corridor frames {n - ASYNC_PROFILED}-{n - 1} "
          f"of a fresh engine, after every timed phase "
          f"({eng.stats['kf_inserted']} KFs inserted over frames 0-{n - 1}):"
          f" {prof_ms:.1f} ms wall; kernels and device ms per stream "
          f"{ {k: (c, round(ms, 3)) for k, (c, ms) in streams.items()} }; "
          f"both streams busy {both_ms:.3f} ms "
          f"({100 * both_ms / max(worker_ms, 1e-9):.1f}% of the worker's "
          f"device time, {100 * both_ms / prof_ms:.2f}% of the wall); the "
          f"window with its trace {t_trace:.1f} s ({smi})", flush=True)
    if worker_ms <= 0:
        raise AssertionError("async: the worker's stream ran nothing in "
                             "the profiled window")
    return both_ms


def phase_async_orbit(smi, frames, poses_gt, scene):
    """Phase 20 (b): phase 6's orbit (``frames`` of ``scene``), continued
    for ASYNC_ORBIT_EXTRA frames at the same step, through AsyncSlamEngine
    with loop closing on: the loop is detected and corrected on the
    worker, whose match_for_sim3 launches hamming_top2 on its stream, and
    its global BA is merged there or at shutdown."""
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    cfg = bench_config()
    more = outward_orbit(ORBIT_FRAMES, ORBIT_RADIUS, ORBIT_Z, ORBIT_TURNS,
                         stop=ORBIT_FRAMES + ASYNC_ORBIT_EXTRA)[len(frames):]
    rng = np.random.default_rng(20)
    frames = frames + render_pool.render_frames(synthetic.render_stereo,
                                                scene, cfg.camera, more, rng)
    poses_gt = poses_gt + more
    eng = AsyncSlamEngine(cfg)
    log = _spy_async(eng)
    records, restore = _record_matches("match_for_sim3")
    ht2.reset_launch_counts()          # the async orbit's count
    frame_ms, tracked, lost = [], 0, []
    t_start = time.perf_counter()
    eng.start()
    try:
        for i, (left, right) in enumerate(frames):
            t0 = time.perf_counter()
            Tcw = eng.track_stereo(left, right, 0.1 * i)
            torch.cuda.current_stream().synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            tracked += Tcw is not None
            if Tcw is None:
                lost.append(i)
        t_shut = time.perf_counter()
        eng.shutdown()
        torch.cuda.synchronize()
    finally:
        restore()
        _stop_worker(eng)
    t_end = time.perf_counter()
    by_site = dict(ht2.hamming_top2.launches_by_site)
    errs = []
    for Te, Tg in zip(eng.frame_poses(), poses_gt):
        if Te is not None:
            Te = Te @ poses_gt[0]    # the engine's world is the first camera
            errs.append(np.sum((-Te[:3, :3].T @ Te[:3, 3]
                                + Tg[:3, :3].T @ Tg[:3, 3]) ** 2))
    err = float(np.sqrt(np.mean(errs)))
    gst = eng.loop_closer.gba.stats
    same = _replay_plain(records)
    idle = log["idle"]
    loop = eng.loop_closer.last_loop
    loop_frame = (None if loop is None
                  else int(eng.ms.kf_frame_id[loop[0]]))
    print(f"[async-orbit] {len(frames)} orbit frames ({ORBIT_FRAMES} of "
          f"phase 6 and {len(more)} more): tracked {tracked}, lost "
          f"{lost}, KFs inserted {eng.stats['kf_inserted']}, loops closed "
          f"{eng.stats['loops_closed']} (the pair {loop}, its newer "
          f"keyframe from frame {loop_frame}), relocalized "
          f"{eng.stats['reloc']}, GBA {gst}, ATE {err:.4f} m; the "
          f"caller's median {np.median(frame_ms):.1f} ms a frame (worst "
          f"{np.max(frame_ms):.0f}); busy mapper "
          f"{100 * idle.count(False) / max(len(idle), 1):.1f}% of "
          f"{len(idle)} decisions, mapped without local BA "
          f"{log['ba_ok'].count(False)} of {len(log['ba_ok'])}; "
          f"hamming_top2 launches by path {by_site}, called from threads "
          f"{ {k: sorted(v) for k, v in log['threads'].items()} }; "
          f"{len(records)} match_for_sim3 matching calls replayed with "
          f"the plain version: equal {same}; wall s: frames "
          f"{t_shut - t_start:.1f}, shutdown {t_end - t_shut:.1f}, replay "
          f"{time.perf_counter() - t_end:.1f} ({smi})", flush=True)
    if tracked < 0.85 * len(frames):
        raise AssertionError(f"async-orbit: tracked only {tracked}")
    if eng.stats["loops_closed"] < 1 or gst["merged"] < 1:
        raise AssertionError(f"async-orbit: loops {eng.stats}, GBA {gst}")
    if not err < 0.5:
        raise AssertionError(f"async-orbit: ATE {err} m (need < 0.5)")
    if by_site.get("match_for_sim3", 0) < 1 or not records:
        raise AssertionError("async-orbit: match_for_sim3 never launched "
                             "hamming_top2")
    if log["threads"].get("match_for_sim3") != {"local-mapping"}:
        raise AssertionError(f"async-orbit: match_for_sim3 ran on "
                             f"{log['threads'].get('match_for_sim3')}")
    if not same:
        raise AssertionError("async-orbit: kernel and plain differ on "
                             "match_for_sim3's live input")
    return by_site


def euroc_like_rectification():
    """A 752×480 stereo calibration shaped like EuRoC's Stereo-EuRoC.yaml
    (its cameras' intrinsics and rad-tan distortion, small rectifying
    rotations, rectified projections 0.11 m apart), as the flat dict
    ``config._parse_opencv_yaml`` gives."""
    def rot(rx, ry, rz):
        cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                                  np.sin(ry), np.cos(rz), np.sin(rz))
        return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
                @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))

    P = np.array([[380.0, 0.0, 367.45, 0.0], [0.0, 380.0, 252.2, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    Pr = P.copy()
    Pr[0, 3] = -0.11 * 380.0
    return {
        "LEFT.width": RECTIFY_W, "LEFT.height": RECTIFY_H,
        "LEFT.K": np.array([[458.654, 0.0, 367.215],
                            [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]]),
        "LEFT.D": np.array([[-0.2834, 0.0740, 1.94e-4, 1.76e-5, 0.0]]),
        "LEFT.R": rot(0.0035, -0.0040, 0.0015), "LEFT.P": P,
        "RIGHT.width": RECTIFY_W, "RIGHT.height": RECTIFY_H,
        "RIGHT.K": np.array([[457.587, 0.0, 379.999],
                             [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]]),
        "RIGHT.D": np.array([[-0.2837, 0.0746, -1.04e-4, -3.56e-5, 0.0]]),
        "RIGHT.R": rot(0.0030, 0.0021, -0.0012), "RIGHT.P": Pr}


def phase_rectify(smi, reps=50):
    """Phase 20 (d): StereoRectifier on the card (no device given): the
    device path against the host path, and ms a pair for each (CUDA
    events for the device path, images already on the card; the host
    clock for numpy)."""
    from orbslam2_tpu_torch.ops import rectify

    rect = rectify.load_rectification(euroc_like_rectification())
    if rect.device.type != "cuda":
        raise AssertionError(f"rectify: the rectifier chose {rect.device}")
    rng = np.random.default_rng(20)
    left, right = (rng.integers(0, 256, (RECTIFY_H, RECTIFY_W),
                                dtype=np.uint8) for _ in range(2))
    dl, dr = rect.remap_pair(left, right)
    hl, hr = rect(left, right)
    err = max(float(np.abs(dl.cpu().numpy() - hl).max()),
              float(np.abs(dr.cpu().numpy() - hr).max()))
    lt, rt = (torch.from_numpy(x).cuda() for x in (left, right))
    dev_ms = _cuda_ms(lambda: rect.remap_pair(lt, rt), reps=reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        rect(left, right)
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    oob = float(np.mean((rect.maps.lx < 0) | (rect.maps.lx > RECTIFY_W - 1)
                        | (rect.maps.ly < 0)
                        | (rect.maps.ly > RECTIFY_H - 1)))
    print(f"[rectify] {RECTIFY_W}x{RECTIFY_H} EuRoC-like pair ("
          f"{100 * oob:.1f}% of the left map outside the source): "
          f"remap_pair on the card {dev_ms:.4f} ms a pair (CUDA events), "
          f"host path {host_ms:.3f} ms a pair; max |card − host| {err:.2e} "
          f"(tolerance {RECTIFY_TOL}) ({smi})", flush=True)
    if not err <= RECTIFY_TOL:
        raise AssertionError(f"rectify: card and host differ by {err}")
    return {"device_ms": dev_ms, "host_ms": host_ms, "max_err": err}


# phase 21: the drivers (tools/replay.py, runtime/stream_node.py, utils/ar.py)
TUM_FACTOR = 5000.0            # run_tum_rgbd's fixed depth factor
STREAM_PACED, STREAM_QUEUE = 16, 4
AR_MIN_POINTS, AR_TOL = 50, 1e-4
EUROC_T0 = 1403636579763555584  # a EuRoC MH_01 stamp, ns


def _euroc_identity_blocks(cam):
    """LEFT./RIGHT. blocks with zero distortion, R = I and P = K: the
    rectified frames are the rendered ones up to bilinear rounding."""
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                  [0.0, 0.0, 1.0]])
    lines = []
    for side in ("LEFT", "RIGHT"):
        lines += [f"{side}.width: {cam.width}",
                  f"{side}.height: {cam.height}"]
        for key, m in (("K", K), ("D", np.zeros((1, 5))), ("R", np.eye(3)),
                       ("P", np.hstack([K, np.zeros((3, 1))]))):
            lines += [f"{side}.{key}: !!opencv-matrix",
                      f"   rows: {m.shape[0]}", f"   cols: {m.shape[1]}",
                      "   dt: d", "   data:[" + ", ".join(
                          repr(float(x)) for x in m.ravel()) + "]"]
    return "\n".join(lines) + "\n"


def write_driver_layouts(root, corridor, rgbd_frames, poses_gt, cam,
                         n_features):
    """Phase 4's stereo frames as KITTI and EuRoC layouts and phase 13's
    RGB-D frames as a TUM layout (gray as 8-bit RGB, depth as 16-bit at
    factor 5000, 0 past 65535 / 5000 m), each with a settings file
    carrying ``cam`` and ``n_features``; returns the paths, the share of
    depth pixels blanked, and the ms spent writing."""
    import os

    from orbslam2_tpu_torch.utils import png, trajectory

    t0 = time.perf_counter()
    u8 = [(np.clip(left, 0, 255).astype(np.uint8),
           np.clip(right, 0, 255).astype(np.uint8))
          for left, right in corridor]
    ts = [0.1 * i for i in range(len(u8))]
    paths = {}
    for name in ("kitti", "tum", "euroc"):
        settings = os.path.join(root, f"{name}.yaml")
        _write_settings(settings, cam)
        with open(settings, "a") as f:
            f.write(f"ORBextractor.nFeatures: {n_features}\n")
            if name == "euroc":
                f.write(_euroc_identity_blocks(cam))
        paths[name] = (os.path.join(root, name), settings)
    kitti = paths["kitti"][0]
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(kitti, sub))
    for i, (left, right) in enumerate(u8):
        png.write_png(os.path.join(kitti, "image_0", f"{i:06d}.png"), left)
        png.write_png(os.path.join(kitti, "image_1", f"{i:06d}.png"), right)
    with open(os.path.join(kitti, "times.txt"), "w") as f:
        f.write("".join(f"{t:e}\n" for t in ts))
    euroc = paths["euroc"][0]
    for sub in ("cam0", "cam1"):
        os.makedirs(os.path.join(euroc, sub, "data"))
    for i, pair in enumerate(u8):
        for sub, img in zip(("cam0", "cam1"), pair):
            png.write_png(os.path.join(euroc, sub, "data",
                                       f"{EUROC_T0 + 100_000_000 * i}.png"),
                          img)
    tum = paths["tum"][0]
    os.makedirs(os.path.join(tum, "rgb"))
    os.makedirs(os.path.join(tum, "depth"))
    blanked, rgb_txt, depth_txt = [], [], []
    for t, (gray, depth) in zip(ts, rgbd_frames):
        g = np.clip(gray, 0, 255).astype(np.uint8)
        d = depth.astype(np.float64) * TUM_FACTOR
        far = d > 65535
        blanked.append(float(np.mean(far)))
        png.write_png(os.path.join(tum, "rgb", f"{t:.6f}.png"),
                      np.stack([g, g, g], -1))
        png.write_png(os.path.join(tum, "depth", f"{t:.6f}.png"),
                      np.where(far, 0, d).astype(np.uint16))
        rgb_txt.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_txt.append(f"{t:.6f} depth/{t:.6f}.png")
    with open(os.path.join(tum, "rgb.txt"), "w") as f:
        f.write("# color images\n" + "\n".join(rgb_txt) + "\n")
    with open(os.path.join(tum, "depth.txt"), "w") as f:
        f.write("# depth maps\n" + "\n".join(depth_txt) + "\n")
    trajectory.save_tum(os.path.join(tum, "groundtruth.txt"), ts, poses_gt)
    return paths, float(np.mean(blanked)), 1e3 * (time.perf_counter() - t0)


def _centres_ate(est, gt):
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def _timed_decode(log):
    """Wrap the loaders' image readers so that each read's ms is kept in
    ``log``; returns restore()."""
    from orbslam2_tpu_torch.utils import datasets

    gray, depth = datasets._imread_gray, datasets._imread_depth

    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            log.append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    datasets._imread_gray, datasets._imread_depth = wrap(gray), wrap(depth)

    def restore():
        datasets._imread_gray, datasets._imread_depth = gray, depth

    return restore


def run_dataset_drivers(smi, paths, poses_gt, slice_ms, device=None):
    """Phase 21 (a): run_kitti_stereo, run_tum_rgbd and run_euroc_stereo
    over the written layouts, each writing its trajectory file; every
    frame tracked, ATE from the file read back against the truth, the
    track_ref_kf matching calls of the KITTI and TUM runs replayed with
    the plain version; ReplayReport's median and mean ms, PNG decode ms a
    frame, and for EuRoC the host-rectify ms a pair."""
    import os

    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.ops import rectify
    from orbslam2_tpu_torch.tools import replay as replay_mod
    from orbslam2_tpu_torch.utils import datasets, trajectory

    gt = trajectory.centers_from_poses(poses_gt)
    n = len(poses_gt)
    results, sites = {}, {}
    for name in ("kitti", "tum", "euroc"):
        seq, settings = paths[name]
        traj = os.path.join(os.path.dirname(seq), f"{name}_traj.txt")
        decode_ms, rect_ms = [], []
        records, restore_matches = _record_matches("track_ref_kf")
        restore_decode = _timed_decode(decode_ms)
        host_rect = rectify.StereoRectifier.__call__

        def timed_rect(self, left, right):
            t0 = time.perf_counter()
            out = host_rect(self, left, right)
            rect_ms.append(1e3 * (time.perf_counter() - t0))
            return out

        rectify.StereoRectifier.__call__ = timed_rect
        ht2.reset_launch_counts()          # this driver's count
        t0 = time.perf_counter()
        try:
            if name == "kitti":
                rep = replay_mod.run_kitti_stereo(seq, settings, traj,
                                                  device=device)
            elif name == "tum":
                rep = replay_mod.run_tum_rgbd(seq, settings, traj,
                                              device=device)
            else:
                rep = replay_mod.run_euroc_stereo(seq, settings, None, traj,
                                                  device=device)
        finally:
            restore_matches()
            restore_decode()
            rectify.StereoRectifier.__call__ = host_rect
        wall_s = time.perf_counter() - t0
        by_site = dict(ht2.hamming_top2.launches_by_site)
        for site, k in by_site.items():
            sites[f"{name}/{site}"] = k
        same = _replay_plain(records)
        if name == "kitti":
            est = np.loadtxt(traj).reshape(-1, 12)[:, [3, 7, 11]]
        else:
            _ts, est = trajectory.load_tum(traj)
        # TUM: against its groundtruth.txt, read back by the loader
        truth = datasets.load_tum_groundtruth(seq)[1] if name == "tum" \
            else gt
        err = _centres_ate(est, truth) if len(est) == n else float("inf")
        res = {"median_ms": rep.median_ms, "mean_ms": rep.mean_ms,
               "decode_ms": sum(decode_ms) / max(rep.n_frames, 1),
               "ate_m": err, "tracked": rep.n_tracked, "frames": rep.n_frames,
               "wall_s": wall_s, "sites": by_site, "replayed": len(records),
               "equal": same}
        if rect_ms:
            res["host_rect_ms"] = float(np.median(rect_ms))
        results[name] = res
        print(f"[drivers] {name}: {rep.n_tracked}/{rep.n_frames} tracked, "
              f"trajectory lines {len(est)}, ATE {err:.4f} m; ReplayReport "
              f"median {rep.median_ms:.1f} / mean {rep.mean_ms:.1f} ms "
              f"(phase 4's median {slice_ms:.1f} ms, "
              f"{rep.median_ms / slice_ms:.2f}×); PNG decode "
              f"{res['decode_ms']:.2f} ms a frame"
              + (f"; host rectify {res['host_rect_ms']:.2f} ms a pair"
                 if rect_ms else "")
              + f"; hamming_top2 launches by path {by_site}; "
              f"{len(records)} track_ref_kf matching calls replayed with "
              f"the plain version: equal {same}; {wall_s:.1f} s ({smi})",
              flush=True)
        if rep.n_frames != n or rep.n_tracked != n or len(est) != n:
            raise AssertionError(f"drivers: {name} tracked {rep.n_tracked} "
                                 f"of {rep.n_frames} frames, {len(est)} "
                                 f"trajectory lines (need {n})")
        if not err < 0.15:
            raise AssertionError(f"drivers: {name} ATE {err} m (need < "
                                 f"0.15)")
        if not same:
            raise AssertionError(f"drivers: {name}: kernel and plain differ "
                                 f"on track_ref_kf's live input")
        if name != "euroc" and (by_site.get("track_ref_kf", 0) < 1
                                or not records):
            raise AssertionError(f"drivers: {name}: track_ref_kf never "
                                 f"launched hamming_top2")
    return results, sites


def run_stream_node(smi, paths, device=None):
    """Phase 21 (b): a StreamNode (queue of 4, started) over a fresh System
    from the KITTI settings, fed the frames read back by
    iter_kitti_stereo: the first STREAM_PACED each after the previous
    frame's pose came out (all processed, none dropped), the rest in one
    burst (processed + dropped = the rest, ≥ 1 dropped); stop() raises
    nothing."""
    import threading

    from orbslam2_tpu_torch.config import STEREO
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime.stream_node import StreamNode
    from orbslam2_tpu_torch.runtime.system import System
    from orbslam2_tpu_torch.utils import datasets

    seq, settings = paths["kitti"]
    frames = list(datasets.iter_kitti_stereo(seq))
    system = System(None, settings, STEREO, device=device)
    posed, stamps = threading.Event(), []

    def on_pose(Tcw, t):
        stamps.append(time.perf_counter())
        posed.set()

    node = StreamNode(system, on_pose=on_pose, queue_capacity=STREAM_QUEUE)
    ht2.reset_launch_counts()              # the stream node's count
    node.start()
    paced_ms = []
    for left, right, t in frames[:STREAM_PACED]:
        posed.clear()
        t0 = time.perf_counter()
        node.on_image_stereo(left, right, t)
        if not posed.wait(timeout=120.0):
            node.stop()
            raise AssertionError("stream node: no pose within 120 s")
        paced_ms.append(1e3 * (stamps[-1] - t0))
    paced = (node.processed, node.dropped)
    t0 = time.perf_counter()
    for left, right, t in frames[STREAM_PACED:]:
        node.on_image_stereo(left, right, t)
    node.stop()
    burst_s = time.perf_counter() - t0
    burst = (node.processed - paced[0], node.dropped - paced[1])
    by_site = dict(ht2.hamming_top2.launches_by_site)
    rest = len(frames) - STREAM_PACED
    print(f"[drivers] stream node: paced {paced[0]} processed / "
          f"{paced[1]} dropped, {float(np.median(paced_ms[1:])):.1f} ms a "
          f"processed frame (push to pose, median after frame 0); burst of "
          f"{rest}: {burst[0]} processed / {burst[1]} dropped in "
          f"{burst_s:.2f} s ({1e3 * burst_s / max(burst[0], 1):.1f} ms a "
          f"processed frame), state {system.get_tracking_state()}; "
          f"hamming_top2 launches by path {by_site} ({smi})", flush=True)
    if paced != (STREAM_PACED, 0):
        raise AssertionError(f"stream node: paced frames {paced} (need "
                             f"{STREAM_PACED} processed, 0 dropped)")
    if sum(burst) != rest or burst[1] < 1:
        raise AssertionError(f"stream node: burst {burst} (need a sum of "
                             f"{rest}, ≥ 1 dropped)")
    return system, {"paced_ms": float(np.median(paced_ms[1:])),
                    "burst": burst}, by_site


def run_ar(smi, system):
    """Phase 21 (c): ArDemo.insert_cube on (b)'s map when it holds ≥ 50
    points seen more than 5 times, else on tests/test_extras.py's plane
    scene; then detect_plane with fixed hypotheses on that map against
    the same call on a CPU copy: the normal equal up to sign, d and the
    origin within AR_TOL; its CUDA-event ms on the card."""
    import types

    from orbslam2_tpu_torch.utils import ar

    eng = system.engine
    ms = eng.ms
    n_cand = int((ms.mp_valid & (ms.mp_n_obs > 5)).sum())
    source = "phase 21 (b)'s map"
    if n_cand < AR_MIN_POINTS:
        rng = np.random.default_rng(0)
        on = np.stack([rng.uniform(-5, 5, 200),
                       np.full(200, 2.0) + rng.normal(0, 0.005, 200),
                       rng.uniform(5, 25, 200)], -1)
        off = np.stack([rng.uniform(-5, 5, 60), rng.uniform(-3, 1.5, 60),
                        rng.uniform(5, 25, 60)], -1)
        pts = torch.from_numpy(np.concatenate([on, off]).astype(np.float32))
        ms = types.SimpleNamespace(
            mp_pos=pts.to(eng.device),
            mp_valid=torch.ones(260, dtype=torch.bool, device=eng.device),
            mp_n_obs=torch.full((260,), 8, dtype=torch.int32,
                                device=eng.device))
        eng = types.SimpleNamespace(ms=ms, device=eng.device, cfg=eng.cfg)
        source = "tests/test_extras.py's plane scene"
    demo = ar.ArDemo(eng, cube_size=0.5)
    inserted = demo.insert_cube()
    idx = ar.draw_hypotheses(ms.mp_valid.cpu() & (ms.mp_n_obs.cpu() > 5),
                             64, torch.Generator().manual_seed(21))
    args = (ms.mp_pos, ms.mp_valid, ms.mp_n_obs)
    fit = ar.detect_plane(*args, idx=idx.to(eng.device))
    ref = ar.detect_plane(*(a.cpu() for a in args), idx=idx)
    sign = float(torch.sign(torch.dot(fit.n.cpu(), ref.n))) or 1.0
    err = max(float((sign * fit.n.cpu() - ref.n).abs().max()),
              abs(sign * float(fit.d) - float(ref.d)),
              float((fit.origin.cpu() - ref.origin).abs().max()))
    ms_call = _cuda_ms(lambda: ar.detect_plane(*args, idx=idx.to(
        eng.device)), reps=20, warmup=3) if eng.device.type == "cuda" \
        else float("nan")
    print(f"[drivers] AR on {source} ({n_cand} points seen > 5 times in "
          f"(b)'s map): insert_cube {inserted}, planes {len(demo.planes)}; "
          f"detect_plane on {eng.device} ok {bool(fit.ok)}, n "
          f"{np.round(fit.n.cpu().numpy(), 4).tolist()}, d "
          f"{float(fit.d):.4f}; max |card − CPU| {err:.2e} (tolerance "
          f"{AR_TOL}); {ms_call:.3f} ms a call (CUDA events) ({smi})",
          flush=True)
    if bool(fit.ok) != bool(ref.ok) or not err <= AR_TOL:
        raise AssertionError(f"AR: detect_plane on the card and the CPU "
                             f"differ by {err} (ok {bool(fit.ok)} / "
                             f"{bool(ref.ok)})")
    return {"ms": ms_call, "err": err, "inserted": inserted,
            "source": source}


def phase_drivers(smi, corridor, rgbd_frames, slice_ms):
    """Phase 21: the dataset replay drivers, the stream node and the AR
    demo on the card (no device given), over phase 4's corridor and phase
    13's RGB-D frames written to disk at the bench widths."""
    import os
    import tempfile

    from orbslam2_tpu_torch.ops import rectify
    from orbslam2_tpu_torch.utils import datasets

    cfg = bench_config()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        paths, blanked, write_ms = write_driver_layouts(
            root, corridor, rgbd_frames, shaken_trajectory(), cfg.camera,
            cfg.orb.n_features)
        print(f"[drivers] layouts written in {write_ms:.0f} ms: KITTI, TUM "
              f"(depth at factor {TUM_FACTOR:.0f}: {100 * blanked:.2f}% of "
              f"pixels past {65535 / TUM_FACTOR:.3f} m written as 0), EuRoC "
              f"({smi})", flush=True)
        results, sites = run_dataset_drivers(smi, paths, shaken_trajectory(),
                                             slice_ms)
        seq, settings = paths["euroc"]
        rect = rectify.load_rectification(settings)
        left, right, _t = next(datasets.iter_euroc_stereo(seq))
        lt, rt = (torch.from_numpy(x).cuda() for x in (left, right))
        eu = results["euroc"]
        eu["remap_pair_ms"] = _cuda_ms(lambda: rect.remap_pair(lt, rt),
                                       reps=50)
        print(f"[drivers] euroc: remap_pair {eu['remap_pair_ms']:.4f} ms a "
              f"{cfg.camera.width}x{cfg.camera.height} pair (CUDA events) "
              f"against host rectify {eu['host_rect_ms']:.2f} ms ({smi})",
              flush=True)
        system, stream, stream_sites = run_stream_node(smi, paths)
        for site, k in stream_sites.items():
            sites[f"stream/{site}"] = k
        results["stream"] = stream
        results["ar"] = run_ar(smi, system)
        del system
    results["blanked"] = blanked
    results["s"] = time.perf_counter() - t0
    print(f"[drivers] phase 21 in {results['s']:.1f} s ({smi})", flush=True)
    return sites, results


# phase 22: the harvest's bar (descriptors a view on average), the views
# also harvested on the CPU, and the BoW margin of
# tests/test_place_recognition.py:47
VOCAB_MIN_DESC_PER_VIEW = 500
VOCAB_CPU_VIEWS = 2
BOW_MARGIN = 0.1


def _share_equal(a, b):
    """Share of the rows of two descriptor sets (int32 [n, 8]) that are
    bit-equal, matched as multisets, over the larger set."""
    from collections import Counter

    ca = Counter(map(bytes, a.cpu().numpy()))
    cb = Counter(map(bytes, b.cpu().numpy()))
    return sum((ca & cb).values()) / max(len(a), len(b), 1)


def _voc_equal(a, b):
    return ((a.k, a.levels) == (b.k, b.levels)
            and all(torch.equal(x.cpu(), y.cpu())
                    for x, y in zip(a.centroids, b.centroids))
            and torch.equal(a.idf.cpu(), b.idf.cpu()))


def _bow_margin(smi, voc):
    """Phase 22 (d): a bench-camera view of one corridor world against the
    same view re-rendered with fresh noise and against the same pose in
    another world, each extracted on the card: BoW similarities."""
    from orbslam2_tpu_torch.ops import bow, extractor
    from orbslam2_tpu_torch.ops import image as image_ops
    from orbslam2_tpu_torch.utils import synthetic

    cfg = bench_config()
    world_a = synthetic.make_world(np.random.default_rng(0))
    world_b = synthetic.make_world(np.random.default_rng(1))
    T = synthetic.look_ahead_pose(np.array([0.3, 0.0, 2.0]), yaw=0.1)
    rng = np.random.default_rng(22)

    def vector(world):
        img = synthetic.render_world(world, cfg.camera, T, rng, 1.0)
        gray = torch.from_numpy(img.astype(np.float32)).cuda()
        f = extractor.extract(image_ops.build_pyramid(
            gray, cfg.orb.n_levels, cfg.orb.scale_factor), cfg.orb)
        return bow.bow_vector(voc, f.desc, f.valid)

    va = vector(world_a)
    same = float(bow.score(va, vector(world_a)))
    other = float(bow.score(va, vector(world_b)))
    print(f"[vocabulary] BoW similarity of a corridor view to itself "
          f"re-rendered with fresh noise {same:.4f}, to the same pose in "
          f"another world {other:.4f} (bar: same > other + {BOW_MARGIN}) "
          f"({smi})", flush=True)
    if not same > other + BOW_MARGIN:
        raise AssertionError(f"vocabulary: BoW similarity {same} to the "
                             f"same place, {other} to another world")
    return same, other


def phase_vocabulary(smi):
    """Phase 22: vocabulary building on the card through the user's entry
    point, default_vocabulary(force_rebuild=True, path=...) with no
    device: the default harvest, then the k=10, levels=4 tree, written and
    loaded back.  The harvest's views, extractions and build are timed on
    the way through (the module's functions wrapped for the call).  Then
    the first views extracted again on the CPU, the same build on the CPU
    (hamming_top2's plain version) against the card's, and the BoW margin.
    Returns (the vocab_build launches by site, the numbers, the root
    group's kernel inputs)."""
    import os
    import tempfile

    from orbslam2_tpu_torch.models import vocabulary as voc
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2

    t_phase = time.perf_counter()
    bank = voc._real_textures()
    ext_s, views, timed = [], [], {}
    inner = (voc.view_descriptors, voc.harvest_training_descriptors,
             voc.build_vocabulary)

    def view_descriptors(img, device):
        t0 = time.perf_counter()
        d = inner[0](img, device)
        torch.cuda.synchronize()
        ext_s.append(time.perf_counter() - t0)
        if len(views) < VOCAB_CPU_VIEWS:
            views.append((img, d))
        return d

    def harvest(**kw):
        t0 = time.perf_counter()
        timed["desc"] = inner[1](**kw)
        torch.cuda.synchronize()
        timed["harvest_s"] = time.perf_counter() - t0
        return timed["desc"]

    def build(*args, **kw):
        t0 = time.perf_counter()
        out = inner[2](*args, **kw)
        torch.cuda.synchronize()
        timed["build_s"] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "vocab_k10_l4.npz")
        (voc.view_descriptors, voc.harvest_training_descriptors,
         voc.build_vocabulary) = view_descriptors, harvest, build
        try:
            ht2.reset_launch_counts()     # the main path's count starts here
            t0 = time.perf_counter()
            built = voc.default_vocabulary(force_rebuild=True, path=path)
            torch.cuda.synchronize()
            user_s = time.perf_counter() - t0
            sites = dict(ht2.hamming_top2.launches_by_site)
        finally:
            (voc.view_descriptors, voc.harvest_training_descriptors,
             voc.build_vocabulary) = inner
        z = np.load(path)
        layout = ([str(z[f"cent{d}"].dtype) for d in range(4)]
                  + [str(z["idf"].dtype)])
        t0 = time.perf_counter()
        loaded = voc.default_vocabulary(path=path, device="cuda")
        load_ms = 1e3 * (time.perf_counter() - t0)
        mb = os.path.getsize(path) / 2 ** 20
    desc = timed["desc"]
    n_views, n_desc = len(ext_s), desc.shape[0]
    render_ms = 1e3 * (timed["harvest_s"] - sum(ext_s)) / n_views
    extract_ms = 1e3 * sum(ext_s) / n_views
    launches = sites.get("vocab_build", 0)
    print(f"[vocabulary] harvest on the card: {n_views} views, {n_desc} "
          f"descriptors ({n_desc / n_views:.1f} a view), render "
          f"{render_ms:.1f} ms and extraction {extract_ms:.2f} ms a view "
          f"(synchronized), real-raster bank of {len(bank)} "
          f"(matplotlib {'found' if bank else 'absent'}) ({smi})",
          flush=True)
    print(f"[vocabulary] default_vocabulary(force_rebuild=True, path) in "
          f"{user_s:.2f} s: build k=10, levels=4 on the card "
          f"{timed['build_s']:.3f} s, hamming_top2 launches {sites}; npz "
          f"{mb:.3f} MB ({layout}), loaded back on the card in "
          f"{load_ms:.1f} ms ({smi})", flush=True)
    if n_desc / n_views < VOCAB_MIN_DESC_PER_VIEW:
        raise AssertionError(f"vocabulary: {n_desc} descriptors from "
                             f"{n_views} views (need ≥ "
                             f"{VOCAB_MIN_DESC_PER_VIEW} a view)")
    if not built.centroids[0].is_cuda or launches < 7:
        raise AssertionError(f"vocabulary: the tree was not built on the "
                             f"card through hamming_top2 ({sites})")
    if set(sites) != {"vocab_build"}:
        raise AssertionError(f"vocabulary: launches outside vocab_build: "
                             f"{sites}")
    if layout != ["uint32"] * 4 + ["float32"] or not _voc_equal(loaded,
                                                               built):
        raise AssertionError(f"vocabulary: the written tree ({layout}) "
                             f"does not load back equal")
    from orbslam2_tpu_torch.models.vocabulary import (build_vocabulary,
                                                      view_descriptors)
    shares = []
    for img, d in views:
        t0 = time.perf_counter()
        c = view_descriptors(img, "cpu")
        shares.append((_share_equal(d, c), len(d), len(c),
                       1e3 * (time.perf_counter() - t0)))
    print("[vocabulary] the first views extracted again on the CPU: "
          + "; ".join(f"{100 * s:.2f}% of descriptors bit-equal (card "
                      f"{n}, CPU {m}; CPU {ms:.0f} ms)"
                      for s, n, m, ms in shares) + f" ({smi})", flush=True)
    t0 = time.perf_counter()
    cpu = build_vocabulary(desc.cpu(), k=10, levels=4, seed=0, device="cpu")
    cpu_s = time.perf_counter() - t0
    equal = _voc_equal(built, cpu)
    print(f"[vocabulary] the same build on the CPU (plain version) in "
          f"{cpu_s:.2f} s against the card's {timed['build_s']:.3f} s: "
          f"every level and idf {'bit-equal' if equal else 'DIFFER'} "
          f"({launches} vocab_build launches on the card) ({smi})",
          flush=True)
    if not equal:
        raise AssertionError("vocabulary: the card's tree differs from the "
                             "CPU's on the same descriptors")
    same, other = _bow_margin(smi, built)
    phase_s = time.perf_counter() - t_phase
    print(f"[vocabulary] phase 22 in {phase_s:.1f} s ({smi})", flush=True)
    return sites, {
        "views": n_views, "descriptors": n_desc, "bank": len(bank),
        "render_ms": render_ms, "extract_ms": extract_ms,
        "build_s": timed["build_s"], "cpu_build_s": cpu_s,
        "user_s": user_s, "launches": launches, "bow": (same, other),
        "cpu_share": [s for s, *_ in shares], "s": phase_s}, (
        desc.contiguous(), built.centroids[0].contiguous())


def phase_vocab_kernel_device(smi, root):
    """Phase 22, last (after phase 9's profiler session): hamming_top2 at
    the root group's shape (every harvested descriptor against k=10
    centroids, all valid): device µs per launch (torch.profiler) against
    its bound, the wrapper-inclusive and plain ms per call (CUDA
    events)."""
    from orbslam2_tpu_torch.kernels.bench_hamming_top2 import device_us
    from orbslam2_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                     hamming_top2_reference)

    a, b = root
    av = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    bv = torch.ones(b.shape[0], dtype=torch.bool, device=a.device)
    got = hamming_top2(a, av, b, bv)
    ref = hamming_top2_reference(a, av, b, bv)
    err = max(int(torch.max(torch.abs(g.long() - r.long())))
              for g, r in zip(got, ref))
    if err > MAX_ABS_ERR:
        raise AssertionError(f"hamming_top2 at the vocabulary root shape: "
                             f"max |diff| {err}")
    call_ms = _cuda_ms(lambda: hamming_top2(a, av, b, bv))
    plain_ms = _cuda_ms(lambda: hamming_top2_reference(a, av, b, bv),
                        reps=20, warmup=2)
    dev_us, recorded = device_us(lambda: hamming_top2(a, av, b, bv), n=200)
    clock = _max_sm_clock_mhz()
    bound_ms, bound_by, ops, nbytes = hamming_top2_bound(av, bv, clock)
    print(f"[vocabulary] hamming_top2 at the root group's shape "
          f"{a.shape[0]}x{b.shape[0]}: bit-exact vs plain; device "
          f"{dev_us:.3f} us per launch (torch.profiler, mean of {recorded} "
          f"recorded of 200), wrapper-inclusive {1e3 * call_ms:.3f} us per "
          f"call (CUDA events), plain {plain_ms:.4f} ms; bound "
          f"{1e3 * bound_ms:.3f} us by {bound_by} ({ops} __popc, SM clock "
          f"{clock:.0f} MHz; {nbytes} bytes), "
          f"{100 * bound_ms / (dev_us / 1e3):.1f}% of the bound ({smi})",
          flush=True)
    return {"shape": [a.shape[0], b.shape[0]], "device_ms": dev_us / 1e3,
            "ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# phase 23: the mesh (orbslam2_tpu_torch/parallel/*) with its shards on
# the one card
MESH_SHARDS = 4


def _timed_cuda(fn):
    """(result, CUDA-event ms, peak device GiB over the memory before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return (out, a.elapsed_time(b),
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30)


def phase_mesh(smi, case, map_npz):
    """Phase 23: parallel/* with MESH_SHARDS shards on cuda:0 (JAX's
    virtual devices of one host).  (a) Phase 16's perturbed capacity map
    (``case``): one robust CG chunk through distributed_bundle_adjust,
    against phase 16's unsharded CG chunk within phase 16's bars; the
    shards' poses bit-equal; ms (CUDA events, once warm-up, once timed)
    and peak memory.  That map's live points all lie in shard 0's block,
    so the same chunk runs again on the map with its point slots shuffled
    (every shard owns live points, every sum crosses shards), un-shuffled
    and held to the same bars.  (b) A GbaManager with the mesh launched,
    waited and merged on that map (stats["distributed"] == 1), within the
    same bars of the unsharded manager's merge; it runs on one active
    shard (the manager solves the map as it lies).  (c) Phase 19's saved map
    (``map_npz``): a LoopCloser with the mesh and one without (the auto
    rule: no mesh on one card) register every live keyframe through
    detect_step: equal candidates and covisibility rows, BoW vectors and
    scores within 1e-6; then System.load_map into a System whose loop
    closer has the mesh leaves the DB sharded, and a re-render of frame
    SYS_RELOC_FRAME relocalizes within 0.1 m (that reloc_attempt replayed
    with the plain version).  (d) tools/scaling.measure_scaling on the
    mesh, printed as a JSON line; its problem (whose points fill every
    shard's block, where phase 16's live points all fall in shard 0's)
    solved on the mesh within 5e-4 of one shard, the shards' poses
    bit-equal.  Returns the hamming_top2 launches by site."""
    import os
    import tempfile

    from orbslam2_tpu_torch.config import STEREO, CameraConfig
    from orbslam2_tpu_torch.models import map_state as M
    from orbslam2_tpu_torch.models import vocabulary as voc_mod
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.parallel import db_shard, dist_ba
    from orbslam2_tpu_torch.parallel import mesh as mesh_mod
    from orbslam2_tpu_torch.runtime import gba, serialization, tracking
    from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser
    from orbslam2_tpu_torch.runtime.system import System
    from orbslam2_tpu_torch.tools import scaling
    from orbslam2_tpu_torch.utils import camera as cam_mod
    from orbslam2_tpu_torch.utils import synthetic

    t_phase = time.perf_counter()
    ht2.reset_launch_counts()          # the mesh path's count
    mesh = mesh_mod.make_mesh([torch.device("cuda", 0)] * MESH_SHARDS)

    # (a) one robust chunk, sharded, against phase 16's
    cfg, ms = case["cfg"], case["ms"]
    prob = gba.full_map_problem(cfg, ms, M.kf_obs_ok(ms))
    cam = cam_mod.Camera.from_config(cfg.camera)

    def chunk():
        return dist_ba.shard_bundle_adjust(
            mesh, cam, prob, n_free=ms.K, iters_a=5, iters_b=0,
            fix_first_free=True)

    chunk()                                        # warm-up
    outs, chunk_ms, chunk_gib = _timed_cuda(chunk)
    same_bits = all(torch.equal(o[0], outs[0][0]) for o in outs[1:])
    out = gba.with_ba_result(ms, outs[0][0], outs[0][1])
    gaps = _map_gaps(cfg, ms, out, case["out_cg"])

    def live_rows(p):
        """Observation rows a shard and the live rows by shard."""
        obs, _, P_pad, O_loc = dist_ba._partition_by_point(
            dist_ba._on_host(p), mesh.size)
        P_loc = P_pad // mesh.size
        return O_loc, [int(np.sum(
            obs["valid"][d * O_loc:(d + 1) * O_loc]
            & (obs["pt_i"][d * O_loc:(d + 1) * O_loc] // P_loc == d)))
            for d in range(mesh.size)]

    O_loc, live = live_rows(prob)
    print(f"[mesh] one robust GBA chunk at {ms.K} KF slots on "
          f"{MESH_SHARDS} shards of cuda:0 ({O_loc} observation rows a "
          f"shard, {prob.cam_i.shape[0]} in all; live rows by shard "
          f"{live}): {chunk_ms:.1f} ms, peak "
          f"+{chunk_gib:.3f} GiB (phase 16 unsharded CG: see [gba]); "
          f"shards' poses bit-equal {same_bits}; against phase 16's CG "
          f"chunk |Δpose| {gaps[0]:.2e}, points nearer than 20 m |Δ| "
          f"{gaps[1]:.2e} m ({gaps[3]}), all |Δ|/range {gaps[2]:.2e} "
          f"({smi})", flush=True)
    if not same_bits:
        raise AssertionError("mesh: the shards' poses differ")
    if not _within_gba_bars(*gaps[:3]):
        raise AssertionError(f"mesh: the sharded chunk is off phase 16's: "
                             f"{gaps}")

    # the same chunk with the map's point slots shuffled: phase 16's live
    # points all lie in shard 0's block, so above shards 1-3 sum zeros;
    # here every shard owns live points and every sum crosses shards
    P = prob.points.shape[0]
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(23))
    perm = perm.to(prob.points.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(P, device=perm.device)
    pprob = prob._replace(points=prob.points[perm],
                          point_valid=prob.point_valid[perm],
                          pt_i=inv[prob.pt_i])
    pouts, pchunk_ms, pchunk_gib = _timed_cuda(
        lambda: dist_ba.shard_bundle_adjust(
            mesh, cam, pprob, n_free=ms.K, iters_a=5, iters_b=0,
            fix_first_free=True))
    p_bits = all(torch.equal(o[0], pouts[0][0]) for o in pouts[1:])
    pgaps = _map_gaps(cfg, ms, gba.with_ba_result(ms, pouts[0][0],
                                                  pouts[0][1][inv]),
                      case["out_cg"])
    pO_loc, plive = live_rows(pprob)
    print(f"[mesh] the same chunk with the point slots shuffled ({pO_loc} "
          f"observation rows a shard; live rows by shard {plive}): "
          f"{pchunk_ms:.1f} ms, peak +{pchunk_gib:.3f} GiB; shards' poses "
          f"bit-equal {p_bits}; against phase 16's CG chunk |Δpose| "
          f"{pgaps[0]:.2e}, near points |Δ| {pgaps[1]:.2e} m, all "
          f"|Δ|/range {pgaps[2]:.2e} ({smi})", flush=True)
    if not (p_bits and min(plive) > 0):
        raise AssertionError(f"mesh: shuffled chunk: shards' poses "
                             f"bit-equal {p_bits}, live rows {plive}")
    if not _within_gba_bars(*pgaps[:3]):
        raise AssertionError(f"mesh: the shuffled sharded chunk is off "
                             f"phase 16's: {pgaps}")
    del pprob, pouts

    # (b) the manager on the mesh against the unsharded manager
    def merged(mgr):
        mgr.launch(ms)
        mgr.wait()
        res, ok = mgr.poll_and_merge(ms)
        if not ok:
            raise AssertionError("mesh: the GBA merged nothing")
        return res

    mgr = gba.GbaManager(cfg, mesh=mesh)
    plain = gba.GbaManager(cfg)
    got, mgr_ms, mgr_gib = _timed_cuda(lambda: merged(mgr))
    want, plain_ms, plain_gib = _timed_cuda(lambda: merged(plain))
    gaps = _map_gaps(cfg, ms, got, want)
    print(f"[mesh] GbaManager ({mgr.n_chunks} chunks) launch to merge: "
          f"on the mesh {mgr_ms:.1f} ms, peak +{mgr_gib:.3f} GiB; "
          f"unsharded {plain_ms:.1f} ms, peak +{plain_gib:.3f} GiB; stats "
          f"{mgr.stats} / {plain.stats}; |Δpose| {gaps[0]:.2e}, near "
          f"points |Δ| {gaps[1]:.2e} m, all |Δ|/range {gaps[2]:.2e} "
          f"({smi})", flush=True)
    if not (mgr.stats["distributed"] == 1 and plain.mesh is None
            and plain.stats["distributed"] == 0):
        raise AssertionError(f"mesh: managers' stats {mgr.stats}, "
                             f"{plain.stats}")
    if not _within_gba_bars(*gaps[:3]):
        raise AssertionError(f"mesh: the managers' merges differ: {gaps}")
    del case, ms, prob, outs, out, got, want

    # (c) the DB: detect_step on the mesh against the dense DB, then
    # System.load_map into a loop closer with the mesh
    cfg = bench_config()
    voc = voc_mod.default_vocabulary(k=cfg.capacity.vocab_k,
                                     levels=cfg.capacity.vocab_levels)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        with open(path, "wb") as f:
            f.write(map_npz)
        lms, _, _ = serialization.load_map(path)
        dense = LoopCloser(cfg, voc)
        sharded = LoopCloser(cfg, voc, mesh=mesh)
        if dense.mesh is not None:
            raise AssertionError("mesh: one card made a mesh")
        kfs = torch.nonzero(lms.kf_valid).flatten().tolist()
        vec_gap = score_gap = 0.0
        same_info = True
        t0 = time.perf_counter()
        for kf in kfs:
            sharded.db, vec, info = sharded.fns.detect_step(lms, sharded.db,
                                                            kf)
            dense.db, dvec, dinfo = dense.fns.detect_step(lms, dense.db, kf)
            same_info = same_info and torch.equal(info, dinfo)
            vec_gap = max(vec_gap, float((vec - dvec).abs().max()))
            score_gap = max(score_gap, float(
                (sharded.db.scores(vec) - dense.db.scores(vec)).abs().max()))
        torch.cuda.synchronize()
        db_ms = 1e3 * (time.perf_counter() - t0) / max(len(kfs), 1)

        sys4 = System(None, None, STEREO, config=cfg)
        eng = sys4.engine
        eng.loop_closer = LoopCloser(cfg, eng.loop_closer.voc, mesh=mesh)
        sys4.load_map(path)
    lc = eng.loop_closer
    is_sharded = (isinstance(lc.db, db_shard.ShardedKeyFrameDB)
                  and len(lc.db.blocks) == MESH_SHARDS)
    attempt, calls = lc.fns.reloc_attempt, []

    def recorded(*args):
        calls.append((args, args[-1].get_state()))
        return attempt(*args)

    lc.fns = lc.fns._replace(reloc_attempt=recorded)
    poses_gt = shaken_trajectory()
    world = synthetic.make_world(np.random.default_rng(0))  # phase 4's
    T_back = poses_gt[SYS_RELOC_FRAME]
    try:
        Tcw = sys4.track_stereo(*synthetic.render_world_stereo(
            world, cfg.camera, T_back, np.random.default_rng(23), 1.0),
            99.0)
        torch.cuda.synchronize()
    finally:
        lc.fns = lc.fns._replace(reloc_attempt=attempt)
    d = float("inf")
    if Tcw is not None:
        Te = Tcw @ poses_gt[0]
        d = float(np.linalg.norm(-Te[:3, :3].T @ Te[:3, 3]
                                 + T_back[:3, :3].T @ T_back[:3, 3]))
    print(f"[mesh] keyframe DB over {MESH_SHARDS} shards: {len(kfs)} "
          f"keyframes of phase 19's map through detect_step, candidates "
          f"and covisibility rows equal to the dense DB's {same_info}, "
          f"|Δvec| {vec_gap:.2e}, |Δscores| {score_gap:.2e}, "
          f"{db_ms:.1f} ms a keyframe (both closers); System.load_map into "
          f"a loop closer with the mesh: sharded {is_sharded}, "
          f"relocalized within {d:.4f} m, state {sys4.get_tracking_state()} "
          f"({smi})", flush=True)
    if not (same_info and vec_gap <= 1e-6 and score_gap <= 1e-6):
        raise AssertionError("mesh: the sharded DB differs from the dense")
    if not is_sharded:
        raise AssertionError("mesh: load_map left the DB dense")
    if not (d < 0.1 and sys4.get_tracking_state() == tracking.OK):
        raise AssertionError(f"mesh: relocalized {d} m off (need < 0.1)")
    live_reloc_call(eng, attempt, *calls[-1])
    by_site = dict(ht2.hamming_top2.launches_by_site)

    # (d) scaling: the same problem on one shard and on the mesh; that
    # problem's points fill every shard's block, so its solve is also
    # held against one shard's (JAX's sharded-against-single bar, 5e-4)
    sc = scaling.measure_scaling(mesh.devices)
    print(json.dumps(sc), flush=True)
    scfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0)
    scam = cam_mod.Camera.from_config(scfg)
    sprob = scaling._problem(scfg, 64, 512, 8192, device=mesh.devices[0])
    outs = dist_ba.shard_bundle_adjust(mesh, scam, sprob, n_free=64,
                                       fix_first_free=True)
    one = dist_ba.distributed_bundle_adjust(
        mesh_mod.make_mesh(mesh.devices[:1]), scam, sprob, n_free=64,
        fix_first_free=True)[0]
    s_bits = all(torch.equal(o[0], outs[0][0]) for o in outs[1:])
    s_gap = float((outs[0][0] - one).abs().max())
    print(f"[mesh] the scaling problem on {MESH_SHARDS} shards against one: "
          f"|Δpose| {s_gap:.2e}, shards' poses bit-equal {s_bits} ({smi})",
          flush=True)
    if not (s_bits and s_gap < 5e-4):
        raise AssertionError(f"mesh: the scaling problem's sharded solve "
                             f"is off one shard's: {s_gap}, {s_bits}")
    phase_s = time.perf_counter() - t_phase
    print(f"[mesh] phase 23 {phase_s:.1f} s; hamming_top2 launches by path "
          f"{by_site} ({smi})", flush=True)
    return by_site, {"chunk_ms": chunk_ms, "chunk_gib": chunk_gib,
                     "shuffled_ms": pchunk_ms, "mgr_ms": mgr_ms, "plain_ms": plain_ms,
                     "eff_pct": sc["scaling_efficiency_pct"],
                     "phase_s": phase_s}


# phase 24: tools/scale_demo.py's configuration (1024 keyframe slots,
# 131,072 points) over tests/test_scale_circuit.py's scene, cut in depth
SCALE_FRAMES, SCALE_LOG_EVERY = 300, 50
SCALE_SITES = ("match_for_sim3", "reloc_attempt", "track_ref_kf",
               "window/track_ref_kf")


def _live_cuda_tensors(n=4):
    """(MB, shape, dtype) of the ``n`` largest CUDA storages that the
    garbage collector can reach through a tensor."""
    import warnings

    big = {}
    with warnings.catch_warnings():      # deprecated objects among them
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            if torch.is_tensor(obj) and obj.is_cuda:
                st = obj.untyped_storage()
                big[st.data_ptr()] = (round(st.nbytes() / 1e6, 1),
                                      tuple(obj.shape), str(obj.dtype))
    return sorted(big.values(), reverse=True)[:n]


RECOUNT_MAX_BYTES = 0.5e9        # recount_matches alone, above its inputs
LOOP_CHUNK_MAX_MB = 2500.0       # a loop row's peak above the phase's start


def _scale_recount(eng, alone, rows, loop_frames, start, smi):
    """Phase 24's whole-map search: one ``recount_matches`` call alone on
    the final map (the newest live keyframe against its most covisible
    one, the Sim3 of their poses), CUDA-event ms and peak bytes above its
    inputs; the call again with its ``search_by_projection`` outputs
    recorded, and once more in one pass over all P points
    (``matching.PROJECTION_BLOCK`` = P, the [P, N] temporaries of the
    unblocked search): the same count and the same index, distance and uv
    bits.  Bars: the call's peak ≤ RECOUNT_MAX_BYTES; every row whose
    chunk closed a loop peaks ≤ LOOP_CHUNK_MAX_MB above ``start``, the
    bytes allocated when the phase began (what earlier phases left)."""
    from orbslam2_tpu_torch.models import map_state as M
    from orbslam2_tpu_torch.ops import matching

    ms = eng.ms
    fns = eng.loop_closer.fns
    live = torch.nonzero(ms.kf_valid).flatten()
    kf1 = int(live[-1])
    kf2 = int(torch.argmax(M.covisibility_row(ms, kf1)))
    T12 = ms.kf_pose[kf1] @ torch.linalg.inv(ms.kf_pose[kf2])
    s12 = torch.ones((), device=T12.device)
    args = (ms, kf1, kf2, s12, T12[:3, :3].contiguous(),
            T12[:3, 3].contiguous())
    n_blocked, rc_ms, rc_bytes = alone(lambda: fns.recount_matches(*args))
    search, block = matching.search_by_projection, matching.PROJECTION_BLOCK
    outs = []

    def recording(*a, **k):
        out = search(*a, **k)
        outs.append(out)
        return out

    matching.search_by_projection = recording
    try:
        n_rec = fns.recount_matches(*args)
        matching.PROJECTION_BLOCK = ms.P
        n_one, one_ms, one_bytes = alone(lambda: fns.recount_matches(*args))
    finally:
        matching.search_by_projection = search
        matching.PROJECTION_BLOCK = block
    same = (int(n_blocked) == int(n_rec) == int(n_one) and len(outs) == 2
            and all(torch.equal(a, b) for a, b in zip(*outs)))
    chunk = rows[0]["frames"]
    loop_rows = [r for r in rows
                 if any(r["frames"] - chunk <= f < r["frames"]
                        for f in loop_frames)]
    loop_peak = max((r["peak_alloc_MB"] for r in loop_rows),
                    default=0.0) - start / 1e6
    print(f"[recount] recount_matches alone on the final map at {ms.K} KF "
          f"slots, {ms.P} point slots, {ms.N} keypoints (KFs {kf1}, {kf2}): "
          f"{rc_ms:.3f} ms, peak +{rc_bytes / 1e6:.1f} MB above its inputs, "
          f"{ms.P // block} blocks of {block} points; {int(n_blocked)} "
          f"matches; in one pass over all {ms.P} points {one_ms:.3f} ms, "
          f"peak +{one_bytes / 1e6:.1f} MB; count, index, distance and uv "
          f"equal: {same}; chunk peaks of the rows that closed a loop "
          f"{[round(r['peak_alloc_MB'], 1) for r in loop_rows]} MB, of all "
          f"rows {[round(r['peak_alloc_MB'], 1) for r in rows]} MB, "
          f"{start / 1e6:.1f} MB of them allocated before the phase: the "
          f"loop rows' own peak {loop_peak:.1f} MB ({smi})", flush=True)
    if not same:
        raise AssertionError(f"recount: blocked {int(n_blocked)} / "
                             f"{int(n_rec)}, one pass {int(n_one)}, outputs "
                             f"equal {same}")
    if rc_bytes > RECOUNT_MAX_BYTES or loop_peak > LOOP_CHUNK_MAX_MB:
        raise AssertionError(f"recount: peak +{rc_bytes / 1e6:.1f} MB (bar "
                             f"{RECOUNT_MAX_BYTES / 1e6:.0f}), loop-closing "
                             f"chunk +{loop_peak:.1f} MB (bar "
                             f"{LOOP_CHUNK_MAX_MB:.0f})")


def phase_scale(smi):
    """Phase 24: the map-scale circuit.  WindowedSlamEngine(window=4, loop
    closing on, no device given) at tools/scale_demo.py's full
    configuration (1024 keyframe slots, 131,072 points, 1000 features, its
    camera and local-BA sizes) over tests/test_scale_circuit.py's room
    and its 300-frame, 1.15-lap circuit (default_rng(0)), through
    scale_demo.run_circuit, a row every SCALE_LOG_EVERY frames, each row
    ending in a synchronize but no flush(), as test_scale_circuit.py
    drives the engine (a flush tracks the partial window frame by frame,
    and the next window then predicts from an older pose: ROADMAP Queue
    3): fps, keyframes, live points, allocated and chunk-peak memory; the
    loop-closing frame's ms; every global-BA chunk (wall ms on the GBA
    thread, tracking beside it; the solver of each bundle_adjust, which
    must be CG); then, on the final map, one robust GBA chunk alone, one
    covisibility() call (CUDA-event ms, peak bytes) and the whole-map
    search of recount_matches (``_scale_recount``, last, with its own
    bars).  Bars
    (test_scale_circuit.py's): ≥ 95% of frames tracked, ≥ 1 loop closed
    and its GBA merged, n_kfs ≤ 1024, ≥ 30 keyframes inserted, ATE <
    1.5 m; every hamming_top2 matching call of the run replayed with the
    plain version equal.  Returns the launches by site."""
    import threading

    from orbslam2_tpu_torch.models import map_state as M
    from orbslam2_tpu_torch.ops import bundle
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2
    from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu_torch.tools import scale_demo as sd
    from orbslam2_tpu_torch.utils import render_pool, synthetic

    t_phase = time.perf_counter()
    # the rows' chunk peaks count every allocation of the process: free
    # what earlier phases left in reference cycles and the cuBLAS
    # workspaces of their threads' streams, and name what stays
    held = torch.cuda.memory_allocated()
    gc.collect()
    after_gc = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    start = torch.cuda.memory_allocated()
    print(f"[scale] allocated at the phase's start {held / 1e6:.1f} MB, "
          f"{after_gc / 1e6:.1f} MB after gc.collect(), {start / 1e6:.1f} "
          f"MB after clearing the cuBLAS workspaces; the largest live CUDA "
          f"tensors (MB, shape, dtype) {_live_cuda_tensors()} ({smi})",
          flush=True)
    cfg = sd.scale_config()
    rng = np.random.default_rng(0)
    world, poses = sd.small_circuit(rng, SCALE_FRAMES)
    t0 = time.perf_counter()
    frames = render_pool.render_frames(synthetic.render_world_stereo, world,
                                       cfg.camera, poses, rng)
    render_s = time.perf_counter() - t0
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=4)
    if eng.device.type != "cuda":
        raise AssertionError(f"scale: the engine chose {eng.device}")
    mgr = eng.loop_closer.gba
    chunks, solvers = [], []
    f_chunk, ba = mgr.f_chunk, bundle.bundle_adjust

    def timed_chunk(ms, obs_w, use_huber):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = f_chunk(ms, obs_w, use_huber)
        torch.cuda.synchronize()
        chunks.append(1e3 * (time.perf_counter() - t))
        return out

    def recording_ba(*args, **kwargs):
        if threading.current_thread().name == "global-ba":
            solvers.append(kwargs.get("solver"))
        return ba(*args, **kwargs)

    mgr.f_chunk, bundle.bundle_adjust = timed_chunk, recording_ba
    records, restore = _record_matches(*SCALE_SITES)

    def log(r):
        print(f"[scale] frames {r['frames']}: {r['fps']:.2f} fps, n_kfs "
              f"{r['n_kfs']}, live points {r['live_points']}, KFs inserted "
              f"{r['kf_inserted']} / culled {r['kf_culled']}, loops "
              f"{r['loops']}, allocated {r['mem_MB']:.1f} MB, chunk peak "
              f"{r['peak_alloc_MB']:.1f} MB ({smi})", flush=True)

    ht2.reset_launch_counts()          # the scale path's count
    try:
        rows, summary, flog = sd.run_circuit(eng, frames, poses,
                                             SCALE_LOG_EVERY, log,
                                             flush=False)
    finally:
        restore()
        mgr.f_chunk, bundle.bundle_adjust = f_chunk, ba
    by_site = dict(ht2.hamming_top2.launches_by_site)
    same = _replay_plain(records)
    del frames
    loop_ms = {i: round(flog["frame_ms"][i], 1) for i in flog["loop_frames"]}

    ms = eng.ms
    K, N = ms.K, ms.N

    def alone(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b), torch.cuda.max_memory_allocated() - base

    W, cov_ms, cov_bytes = alone(lambda: M.covisibility(ms))
    # eight live rows against point sets on the host
    live = torch.nonzero(ms.kf_valid).flatten().tolist()
    ok, mp, Wh = (M.kf_obs_ok(ms).cpu().numpy(), ms.kf_mp.cpu().numpy(),
                  W.cpu().numpy())
    pts = {k: set(mp[k][ok[k]].tolist()) for k in live}
    cov_ok = (torch.equal(W, W.T) and int(W.diagonal().abs().sum()) == 0
              and all(Wh[i, j] == (len(pts[i] & pts[j]) if i != j else 0)
                      for i in live[:8] for j in live))
    obs = torch.ones(K * N, dtype=torch.bool, device=ms.kf_xy.device)
    n_solves = len(solvers)
    (gms, _), gba_ms, gba_bytes = alone(lambda: f_chunk(ms, obs, True))
    gba_ok = bool(torch.isfinite(gms.kf_pose).all()
                  and torch.isfinite(gms.mp_pos).all())
    del gms
    phase_s = time.perf_counter() - t_phase
    print(f"[scale] {SCALE_FRAMES} frames of the circuit at {K} KF slots, "
          f"{ms.P} point slots, {K * N} observation rows (rendered in "
          f"{render_s:.1f} s): {summary['overall_fps']:.3f} fps = "
          f"{1e3 / summary['overall_fps']:.1f} ms a frame; loop-closing "
          f"frames and their ms {loop_ms}; tracked "
          f"{summary['tracked_frames']}, loops {summary['loops_closed']}, "
          f"KFs inserted {eng.stats['kf_inserted']}, culled "
          f"{eng.stats['kf_culled']}, evicted {summary['kf_evicted']}, "
          f"n_kfs {eng.n_kfs} (peak {summary['peak_kfs']}), live points "
          f"{eng.n_live_points}, ATE {summary['ate_m']:.4f} m; GBA "
          f"{mgr.stats} in {len(chunks)} chunks of "
          f"{[round(c, 1) for c in chunks]} ms (GBA thread, tracking "
          f"beside it), solvers {sorted(set(map(str, solvers)))} "
          f"({n_solves} calls), drain {summary['gba_drain_s']:.2f} s; peak "
          f"allocated {summary['peak_alloc_MB']:.1f} MB; one robust chunk "
          f"alone on the final map {gba_ms:.1f} ms, peak +"
          f"{gba_bytes / 2 ** 30:.3f} GiB; covisibility() {cov_ms:.1f} ms, "
          f"peak +{cov_bytes / 2 ** 30:.3f} GiB, symmetric with a zero "
          f"diagonal and 8 rows equal to the host's point sets: {cov_ok}; "
          f"hamming_top2 launches by path {by_site}, {len(records)} "
          f"matching calls replayed with the plain version: equal {same}; "
          f"phase 24 {phase_s:.1f} s ({smi})", flush=True)
    n = SCALE_FRAMES
    if not (summary["tracked_frames"] >= 0.95 * n
            and summary["loops_closed"] >= 1 and mgr.stats["merged"] >= 1
            and eng.n_kfs <= K and eng.stats["kf_inserted"] >= 30
            and summary["ate_m"] < 1.5):
        raise AssertionError(f"scale: tracked {summary['tracked_frames']} "
                             f"of {n}, loops {summary['loops_closed']}, GBA "
                             f"{mgr.stats}, n_kfs {eng.n_kfs}, KFs inserted "
                             f"{eng.stats['kf_inserted']}, ATE "
                             f"{summary['ate_m']}")
    if not solvers or any(s != "cg" for s in solvers):
        raise AssertionError(f"scale: the GBA at {K} slots took {solvers}")
    if not (cov_ok and gba_ok):
        raise AssertionError(f"scale: covisibility {cov_ok}, the chunk "
                             f"alone finite {gba_ok}")
    if not records or sum(by_site.values()) < 1:
        raise AssertionError("scale: the path never launched hamming_top2")
    if not same:
        raise AssertionError("scale: kernel and plain differ on the "
                             "circuit's matching calls")
    _scale_recount(eng, alone, rows, flog["loop_frames"], start, smi)
    return by_site, {"fps": summary["overall_fps"], "ate_m":
                     summary["ate_m"], "gba_ms": gba_ms,
                     "cov_ms": cov_ms, "phase_s": phase_s}


def main():
    clock = _Clock()
    smi = phase_device()
    phase_build(smi)
    max_err, main_inputs, early_times = phase_kernels(smi)
    clock.lap("phases 1-3")
    (eng, engine_launches, slice_sites, corridor,
     slice_ms) = phase_slice(smi)
    phase_live_call(eng, engine_launches)
    del eng
    clock.lap("phases 4-5")
    eng, poses_gt, scene, rng, loop_sites, orbit = phase_loop(smi)
    orbit_gt, orbit_world = poses_gt, scene
    res = phase_live_loop_call(eng)
    phase_warm_loop_layers(eng, res, smi)
    reloc_sites = phase_reloc(eng, poses_gt, scene, rng, smi)
    del eng
    clock.lap("phases 6-8")
    windowed_sites = phase_windowed_fallback(smi, corridor)
    clock.lap("phase 10")
    eng, frames, poses_gt, bench_sites, slam = phase_bench_slam(smi)
    loc_sites, loc = phase_bench_loc(eng, frames, poses_gt, smi)
    del eng, frames
    clock.lap("phases 11-12")
    (eng, world, rng, poses_gt, rgbd_sites,
     rgbd_frames) = phase_rgbd_slice(smi)
    weng, wframes, wposes, bench_rgbd_sites, rgbd = phase_bench_rgbd(smi)
    localization_sites, _ = phase_localization(
        eng, world, rng, poses_gt,
        {"eng": weng, "frames": wframes, "poses": wposes}, smi)
    del eng, weng, wframes
    clock.lap("phases 13-15")
    gba_times = phase_gba_solvers(smi)
    gba_case = gba_times.pop("case")
    clock.lap("phase 16")
    mono_sites, mono = phase_mono_slice(smi)
    clock.lap("phase 17")
    bench_mono_sites, bench_mono = phase_bench_mono(smi)
    clock.lap("phase 18")
    system_sites, system = phase_system(smi, corridor[:SYS_FRAMES])
    map_npz = system.pop("map_npz")
    clock.lap("phase 19")
    # every timed measurement before the profiled windows of phases 20
    # and 9
    async_sites, asyn = phase_async(smi, corridor, slice_ms)
    for site, n in phase_async_orbit(smi, orbit, orbit_gt,
                                     orbit_world).items():
        async_sites[site] = async_sites.get(site, 0) + n
    del orbit, orbit_world
    clock.lap("phase 20")
    rect = phase_rectify(smi)
    driver_sites, drivers = phase_drivers(smi, corridor, rgbd_frames,
                                          slice_ms)
    del rgbd_frames
    clock.lap("rectify and phase 21")
    vocab_sites, vocab, vocab_root = phase_vocabulary(smi)
    clock.lap("phase 22")
    mesh_sites, mesh = phase_mesh(smi, gba_case, map_npz)
    del gba_case, map_npz
    clock.lap("phase 23")
    scale_sites, scale = phase_scale(smi)
    clock.lap("phase 24")
    k = phase_kernel_times(smi, main_inputs)
    asyn["both_ms"] = phase_async_profiled(smi, corridor)
    del corridor
    k = phase_kernel_device(smi, main_inputs, k, early_times)
    k["vocab_root"] = phase_vocab_kernel_device(smi, vocab_root)
    del vocab_root
    clock.lap("kernel times (phase 9) and the profiled async run")
    by_path = {"slice (phase 4)": slice_sites, "loop (phase 6)": loop_sites,
               "reloc (phase 8)": reloc_sites,
               "windowed (phase 10)": windowed_sites,
               "bench SLAM (phase 11)": bench_sites,
               "bench LOC (phase 12)": loc_sites,
               "RGB-D slice (phase 13)": rgbd_sites,
               "bench RGB-D (phase 14)": bench_rgbd_sites,
               "localization (phase 15)": localization_sites,
               "mono slice (phase 17)": mono_sites,
               "bench mono (phase 18)": bench_mono_sites,
               "System (phase 19)": system_sites,
               "async (phase 20)": async_sites,
               "drivers (phase 21)": driver_sites,
               "vocabulary (phase 22)": vocab_sites,
               "mesh (phase 23)": mesh_sites,
               "scale (phase 24)": scale_sites}
    print(f"[bench] stereo SLAM {slam['slam_fps']:.3f} fps (median of "
          f"{[round(f, 3) for f in slam['pass_fps']]}), ATE "
          f"{slam['ate_m']:.4f} m; stereo LOC {loc['loc_fps']:.3f} fps "
          f"(median of {[round(f, 3) for f in loc['pass_fps']]}); RGB-D "
          f"SLAM {rgbd['rgbd_fps']:.3f} fps, ATE {rgbd['ate_m']:.4f} m; GBA "
          f"chunk at 512 KF slots: CG {gba_times['cg_ms']:.1f} ms / "
          f"{gba_times['cg_gib']:.3f} GiB, dense {gba_times['dense_ms']:.1f} "
          f"ms / {gba_times['dense_gib']:.3f} GiB; mono slice "
          f"{mono['ms']:.1f} ms/frame, ATE {mono['ate_m']:.4f} m; mono SLAM "
          f"{bench_mono['mono_fps']:.3f} fps (passes "
          f"{[round(f, 3) for f in bench_mono['pass_fps']]}), "
          f"{bench_mono['kf_per_frame']:.4f} KFs a frame; System "
          f"{system['ms']:.1f} ms/frame, save_map {system['save_ms']:.1f} "
          f"ms / load_map {system['load_ms']:.1f} ms ({system['mb']:.3f} "
          f"MB), replay median {system['replay_median_ms']:.1f} / mean "
          f"{system['replay_mean_ms']:.1f} ms; async {asyn['ms']:.1f} "
          f"ms/frame (worst {asyn['worst_ms']:.1f}), "
          f"{asyn['kf_per_frame']:.4f} KFs a frame, busy mapper "
          f"{100 * asyn['busy_share']:.1f}%, both streams busy "
          f"{asyn['both_ms']:.3f} ms; remap_pair {rect['device_ms']:.4f} "
          f"ms / host {rect['host_ms']:.3f} ms; drivers median / mean ms "
          + "; ".join(f"{n} {drivers[n]['median_ms']:.1f} / "
                      f"{drivers[n]['mean_ms']:.1f} (decode "
                      f"{drivers[n]['decode_ms']:.2f})"
                      for n in ("kitti", "tum", "euroc"))
          + f"; stream node {drivers['stream']['paced_ms']:.1f} ms a frame; "
          f"detect_plane {drivers['ar']['ms']:.3f} ms; vocabulary: "
          f"harvest {vocab['render_ms']:.1f} + {vocab['extract_ms']:.2f} ms "
          f"a view, build {vocab['build_s']:.3f} s on the card / "
          f"{vocab['cpu_build_s']:.2f} s on the CPU; mesh of "
          f"{MESH_SHARDS} shards on cuda:0: a GBA chunk "
          f"{mesh['chunk_ms']:.1f} ms / {mesh['chunk_gib']:.3f} GiB "
          f"({mesh['shuffled_ms']:.1f} ms with the slots shuffled), the "
          f"manager {mesh['mgr_ms']:.1f} ms against {mesh['plain_ms']:.1f} "
          f"unsharded, scaling efficiency {mesh['eff_pct']:.1f}% "
          f"(phase 23 {mesh['phase_s']:.1f} s); map scale at 1024 KF "
          f"slots: {scale['fps']:.3f} fps, ATE {scale['ate_m']:.4f} m, a "
          f"GBA chunk {scale['gba_ms']:.1f} ms, covisibility "
          f"{scale['cov_ms']:.1f} ms (phase 24 {scale['phase_s']:.1f} s) "
          f"({smi})", flush=True)
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
