"""Map-scale circuit: the windowed engine around a closed room at 1024
keyframe slots and 131,072 map points.

Port of ``tools/benchmarks/scale_demo.py``: the same configuration,
scene, trajectory and seed (``scale_demo.py:43-71``), the same 200-frame
chunks, per-chunk rows and JSON summary.  The camera tours a
rounded-rectangle in a room of 120 m a side and comes back to its start
near frame 2100, so the late loops close on a map of hundreds of
keyframes and the global BA runs at 1024 slots (the CG solver).

    python -m orbslam2_tpu_torch.tools.scale_demo [n_frames] [--laps 1.15]
        [--max-kf 1024] [--max-mp 131072] [--window 4] [--out table.md]
        [--device cuda|cpu]

It runs on the CUDA card (``--device cuda``, the default) and raises
where torch finds none; ``--device cpu`` runs on the CPU.  The frames are
rendered on host threads, bit-equal to a sequential render.  On the card
the hand-written kernel is built and loaded before the timed loop, so no
chunk times ``nvcc``.  Memory is torch's caching allocator's count of
bytes held by tensors: ``mem_MB`` after each chunk
(``torch.cuda.memory_allocated``) and ``peak_alloc_MB``, the most during
the chunk (``max_memory_allocated``, reset at the chunk's start); None on
the CPU.  The markdown table is written only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.ops import hamming_top2 as ht2
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.utils import render_pool, synthetic

CHUNK = 200


def scale_config(max_kf: int = 1024, max_mp: int = 1 << 17,
                 n_features: int = 1000) -> SlamConfig:
    """``scale_demo.py:43-53``: 320×240 stereo, 1000 features, local BA
    over 8 keyframes and 2048 points."""
    return SlamConfig(
        camera=CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                            bf=120.0, width=320, height=240, fps=10.0,
                            th_depth=35.0),
        orb=OrbConfig(n_features=n_features),
        capacity=CapacityConfig(max_keyframes=max_kf, max_map_points=max_mp,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=STEREO)


def scale_scene(rng: np.random.Generator, n_frames: int, laps: float = 1.15
                ) -> Tuple[synthetic.World, List[np.ndarray]]:
    """``scale_demo.py:55-71``: the 120 m room (texture period 2048/17 =
    120 m, no repetition to alias place recognition) and the circuit,
    looking out toward the outer wall and down at the ground."""
    world = synthetic.room_world(rng, half=60.0, tex_size=2048)
    for pl in world.planes:
        pl.scale = 17.0
    poses = synthetic.circuit_trajectory(n_frames, half=55.0, corner=12.0,
                                         laps=laps, yaw_out=0.45,
                                         pitch=-0.2)
    return world, poses


def small_circuit(rng: np.random.Generator, n_frames: int = 300
                  ) -> Tuple[synthetic.World, List[np.ndarray]]:
    """tests/test_scale_circuit.py's scene and trajectory, the repo's
    CPU-sized variant of the circuit: a 48 m room (plane scale 10) and
    1.15 laps of a 38 m rounded square in ``n_frames`` frames, the camera
    looking along the path."""
    world = synthetic.room_world(rng, half=24.0, tex_size=512)
    for pl in world.planes:
        pl.scale = 10.0
    poses = synthetic.circuit_trajectory(n_frames, half=19.0, corner=7.0,
                                         laps=1.15)
    return world, poses


def circuit_ate(est: Sequence[Optional[np.ndarray]],
                poses: Sequence[np.ndarray]) -> float:
    """RMSE of camera centres against ground truth rebased so that camera
    0 is the origin (the engine's world frame is the first camera), over
    the tracked frames (``scale_demo.py:123-135``)."""
    T0inv = np.linalg.inv(poses[0])
    errs = []
    for Te, Tg in zip(est, [T @ T0inv for T in poses]):
        if Te is None:
            continue
        Ce = -Te[:3, :3].T @ Te[:3, 3]
        Cg = -Tg[:3, :3].T @ Tg[:3, 3]
        errs.append(np.sum((Ce - Cg) ** 2))
    return float(np.sqrt(np.mean(errs))) if errs else float("nan")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_circuit(eng: WindowedSlamEngine, frames, poses,
                chunk: int = CHUNK,
                log: Optional[Callable[[Dict], None]] = print,
                flush: bool = True) -> Tuple[List[Dict], Dict, Dict]:
    """Drive ``eng`` over ``frames`` in chunks of ``chunk`` frames, each
    ending in ``flush()`` and a synchronize, then drain the global BA.
    With ``flush=False`` a chunk ends in the synchronize alone, so that
    the rows do not change what the engine does: ``flush()`` retires the
    window in flight and tracks the partial window frame by frame.

    Returns (rows, summary, frame_log): a row a chunk and the summary,
    each with the JAX script's keys plus ``peak_alloc_MB``, and per frame
    the wall ms of its ``track_stereo`` call, with the frames during
    whose call a loop closed (``loop_frames``; the flush that ends a
    chunk counts as its last frame)."""
    dev = eng.device
    cuda = dev.type == "cuda"
    n = len(frames)
    rows: List[Dict] = []
    frame_ms: List[float] = []
    loop_frames: List[int] = []
    t_start = time.perf_counter()
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for i in range(c0, c1):
            loops = eng.stats["loops_closed"]
            t1 = time.perf_counter()
            eng.track_stereo(*frames[i], timestamp=0.1 * i)
            frame_ms.append(1e3 * (time.perf_counter() - t1))
            if eng.stats["loops_closed"] > loops:
                loop_frames.append(i)
        loops = eng.stats["loops_closed"]
        if flush:
            eng.flush()
        _sync(dev)
        if eng.stats["loops_closed"] > loops:
            loop_frames.append(c1 - 1)
        dt = time.perf_counter() - t0
        row = {
            "frames": c1,
            "fps": (c1 - c0) / dt,
            "n_kfs": eng.n_kfs,
            "live_points": eng.n_live_points,
            "kf_inserted": eng.stats["kf_inserted"],
            "kf_culled": eng.stats["kf_culled"],
            "loops": eng.stats.get("loops_closed", 0),
            "state": eng.state,
            "mem_MB": torch.cuda.memory_allocated(dev) / 1e6 if cuda
            else None,
            "peak_alloc_MB": torch.cuda.max_memory_allocated(dev) / 1e6
            if cuda else None,
        }
        rows.append(row)
        if log is not None:
            log(row)
    wall = time.perf_counter() - t_start

    t0 = time.perf_counter()
    eng.finish_gba()
    _sync(dev)
    gba_drain = time.perf_counter() - t0

    est = eng.frame_poses()
    tracked = sum(p is not None for p in est)
    first_fps = float(np.median([r["fps"] for r in rows[:3]]))
    last_fps = float(np.median([r["fps"] for r in rows[-3:]]))
    peaks = [r["peak_alloc_MB"] for r in rows if r["peak_alloc_MB"]]
    summary = {
        "metric": "scale_demo",
        "n_frames": n,
        "capacity_kf": eng.cfg.capacity.max_keyframes,
        "capacity_mp": eng.cfg.capacity.max_map_points,
        "wall_s": wall,
        "overall_fps": n / wall,
        "fps_first3_chunks": first_fps,
        "fps_last3_chunks": last_fps,
        "fps_degradation": first_fps / max(last_fps, 1e-9),
        "peak_kfs": max(r["n_kfs"] for r in rows),
        "peak_points": max(r["live_points"] for r in rows),
        "loops_closed": rows[-1]["loops"],
        "kf_evicted": eng.stats.get("kf_evicted", 0),
        "gba_runs": eng.loop_closer.gba.stats.get("finished", 0)
        if eng.loop_closer else 0,
        "gba_drain_s": gba_drain,
        "tracked_frames": tracked,
        "ate_m": circuit_ate(est, poses),
        "mem_MB_last": rows[-1]["mem_MB"],
        "peak_alloc_MB": max(peaks) if peaks else None,
    }
    return rows, summary, {"frame_ms": frame_ms, "loop_frames": loop_frames}


def markdown(rows: List[Dict], summary: Dict, laps: float, smi: str) -> str:
    """The JAX script's table (``scale_demo.py:140-154``) with the port's
    memory columns, and the summary."""
    out = ["# Map-scale circuit (orbslam2_tpu_torch)\n",
           f"Circuit: {summary['n_frames']} frames, {laps} laps of a "
           "rounded-rectangle tour (~420 m/lap) in a closed room; capacity "
           f"{summary['capacity_kf']} keyframes / {summary['capacity_mp']} "
           "map points; loop closing + background GBA on.  Generated by "
           f"`python -m orbslam2_tpu_torch.tools.scale_demo` on {smi}.\n",
           "| frames | fps | keyframes | points | culled | loops | "
           "allocated MB | chunk peak allocated MB |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['frames']} | {r['fps']:.3f} | {r['n_kfs']} | "
                   f"{r['live_points']} | {r['kf_culled']} | {r['loops']} | "
                   f"{r['mem_MB']} | {r['peak_alloc_MB']} |")
    out.append("\n```json\n" + json.dumps(summary, indent=2) + "\n```\n")
    return "\n".join(out)


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m orbslam2_tpu_torch.tools.scale_demo")
    ap.add_argument("n_frames", nargs="?", type=int, default=2400)
    ap.add_argument("--laps", type=float, default=1.15)
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-mp", type=int, default=1 << 17)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    a = ap.parse_args(argv)

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scale_demo: --device cuda and torch finds no "
                           "CUDA device; pass --device cpu to run on the "
                           "CPU")
    smi = device_line(dev)
    print(f"[scale] {smi} | torch {torch.__version__}", flush=True)
    if dev.type == "cuda":
        from orbslam2_tpu_torch.kernels import build

        t0 = time.perf_counter()
        build.load("hamming_top2")
        print(f"[scale] hamming_top2 kernel built and loaded before the "
              f"timed loop in {time.perf_counter() - t0:.2f} s", flush=True)

    cfg = scale_config(a.max_kf, a.max_mp)
    rng = np.random.default_rng(7)
    world, poses = scale_scene(rng, a.n_frames, a.laps)
    print(f"[scale] rendering {a.n_frames} stereo pairs on "
          f"{render_pool.RENDER_THREADS} threads ...", flush=True)
    t0 = time.perf_counter()
    frames = render_pool.render_frames(synthetic.render_world_stereo, world,
                                       cfg.camera, poses, rng)
    print(f"[scale] rendered in {time.perf_counter() - t0:.1f} s",
          flush=True)

    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, device=dev,
                             window=a.window)
    ht2.reset_launch_counts()
    rows, summary, flog = run_circuit(
        eng, frames, poses, CHUNK, log=lambda r: print(r, flush=True))
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    loop_ms = {i: flog["frame_ms"][i] for i in flog["loop_frames"]}
    print(f"[scale] loop-closing frames and their track_stereo ms: "
          f"{loop_ms}; {1e3 / summary['overall_fps']:.1f} ms a frame over "
          f"the run", flush=True)
    print(f"[scale] hamming_top2 launches by site "
          f"{dict(ht2.hamming_top2.launches_by_site)}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(markdown(rows, summary, a.laps, smi))
        print(f"[scale] wrote {a.out}", flush=True)
    return summary


if __name__ == "__main__":
    main()
