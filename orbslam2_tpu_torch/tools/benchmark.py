"""Replay harness: per-frame latency of a sequence through ``System``.

Port of ``tools/benchmarks/benchmark.py`` over the port's
``tools/replay.py``: a synthetic stereo sequence, or a KITTI, TUM or
EuRoC sequence at ``--path`` with its ``--settings``; prints the card
that ran it (name and power limit, as ``nvidia-smi`` gives them), the
replay's summary, then one JSON line of the JAX script's keys.

    python -m orbslam2_tpu_torch.tools.benchmark [--kind synthetic|kitti|
        tum|euroc] [--path DIR] [--settings YAML] [--frames 40]
        [--device cuda|cpu]

It runs on the CUDA card (the default) and raises where torch finds
none; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import torch

from orbslam2_tpu_torch.tools import replay
from orbslam2_tpu_torch.tools.scale_demo import device_line


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m orbslam2_tpu_torch.tools.benchmark",
        description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=["synthetic", "kitti", "tum", "euroc"],
                    default="synthetic")
    ap.add_argument("--path", default=None)
    ap.add_argument("--settings", default=None)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    a = ap.parse_args(argv)

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("benchmark: --device cuda and torch finds no CUDA "
                           "device; pass --device cpu to run on the CPU")
    print(f"device: {device_line(dev)}", flush=True)
    if a.kind == "synthetic":
        rep = replay.run_synthetic_stereo(a.frames, device=dev)
    elif a.kind == "kitti":
        rep = replay.run_kitti_stereo(a.path, a.settings,
                                      max_frames=a.frames, device=dev)
    elif a.kind == "tum":
        rep = replay.run_tum_rgbd(a.path, a.settings, max_frames=a.frames,
                                  device=dev)
    else:
        rep = replay.run_euroc_stereo(a.path, a.settings,
                                      max_frames=a.frames, device=dev)
    rep.print_summary()
    out = {"median_ms": rep.median_ms, "mean_ms": rep.mean_ms,
           "fps": 1000.0 / max(rep.median_ms, 1e-9),
           "tracked": rep.n_tracked, "frames": rep.n_frames}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
