"""Sharded bundle adjustment against one shard, on the same problem.

Port of ``tools/benchmarks/scaling.py``: the same synthetic problem (the
same seeds and draws) solved by ``parallel/dist_ba.distributed_bundle_
adjust`` on a 1-shard mesh and on a mesh of all the given shards.  With
the shards on distinct devices, ``scaling_efficiency_pct`` is strong
scaling (t(1) / t(N), × 100; ideal 100).  Where shards share a device
(``[cuda:0] * 4``, or ``["cpu"] * 8``) no speedup is possible: the number
is the sharding overhead (the share of one shard's throughput that
survives the partition, the collectives and N× the launches).

    python -m orbslam2_tpu_torch.tools.scaling [--shards 4] [--device cuda:0]

prints one JSON line with the JAX script's keys.  With ``--threads`` it
prints instead what shard threads cost the host (``measure_threads``):
free-running against taking turns, as ``Mesh.run``'s shards do.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from orbslam2_tpu_torch.config import CameraConfig
from orbslam2_tpu_torch.ops import bundle
from orbslam2_tpu_torch.parallel import dist_ba, mesh as mesh_mod
from orbslam2_tpu_torch.utils import camera as cam_mod


def _problem(cam_cfg, C, pts_per_cam, n_pts, seed=0, device=None):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts),
                    rng.uniform(6, 25, n_pts)], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    poses[:, 0, 3] = 0.1 * np.arange(C)
    cam_i = np.repeat(np.arange(C, dtype=np.int32), pts_per_cam)
    pt_i = np.concatenate([
        rng.choice(n_pts, pts_per_cam, replace=False).astype(np.int32)
        for _ in range(C)])
    pc = pts[pt_i] + poses[cam_i][:, :3, 3]
    z = pc[:, 2]
    uv = np.stack([cam_cfg.fx * pc[:, 0] / z + cam_cfg.cx,
                   cam_cfg.fy * pc[:, 1] / z + cam_cfg.cy], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    ur = uv[:, 0] - cam_cfg.bf / z
    O = len(cam_i)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return bundle.BAProblem(
        poses=t(poses), points=t(pts + rng.normal(0, 0.03, pts.shape),
                                 np.float32),
        point_valid=t(np.ones(n_pts, bool)), cam_i=t(cam_i, np.int64),
        pt_i=t(pt_i, np.int64), uv=t(uv, np.float32),
        ur=t(ur, np.float32), inv_sigma2=t(np.ones(O, np.float32)),
        valid=t(np.ones(O, bool)))


def measure_scaling(devices: Optional[Sequence] = None, C: int = 64,
                    pts_per_cam: int = 512, n_pts: int = 8192,
                    repeats: int = 3) -> Dict:
    """Returns {"scaling_devices", "scaling_efficiency_pct", ...} (the
    JAX script's keys; times unrounded).  ``devices``: the mesh's
    shards, by default every local CUDA device."""
    meshN = mesh_mod.make_mesh(devices)
    mesh1 = mesh_mod.make_mesh(meshN.devices[:1])
    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0)
    cam = cam_mod.Camera.from_config(cam_cfg)
    prob = _problem(cam_cfg, C, pts_per_cam, n_pts,
                    device=meshN.devices[0])

    def run(mesh):
        poses, _, _ = dist_ba.distributed_bundle_adjust(
            mesh, cam, prob, n_free=C, iters_a=5, iters_b=10,
            fix_first_free=True, solver="cg")
        if poses.is_cuda:
            torch.cuda.synchronize(poses.device)
        return poses

    def timed(mesh):
        run(mesh)                          # warm-up
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(mesh)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = timed(mesh1)
    tN = timed(meshN)
    shared = len(set(meshN.devices)) < len(meshN.devices)
    return {
        "scaling_devices": meshN.size,
        "scaling_mode": ("sharding-overhead proxy (shards share one device)"
                         if shared else "strong scaling"),
        "scaling_unsharded_ms": t1 * 1e3,
        "scaling_sharded_ms": tN * 1e3,
        "scaling_efficiency_pct": 100.0 * t1 / tN if tN > 0 else 0.0,
        "scaling_shapes": {"cameras": C, "observations": C * pts_per_cam,
                           "points": n_pts},
    }


def _calls(x, n):
    for _ in range(n):
        x = x * 0.5 + 1
    return x


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_threads(device="cpu", shards=(1, 2, 4, 8), calls=5000,
                    sums=200, numel=6) -> Dict:
    """Wall µs a call and a shard when N threads each issue ``calls``
    torch calls (``x * 0.5 + 1`` on ``numel`` floats on ``device``):
    free-running (they contend for the GIL and, on the CPU, the intra-op
    threads) and in ``Mesh.run``, where they take turns; and µs a
    ``Mesh.allsum``."""
    out = {"device": str(device), "calls": calls, "numel": numel}
    _calls(torch.ones(numel, device=device), calls)        # warm-up
    for n in shards:
        xs = [torch.ones(numel, device=device) for _ in range(n)]
        _sync(device)
        t0 = time.perf_counter()
        ts = [threading.Thread(target=_calls, args=(x, calls)) for x in xs]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        _sync(device)
        free = time.perf_counter() - t0
        mesh = mesh_mod.make_mesh([device] * n)
        t0 = time.perf_counter()
        mesh.run(lambda x: _calls(x, calls), xs)
        _sync(device)
        turns = time.perf_counter() - t0

        def summing(x):
            for _ in range(sums):
                x = mesh.allsum(x) * 0.5
            return x

        t0 = time.perf_counter()
        mesh.run(summing, xs)
        _sync(device)
        out[str(n)] = {"free_us_a_call": 1e6 * free / calls,
                       "turns_us_a_call": 1e6 * turns / calls,
                       "allsum_us": 1e6 * (time.perf_counter() - t0) / sums}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=None,
                    help="shards on --device (default: one a CUDA device)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--threads", action="store_true",
                    help="time shard threads instead (measure_threads)")
    ap.add_argument("--calls", type=int, default=5000)
    ap.add_argument("--numel", type=int, default=6)
    a = ap.parse_args(argv)
    if a.threads:
        torch.set_num_threads(2)
        print(json.dumps(measure_threads(a.device, calls=a.calls,
                                         numel=a.numel)))
        return
    devices = None if a.shards is None else [a.device] * a.shards
    print(json.dumps(measure_scaling(devices, repeats=a.repeats)))


if __name__ == "__main__":
    main()
