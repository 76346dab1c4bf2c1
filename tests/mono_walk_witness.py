"""bench.py's mono loop over bench.py's mono frames, on the JAX package's
windowed engine or the port's, with what each frame decided.

    python tests/mono_walk_witness.py --package jax|port [--device cpu]
        [--threads N] [--seeds default,1,2] [--flush-after-warmup]
        [--idle natural|true] [--out PATH] [--against PATH]

The loop is bench.py's (bench.py:211-222, no prewarm): 28 warm-up
frames, then two passes of 48, each ending in ``flush()``;
``--flush-after-warmup`` adds one after the warm-up, which starts the
mono windows a frame later.  A seed other than ``default`` reseeds the
mono bootstrap's and the loop closer's RANSAC draws (JAX: ``PRNGKey(7)``
and ``PRNGKey(42)`` become ``seed`` and ``100 + seed``; the port: its
``MONO_SEED`` and its closer's generator).  ``--idle true`` makes the
engine read its mapper as idle (the port's always is on the CPU).  One
JSON line a seed: keyframes (in all and a pass), the first frame lost
or relocalized, the relocalized frames, the lost frames, the end state,
the frames with a trajectory entry, map points created a keyframe, and
the answers read as a busy mapper; ``--out`` also writes each frame's
keyframe decision (frame, map inliers, decision), and ``--against`` a
file so written names the first frame where the two runs' decisions or
inliers differ.  ``--package port`` imports nothing of JAX and runs on
the card unless ``--device cpu``.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARMUP, MEASURE, PASSES = 28, 48, 2


def _engine(package, cfg, device, seed):
    if package == "jax":
        import dataclasses

        import jax

        jax.config.update("jax_platforms", "cpu")
        if seed != "default":
            key = jax.random.PRNGKey
            jax.random.PRNGKey = lambda x: key(
                {7: int(seed), 42: 100 + int(seed)}.get(x, x))
        from orbslam2_tpu import config as jconfig
        from orbslam2_tpu.runtime.windowed import WindowedSlamEngine

        jcfg = jconfig.SlamConfig(
            camera=jconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
            orb=jconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
            capacity=jconfig.CapacityConfig(
                **dataclasses.asdict(cfg.capacity)),
            sensor=jconfig.MONOCULAR)
        return WindowedSlamEngine(jcfg, enable_loop_closing=True, window=4)
    from orbslam2_tpu_torch.config import MONOCULAR
    from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine

    class Seeded(WindowedSlamEngine):
        MONO_SEED = WindowedSlamEngine.MONO_SEED if seed == "default" \
            else int(seed)

    eng = Seeded(cfg.replace(sensor=MONOCULAR), enable_loop_closing=True,
                 device=device, window=4)
    if seed != "default":
        eng.loop_closer.generator.manual_seed(100 + int(seed))
    return eng


def run(package, frames, cfg, device, seed, flush_after_warmup, idle):
    eng = _engine(package, cfg, device, seed)
    busy, decisions, log = [0], [], []
    read_idle, decide = eng._mapper_idle, eng._need_new_keyframe

    def mapper_idle():
        out = True if idle == "true" else read_idle()
        busy[0] += not out
        return out

    def need(sm, ref_override=None):
        out = decide(sm, ref_override)
        decisions.append([int(eng.frame_id), int(sm.n_inliers_map),
                          bool(out)])
        return out

    eng._mapper_idle, eng._need_new_keyframe = mapper_idle, need
    img = (lambda f: f.astype(np.uint8)) if package == "jax" else \
        (lambda f: f)
    n = WARMUP + PASSES * MEASURE
    ends = {WARMUP + (p + 1) * MEASURE - 1 for p in range(PASSES)}
    if flush_after_warmup:
        ends.add(WARMUP - 1)
    for i in range(n):
        eng.track_monocular(img(frames[i]), 0.1 * i)
        log.append((int(eng.state), int(eng.stats["kf_inserted"]),
                    int(eng.stats["reloc"])))
        if i in ends:
            eng.flush()
    lost = [i for i, (st, _, _) in enumerate(log) if st == 3]
    relocs = [i for i in range(1, n) if log[i][2] != log[i - 1][2]]
    kf = int(eng.stats["kf_inserted"])
    passes = [log[WARMUP + (p + 1) * MEASURE - 1][1]
              - log[WARMUP + p * MEASURE - 1][1] for p in range(PASSES)]
    return {"package": package, "device": str(device), "seed": seed,
            "flush_after_warmup": flush_after_warmup, "idle": idle,
            "keyframes": kf, "keyframes_a_pass": passes,
            "first_loss": min(lost + relocs) if lost + relocs else None,
            "relocalized_at": relocs, "lost_frames": len(lost),
            "ends": "LOST" if int(eng.state) == 3 else "OK",
            "entries": len(eng.trajectory),
            "points_a_keyframe": eng.stats["mp_created"] / max(kf, 1),
            "busy_answers": busy[0]}, decisions


def first_difference(a, b):
    """The first frame whose decision or map inliers differ, with both."""
    da, db = {d[0]: d for d in a}, {d[0]: d for d in b}
    for f in sorted(set(da) | set(db)):
        if da.get(f) != db.get(f):
            return f, da.get(f), db.get(f)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--seeds", default="default")
    ap.add_argument("--flush-after-warmup", action="store_true")
    ap.add_argument("--idle", choices=("natural", "true"), default="true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--against", default=None)
    a = ap.parse_args(argv)
    import torch

    if a.threads:
        torch.set_num_threads(a.threads)
    from orbslam2_tpu_torch.tools import bench

    cfg = bench.bench_config()
    frames = bench.bench_frames(cfg, counts=(0, WARMUP + PASSES * MEASURE,
                                             0)).mono
    device = a.device or ("cuda" if torch.cuda.is_available() else "cpu")
    runs = []
    for seed in a.seeds.split(","):
        summary, decisions = run(a.package, frames, cfg, device, seed,
                                 a.flush_after_warmup, a.idle)
        if a.against:
            with open(a.against) as f:
                summary["first_difference"] = first_difference(
                    decisions, json.load(f)[0]["decisions"])
        print(json.dumps(summary), flush=True)
        runs.append(dict(summary, decisions=decisions))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(runs, f)


if __name__ == "__main__":
    main()
