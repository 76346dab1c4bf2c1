"""How often does the orbit (chip_smoke.py phase 6) close its loop when the
async engine maps it, and where does a Sim3 attempt fail when it does not?

    PYTHONPATH=. python3 orbslam2_tpu_torch/tools/async_orbit_spread.py \\
        --runs 4 [--drained 1] [--sync 1] [--extra 0] [--out spread.json]

Renders phase 6's 72-frame orbit once (and ``--extra`` frames more of the
same orbit, at the same step), then maps it ``--sync`` times with
the per-frame ``SlamEngine``, ``--drained`` times with ``AsyncSlamEngine``
drained after every frame (the worker maps each keyframe before the next
frame is tracked), and ``--runs`` times with ``AsyncSlamEngine`` running
free, as phase 20 (b) does, all with loop closing on.  Each run prints one
JSON line: frames tracked and the lost ones, keyframes inserted, loops
closed, the closing pair and the frame of its newer keyframe, the global BA's counts, the ATE, and every
loop-detection pass (keyframe slot and ordinal, candidates, candidates
with enough consistent groups) and Sim3 attempt (candidate, descriptor
matches, RANSAC inliers and ``ok``, refined inliers, re-projected
matches; ``None`` where the attempt stopped earlier; the two keyframes'
frames and their features with a live map point).  Needs a CUDA card;
run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _instrument(lc, log):
    """Wrap the loop closer's detection and Sim3 stages to log each pass
    and attempt."""
    f = lc.fns
    evaluate = lc._evaluate_candidates

    def evaluate_candidates(ms, kf, kf_ordinal, cands, rows):
        n = len(log["attempts"])
        groups = lc.consistent_groups
        out = evaluate(ms, kf, kf_ordinal, cands, rows)
        if out[1]:
            log["closing_frame"] = int(ms.kf_frame_id[kf])
        log["passes"].append({
            "kf": kf, "ordinal": kf_ordinal, "cands": cands,
            "prev_groups": len(groups),
            "attempts": len(log["attempts"]) - n, "closed": bool(out[1])})
        return out

    def mapped(ms, kf):
        mp = ms.kf_mp[kf].long()
        return int((ms.kf_kp_valid[kf] & (mp >= 0)
                    & ms.mp_valid[mp.clamp(min=0)]).sum())

    def match_for_sim3(ms, kf1, kf2, generator, idx=None):
        res, m = f.match_for_sim3(ms, kf1, kf2, generator, idx)
        log["attempts"].append({
            "kf": kf1, "cand": kf2,
            "frames": [int(ms.kf_frame_id[kf1]), int(ms.kf_frame_id[kf2])],
            "points": [mapped(ms, kf1), mapped(ms, kf2)],
            "matches": int((m >= 0).sum()),
            "ransac_inliers": int(res.n_inliers), "ok": bool(res.ok),
            "refined": None, "recount": None})
        return res, m

    def refine_sim3(*args):
        out = f.refine_sim3(*args)
        log["attempts"][-1]["refined"] = int(out[3])
        return out

    def recount_matches(*args):
        out = f.recount_matches(*args)
        log["attempts"][-1]["recount"] = int(out)
        return out

    lc._evaluate_candidates = evaluate_candidates
    lc.fns = f._replace(match_for_sim3=match_for_sim3,
                        refine_sim3=refine_sim3,
                        recount_matches=recount_matches)


def _drain(eng):
    while eng._jobs or eng._worker_busy:
        time.sleep(0.002)


def run_once(kind, cfg, frames, poses_gt):
    import numpy as np
    import torch

    from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine
    from orbslam2_tpu_torch.runtime.slam import SlamEngine

    eng = (SlamEngine(cfg) if kind == "sync" else AsyncSlamEngine(cfg))
    log = {"closing_frame": None, "passes": [], "attempts": []}
    _instrument(eng.loop_closer, log)
    lost = []
    t0 = time.perf_counter()
    if kind != "sync":
        eng.start()
    try:
        for i, (left, right) in enumerate(frames):
            if eng.track_stereo(left, right, 0.1 * i) is None:
                lost.append(i)
            torch.cuda.current_stream().synchronize()
            if kind == "drained":
                _drain(eng)
    finally:
        if kind == "sync":
            eng.finish_gba()
        else:
            eng.shutdown()
    torch.cuda.synchronize()
    errs = []
    for Te, Tg in zip(eng.frame_poses(), poses_gt):
        if Te is not None:
            Te = Te @ poses_gt[0]    # the engine's world is the first camera
            errs.append(float(np.sum((-Te[:3, :3].T @ Te[:3, 3]
                                      + Tg[:3, :3].T @ Tg[:3, 3]) ** 2)))
    return {"kind": kind, "tracked": len(frames) - len(lost), "lost": lost,
            "kf_inserted": eng.stats["kf_inserted"], "stats": eng.stats,
            "loops_closed": eng.stats["loops_closed"],
            "closing_pair": list(eng.loop_closer.last_loop or ()),
            "gba": dict(eng.loop_closer.gba.stats),
            "ate_m": float(np.sqrt(np.mean(errs))),
            "wall_s": time.perf_counter() - t0, **log}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--drained", type=int, default=1)
    ap.add_argument("--sync", type=int, default=1)
    ap.add_argument("--extra", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np

    import chip_smoke
    from orbslam2_tpu_torch.utils import synthetic

    smi = chip_smoke.phase_device()
    chip_smoke.phase_build(smi)
    cfg = chip_smoke.bench_config()
    rng = np.random.default_rng(0)          # phase 6's scene and frames
    scene = chip_smoke.orbit_scene(rng, z_center=chip_smoke.ORBIT_Z)
    poses_gt = chip_smoke.outward_orbit(
        chip_smoke.ORBIT_FRAMES, chip_smoke.ORBIT_RADIUS,
        chip_smoke.ORBIT_Z, chip_smoke.ORBIT_TURNS)
    frames = [synthetic.render_stereo(scene, cfg.camera, T, rng, 1.0)
              for T in poses_gt]
    if args.extra:                  # the orbit continued at the same step
        more = chip_smoke.outward_orbit(
            chip_smoke.ORBIT_FRAMES, chip_smoke.ORBIT_RADIUS,
            chip_smoke.ORBIT_Z, chip_smoke.ORBIT_TURNS,
            stop=chip_smoke.ORBIT_FRAMES + args.extra)[len(poses_gt):]
        rng = np.random.default_rng(20)
        frames += [synthetic.render_stereo(scene, cfg.camera, T, rng, 1.0)
                   for T in more]
        poses_gt = poses_gt + more
    results = []
    for kind, n in (("sync", args.sync), ("drained", args.drained),
                    ("free", args.runs)):
        for _ in range(n):
            r = run_once(kind, cfg, frames, poses_gt)
            r["device"] = smi
            print(json.dumps(r), flush=True)
            results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    summary = [(r["kind"], r["loops_closed"], r["gba"]["merged"],
                r["closing_frame"], r["kf_inserted"], r["tracked"],
                round(r["ate_m"], 4))
               for r in results]
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
