"""Does the orbit run (chip_smoke.py phase 6) give the same answer twice
on the card under deterministic algorithms?

    CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=. \\
        python3 orbslam2_tpu_torch/tools/orbit_spread.py --mode strict
    ... --mode warn [--out spread.json]

``--mode strict``: ``torch.use_deterministic_algorithms(True)``; the first
op without a deterministic CUDA implementation raises, and the script
prints which one.  ``--mode warn``: the same with ``warn_only=True``, so
the run completes and every such op is listed once.  ``--mode off``: the
default algorithms.  ``--mode index_add``: the default algorithms, but
every ``Tensor.index_add_`` on a CUDA tensor runs as ``index_put_(...,
accumulate=True)``, which sorts its indices there (torch's own
deterministic form of ``index_add_``), to test whether that one op
carries the spread.  (It did; the port's float segment sums now go
through ``index.scatter_add``, which sorts on CUDA, so ``off`` gives one
answer too.)  Each completed run prints (and writes to ``--out``)
the closing keyframe pair, the ``match_for_sim3`` launches (Sim3
attempts), the loops closed and the ATE; compare two processes of one
mode.  Needs a CUDA card; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
import warnings


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["strict", "warn", "off",
                                       "index_add"],
                    required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke

    smi = chip_smoke.phase_device()
    chip_smoke.phase_build(smi)
    if args.mode in ("strict", "warn"):
        torch.use_deterministic_algorithms(True,
                                           warn_only=args.mode == "warn")
    if args.mode == "index_add":
        index_add_ = torch.Tensor.index_add_

        def sorted_index_add_(self, dim, index, source, alpha=1):
            if not self.is_cuda or dim != 0 or alpha != 1:
                return index_add_(self, dim, index, source, alpha=alpha)
            return self.index_put_((index,), source, accumulate=True)

        torch.Tensor.index_add_ = sorted_index_add_
    result = {"mode": args.mode, "device": smi,
              "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            eng, poses_gt, _, _, by_site = chip_smoke.phase_loop(smi)
        except RuntimeError as e:         # strict mode: the op that raised
            chain, err = [], e
            while err is not None:            # the GBA thread's error is
                chain.append(str(err).splitlines()[0])   # a cause
                err = err.__cause__
            result["raised"] = chain
            result["where"] = [ln for ln in traceback.format_exc(
                ).splitlines() if ln.lstrip().startswith("File ")][-8:]
            eng = None
    result["nondeterministic_ops"] = sorted({
        str(w.message).split(" does not have a deterministic")[0]
        for w in caught if "deterministic" in str(w.message)})
    if eng is not None:
        errs = []
        for Te, Tg in zip(eng.frame_poses(), poses_gt):
            if Te is not None:
                Te = Te @ poses_gt[0]
                errs.append(float(((-Te[:3, :3].T @ Te[:3, 3]
                                    + Tg[:3, :3].T @ Tg[:3, 3]) ** 2).sum()))
        result.update(
            closing_pair=list(eng.loop_closer.last_loop or ()),
            match_for_sim3_launches=by_site.get("match_for_sim3", 0),
            loops_closed=eng.stats["loops_closed"],
            kf_inserted=eng.stats["kf_inserted"],
            ate_m=(sum(errs) / len(errs)) ** 0.5)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
