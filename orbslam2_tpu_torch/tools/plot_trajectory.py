"""Trajectory plotting and ATE evaluation (the reference's
matlab/harryPlotter.m), for the trajectory files that the port writes.

Port of ``tools/analysis/plot_trajectory.py``: the same command line,
the same printed ATE line and the same matplotlib-or-PLY output, over the
port's ``utils/trajectory`` and ``utils/viewer``.

    python -m orbslam2_tpu_torch.tools.plot_trajectory est.txt [gt.txt]
        [--align] [--scale] [--out plot.png]

TUM-format inputs.  With matplotlib absent it prints the metrics and
writes a PLY of both trajectories instead.  Runs on the host only: it
reads text files and touches no device.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from orbslam2_tpu_torch.utils import trajectory as T
from orbslam2_tpu_torch.utils import viewer


def associate(ts_a, ts_b, max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """(i, j) pairs of each ``ts_a[i]`` with its nearest ``ts_b[j]``
    within ``max_dt`` s; both sorted."""
    j = 0
    pairs = []
    for i, t in enumerate(ts_a):
        while j + 1 < len(ts_b) and abs(ts_b[j + 1] - t) <= abs(ts_b[j] - t):
            j += 1
        if abs(ts_b[j] - t) <= max_dt:
            pairs.append((i, j))
    return pairs


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt", nargs="?", default=None)
    ap.add_argument("--align", action="store_true")
    ap.add_argument("--scale", action="store_true")
    ap.add_argument("--out", default="trajectory.png")
    a = ap.parse_args(argv)

    ts_e, pos_e = T.load_tum(a.est)
    pos_g = None
    if a.gt:
        ts_g, pos_g = T.load_tum(a.gt)
        pairs = associate(ts_e, ts_g)
        pos_e = pos_e[[i for i, _ in pairs]]
        pos_g = pos_g[[j for _, j in pairs]]
        rmse = T.ate_rmse(pos_e, pos_g, align=a.align, with_scale=a.scale)
        print(f"ATE RMSE: {rmse:.4f} m over {len(pairs)} matched poses")
        if a.align:
            s, R, t = T.umeyama(pos_e, pos_g, a.scale)
            pos_e = (s * (R @ pos_e.T)).T + t

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.plot(pos_e[:, 0], pos_e[:, 2], label="estimate")
        if pos_g is not None:
            ax.plot(pos_g[:, 0], pos_g[:, 2], "--", label="ground truth")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.axis("equal")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.savefig(a.out, dpi=120)
        print(f"wrote {a.out}")
    except Exception:
        out = a.out.rsplit(".", 1)[0] + ".ply"
        pts = pos_e if pos_g is None else np.concatenate([pos_e, pos_g])
        viewer.save_ply(out, pts)
        print(f"matplotlib unavailable; wrote {out}")


if __name__ == "__main__":
    main()
