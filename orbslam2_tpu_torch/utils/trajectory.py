# Copy of orbslam2_tpu/utils/trajectory.py (numpy only): the JAX package
# imports jax on import, which the GPU host does not have.
# tests/test_torch_copies.py holds it equal.
"""Trajectory export/import in TUM and KITTI formats + ATE/RPE metrics.

Mirrors ``System::SaveTrajectoryTUM`` (System.cc:448), ``SaveTrajectoryKITTI``
(System.cc:546), ``SaveKeyFrameTrajectoryTUM`` (System.cc:508) and the
offline evaluation role of matlab/harryPlotter.m (ATE with optional
similarity alignment).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _twc(Tcw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    R = Tcw[:3, :3].T
    t = -R @ Tcw[:3, 3]
    return R, t


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w) — TUM order."""
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # fallback via largest diagonal
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        x, y, z, w = q
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def save_tum(path: str, timestamps: Sequence[float],
             poses_cw: Sequence[Optional[np.ndarray]]) -> None:
    """One line per tracked frame: ``t tx ty tz qx qy qz qw`` of T_wc
    (System.cc:489-505 — lost frames are skipped)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_cw):
            if T is None:
                continue
            R, t = _twc(np.asarray(T, np.float64))
            q = _quat_from_R(R)
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_kitti(path: str, poses_cw: Sequence[Optional[np.ndarray]]) -> None:
    """12 numbers per line: rows of T_wc (System.cc:566-581; KITTI format
    has no timestamps and keeps lost frames as previous pose)."""
    last = np.eye(4)
    with open(path, "w") as f:
        for T in poses_cw:
            if T is not None:
                last = np.asarray(T, np.float64)
            R, t = _twc(last)
            M = np.concatenate([R, t[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """→ (timestamps [N], camera centers [N, 3])."""
    ts, pos = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            pos.append(v[1:4])
    return np.asarray(ts), np.asarray(pos)


# ----------------------------------------------------------------- metrics --

def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True
            ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Closed-form similarity alignment dst ≈ s·R·src + t (Umeyama 1991 —
    the standard ATE alignment, and the same machinery as Horn's method in
    Sim3Solver.cc:227)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             align: bool = False, with_scale: bool = False) -> float:
    if align:
        s, R, t = umeyama(est_centers, gt_centers, with_scale)
        est_centers = (s * (R @ est_centers.T)).T + t
    d = est_centers - gt_centers
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))


def centers_from_poses(poses_cw: Sequence[Optional[np.ndarray]]) -> np.ndarray:
    out = []
    for T in poses_cw:
        if T is None:
            continue
        out.append(-T[:3, :3].T @ T[:3, 3])
    return np.asarray(out)
