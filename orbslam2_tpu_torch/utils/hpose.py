# Copy of orbslam2_tpu/utils/hpose.py (numpy only): the JAX package
# imports jax on import, which the GPU host does not have.
# tests/test_torch_copies.py holds it equal.
"""Human-readable pose — the HPose equivalent (include/HPose.h, HPose.cpp).

Position + quaternion with Euler access, plus the ORB→world axis remap the
fork applies in ``System::TrackIRD`` (System.cc:298-319): the SLAM frame
(z forward, x right, y down) is reported as a world frame with
x_w = z_slam, y_w = −x_slam, z_w = −y_slam.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass
class HPose:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    quaternion: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))  # x y z w

    def euler(self) -> np.ndarray:
        """roll, pitch, yaw (HPose.cpp Euler conversion)."""
        x, y, z, w = self.quaternion
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return np.array([roll, pitch, yaw])

    @staticmethod
    def from_Tcw(Tcw: np.ndarray) -> "HPose":
        """Camera pose (world→cam) → camera-in-world HPose."""
        R = Tcw[:3, :3].T
        t = -R @ Tcw[:3, 3]
        return HPose(position=t, quaternion=_quat_from_R(R))

    def to_world_frame(self) -> "HPose":
        """ORB camera axes → world axes (System.cc:298-319)."""
        px, py, pz = self.position
        pos_w = np.array([pz, -px, -py])
        # rotate the orientation by the same fixed axis permutation
        Rp = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
        R = Rp @ _R_from_quat(self.quaternion) @ Rp.T
        return HPose(position=pos_w, quaternion=_quat_from_R(R))


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
    if w > 1e-6:
        q = np.array([(R[2, 1] - R[1, 2]) / (4 * w),
                      (R[0, 2] - R[2, 0]) / (4 * w),
                      (R[1, 0] - R[0, 1]) / (4 * w), w])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
    return q / np.linalg.norm(q)


def _R_from_quat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
