# Copy of orbslam2_tpu/utils/markers.py (numpy, with cv2 where installed):
# the JAX package imports jax on import, which the GPU host does not have.
# tests/test_torch_copies.py holds it equal.
"""Marker tracking extras: QR-code and ArUco landmark adapters.

Host-side capabilities of the fork (QrCodeTracker.cc, QrCode.cc,
ArucoCodeScanner.cc, ArucoCode.cc — built out-of-lib in the reference,
CMakeLists.txt:95-98): detect/decode markers in the camera image, anchor
them at the current SLAM position, and persist the landmark list
(QRCodes.txt format, QrCodeTracker.cc:85-120).

OpenCV is an *optional* dependency here exactly as in the reference (these
are host utilities, not kernels); without cv2 the detectors report
unavailable instead of failing imports.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
        return cv2
    except Exception:
        return None


@dataclass
class Marker:
    """QrCode/ArucoCode analogue: payload + image box + SLAM position."""

    payload: str
    corners: np.ndarray                 # [4, 2] image corners
    position: Optional[np.ndarray] = None   # [3] world position when anchored

    @property
    def center(self) -> np.ndarray:
        return self.corners.mean(axis=0)


class QrCodeTracker:
    """QrCodeTracker equivalent: detect → decode → anchor → save/load."""

    def __init__(self):
        self.landmarks: List[Marker] = []
        cv2 = _cv2()
        self._det = cv2.QRCodeDetector() if cv2 is not None else None

    @property
    def available(self) -> bool:
        return self._det is not None

    def detect(self, image: np.ndarray) -> List[Marker]:
        if self._det is None:
            return []
        img8 = np.clip(image, 0, 255).astype(np.uint8)
        try:
            ok, infos, pts, _ = self._det.detectAndDecodeMulti(img8)
        except Exception:
            return []
        out = []
        if ok and pts is not None:
            for payload, quad in zip(infos, pts):
                if payload:
                    out.append(Marker(payload=payload,
                                      corners=np.asarray(quad, np.float32)))
        return out

    def track(self, image: np.ndarray, Tcw: Optional[np.ndarray]) -> List[Marker]:
        """Detect and anchor new landmarks at the camera position
        (QrCodeTracker's landmark list with SLAM position)."""
        found = self.detect(image)
        if Tcw is not None:
            cam_pos = -Tcw[:3, :3].T @ Tcw[:3, 3]
            known = {m.payload for m in self.landmarks}
            for m in found:
                if m.payload not in known:
                    m.position = cam_pos.copy()
                    self.landmarks.append(m)
        return found

    # QRCodes.txt persistence (QrCodeTracker.cc:85-120 format: payload + xyz)
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for m in self.landmarks:
                p = m.position if m.position is not None else np.zeros(3)
                f.write(f"{m.payload}\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\n")

    def load(self, path: str) -> None:
        self.landmarks = []
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 4:
                    self.landmarks.append(Marker(
                        payload=parts[0],
                        corners=np.zeros((4, 2), np.float32),
                        position=np.asarray([float(x) for x in parts[1:]])))


class ArucoCodeScanner:
    """ArucoCodeScanner equivalent with a valid-ID allowlist
    (ArucoCodeScanner.h:20-45)."""

    def __init__(self, valid_ids: Optional[Sequence[int]] = None,
                 dictionary: str = "DICT_4X4_50"):
        self.valid_ids = set(valid_ids) if valid_ids is not None else None
        cv2 = _cv2()
        self._det = None
        if cv2 is not None and hasattr(cv2, "aruco"):
            d = getattr(cv2.aruco, dictionary, None)
            if d is not None:
                adict = cv2.aruco.getPredefinedDictionary(d)
                self._det = cv2.aruco.ArucoDetector(adict)

    @property
    def available(self) -> bool:
        return self._det is not None

    def scan(self, image: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        if self._det is None:
            return []
        img8 = np.clip(image, 0, 255).astype(np.uint8)
        corners, ids, _ = self._det.detectMarkers(img8)
        out = []
        if ids is not None:
            for quad, mid in zip(corners, ids.reshape(-1)):
                if self.valid_ids is None or int(mid) in self.valid_ids:
                    out.append((int(mid), np.asarray(quad[0], np.float32)))
        return out
