"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV, ISL, RealSense
IRD.

Port of ``orbslam2_tpu/utils/datasets.py``: the same loaders, names and
outputs (arrays and timestamps bit-equal to the JAX package's on the same
directory; ``tests/test_torch_datasets.py``).  They replay the role of the
reference's Test/Replay drivers (``mono_tum.cc``/``stereo_kitti.cc``/
``stereo_euroc.cc``/``rgbd_tum.cc``, SURVEY.md §2.3), including the TUM
RGB-D association logic of ``Config/RGB-D-associate.py``
(nearest-timestamp pairing).  All loaders yield (frame_arrays, timestamp)
on the host, as numpy.

PNG frames are read by ``utils/png.py`` (zlib and numpy; the GPU host has
neither PIL nor cv2), with PIL's conversion of RGB to gray.  A PNG in a
format that reader refuses (``png.UnsupportedPNG``: palette, gray+alpha,
16-bit RGB, gray under 8 bits, interlaced) and any other file (the ISL
layout's JPEG) go through PIL, imported when called, exactly as in the JAX
package.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from orbslam2_tpu_torch.utils import png


def _pil_image(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path} is not a PNG file the port reads itself: "
                          f"reading it needs PIL (the Pillow package)") from e
    return Image.open(path)


def _read_png(path: str):
    """The decoded array, or None where the port's reader refuses the
    format (the caller then reads the file through PIL)."""
    if not png.is_png(path):
        return None
    try:
        return png.read_png(path)
    except png.UnsupportedPNG:
        return None


def _imread_gray(path: str) -> np.ndarray:
    arr = _read_png(path)
    if arr is not None:
        if arr.ndim == 3:               # RGB / RGBA: PIL's convert("L")
            arr = png.rgb_to_l(arr)
        return arr.astype(np.float32)
    img = _pil_image(path)
    if img.mode not in ("L", "I", "I;16"):
        img = img.convert("L")
    arr = np.asarray(img)
    return arr.astype(np.float32)


def _imread_depth(path: str, factor: float) -> np.ndarray:
    arr = _read_png(path)
    if arr is None:
        arr = np.asarray(_pil_image(path))
    return arr.astype(np.float32) / factor


# --------------------------------------------------------------- TUM RGB-D --

def associate_tum(first: List[Tuple[float, str]],
                  second: List[Tuple[float, str]],
                  max_difference: float = 0.02
                  ) -> List[Tuple[float, str, str]]:
    """Nearest-timestamp association (Config/RGB-D-associate.py semantics)."""
    out = []
    j = 0
    used = set()
    for t1, p1 in first:
        best, bestd = None, max_difference
        for k in range(max(0, j - 3), len(second)):
            t2, p2 = second[k]
            d = abs(t1 - t2)
            if t2 > t1 + max_difference:
                break
            if d <= bestd and k not in used:
                best, bestd = k, d
        if best is not None:
            used.add(best)
            j = best
            out.append((t1, p1, second[best][1]))
    return out


def _read_tum_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def iter_tum_rgbd(root: str, depth_factor: float = 5000.0
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yields (gray, depth_m, timestamp) for a TUM RGB-D sequence dir."""
    rgb = _read_tum_list(os.path.join(root, "rgb.txt"))
    depth = _read_tum_list(os.path.join(root, "depth.txt"))
    for t, prgb, pdep in associate_tum(rgb, depth):
        yield (_imread_gray(os.path.join(root, prgb)),
               _imread_depth(os.path.join(root, pdep), depth_factor), t)


# ------------------------------------------------------------------- KITTI --

def iter_kitti_stereo(seq_dir: str
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yields (left, right, timestamp) for a KITTI odometry sequence dir
    (image_0/, image_1/, times.txt) — stereo_kitti.cc:LoadImages."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(x) for x in f if x.strip()]
    for i, t in enumerate(times):
        name = f"{i:06d}.png"
        yield (_imread_gray(os.path.join(seq_dir, "image_0", name)),
               _imread_gray(os.path.join(seq_dir, "image_1", name)), t)


# ------------------------------------------------------------------- EuRoC --

def iter_euroc_stereo(mav_dir: str, timestamp_file: Optional[str] = None
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yields (cam0, cam1, t) for an EuRoC MAV dir (stereo_euroc.cc).
    NOTE: images are yielded unrectified; callers rectify or use the
    distortion-aware camera model."""
    cam0 = os.path.join(mav_dir, "cam0", "data")
    cam1 = os.path.join(mav_dir, "cam1", "data")
    if timestamp_file:
        with open(timestamp_file) as f:
            stamps = [line.strip() for line in f
                      if line.strip() and not line.startswith("#")]
    else:
        stamps = sorted(os.path.splitext(n)[0] for n in os.listdir(cam0))
    for s in stamps:
        p0 = os.path.join(cam0, s + ".png")
        p1 = os.path.join(cam1, s + ".png")
        if os.path.exists(p0) and os.path.exists(p1):
            yield _imread_gray(p0), _imread_gray(p1), float(s) * 1e-9


def load_tum_groundtruth(root: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt → (timestamps, positions [N,3])."""
    ts, pos = [], []
    with open(os.path.join(root, "groundtruth.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            pos.append(v[1:4])
    return np.asarray(ts), np.asarray(pos)


# --------------------------------------------------------------------- ISL --

def iter_isl_stereo(left_dir: str, right_dir: str, times_file: str
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """ISL custom stereo layout (stereo_isl.cc:186-211): a timestamp file
    of nanosecond stamps, frames at <stamp>_left.jpg / <stamp>_right.jpg."""
    with open(times_file) as f:
        stamps = [line.strip() for line in f if line.strip()]
    for s in stamps:
        pl = os.path.join(left_dir, f"{s}_left.jpg")
        pr = os.path.join(right_dir, f"{s}_right.jpg")
        if os.path.exists(pl) and os.path.exists(pr):
            yield _imread_gray(pl), _imread_gray(pr), float(s) / 1e9


# ----------------------------------------------------------- IRD RealSense --

def iter_ird_realsense(sequence_dir: str, depth_extension: str = "png",
                       depth_factor: float = 1000.0
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Recorded RealSense IRD sequence (Test/Replay/IRD/realsense.cc:185):
    infrared/ and depth/ directories, the first two (warm-up) frames of
    each dropped, timestamps = depth filenames without extension.  The
    depth frame is resized to the IR frame's shape when they differ
    (realsense.cc:121-123 imDresized)."""
    ir_dir = os.path.join(sequence_dir, "infrared")
    d_dir = os.path.join(sequence_dir, "depth")
    irs = sorted(os.listdir(ir_dir))[2:]
    ds = sorted(os.listdir(d_dir))[2:]
    for ir_name, d_name in zip(irs, ds):
        t = float(os.path.splitext(d_name)[0].split("_")[-1])
        ir = _imread_gray(os.path.join(ir_dir, ir_name))
        depth = _imread_depth(os.path.join(d_dir, d_name), depth_factor)
        if depth.shape != ir.shape:
            ys = (np.arange(ir.shape[0]) * depth.shape[0]
                  // ir.shape[0]).clip(0, depth.shape[0] - 1)
            xs = (np.arange(ir.shape[1]) * depth.shape[1]
                  // ir.shape[1]).clip(0, depth.shape[1] - 1)
            depth = depth[np.ix_(ys, xs)]
        yield ir, depth, t
