"""The port's stereo rectification (``orbslam2_tpu_torch/ops/rectify.py``)
against the JAX package's, on the CPU.

The reference's Stereo-EuRoC.yaml is not in the repository, so the
calibration is a synthetic EuRoC-like one written here: 752×480, the
EuRoC cameras' intrinsics and rad-tan distortion, small rectifying
rotations, a rectified pair of projections 0.11 m apart whose focal
length (380 px) is short enough that the image corners sample outside
the source images (3.7% of the left map).

Tolerances: the map build is the same float64 numpy in both packages,
compared equal; ``remap_bilinear`` within 1e-4 of JAX's on 0-255 images
(float32 lerps, the same formula); the host path equal to JAX's (the same
numpy); the device path (``remap_pair``) within 1e-3 of the host path, as
tests/test_rectify.py holds JAX's jitted path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.config import _parse_opencv_yaml as j_parse
from orbslam2_tpu.ops import rectify as jrect
from orbslam2_tpu_torch.config import _parse_opencv_yaml as t_parse
from orbslam2_tpu_torch.ops import rectify as trect

torch.set_num_threads(2)

W, H = 752, 480


def _rot(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _flat():
    """LEFT./RIGHT. blocks as config._parse_opencv_yaml gives them."""
    P = np.array([[380.0, 0.0, 367.45, 0.0], [0.0, 380.0, 252.2, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    Pr = P.copy()
    Pr[0, 3] = -0.11 * 380.0
    return {
        "LEFT.height": H, "LEFT.width": W,
        "LEFT.D": np.array([[-0.2834, 0.0740, 1.94e-4, 1.76e-5, 0.0]]),
        "LEFT.K": np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                            [0.0, 0.0, 1.0]]),
        "LEFT.R": _rot(0.0035, -0.0040, 0.0015),
        "LEFT.P": P,
        "RIGHT.height": H, "RIGHT.width": W,
        "RIGHT.D": np.array([[-0.2837, 0.0746, -1.04e-4, -3.56e-5, 0.0]]),
        "RIGHT.K": np.array([[457.587, 0.0, 379.999],
                             [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]]),
        "RIGHT.R": _rot(0.0030, 0.0021, -0.0012),
        "RIGHT.P": Pr,
    }


def _yaml(flat):
    lines = ["%YAML:1.0", "Camera.fx: 380.0"]
    for k, v in flat.items():
        if isinstance(v, np.ndarray):
            lines += [f"{k}: !!opencv-matrix", f"   rows: {v.shape[0]}",
                      f"   cols: {v.shape[1]}", "   dt: d",
                      "   data:[" + ", ".join(repr(float(x))
                                              for x in v.ravel()) + "]"]
        else:
            lines.append(f"{k}: {v}")
    return "\n".join(lines) + "\n"


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (H, W)).astype(np.float32),
            rng.uniform(0, 255, (H, W)).astype(np.float32))


@pytest.fixture(scope="module")
def rects():
    flat = _flat()
    return jrect.load_rectification(flat), trect.load_rectification(
        flat, device="cpu")


@pytest.mark.parametrize("side", ["LEFT", "RIGHT"])
def test_map_build_equals_jax(side):
    f = _flat()
    args = (f[f"{side}.K"], f[f"{side}.D"], f[f"{side}.R"],
            f[f"{side}.P"][:3, :3], W, H)
    jx, jy = jrect.init_undistort_rectify_map(*args)
    tx, ty = trect.init_undistort_rectify_map(*args)
    assert tx.dtype == np.float32 and tx.shape == (H, W)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    # the short rectified focal length samples the corners outside
    outside = (jx < 0) | (jx > W - 1) | (jy < 0) | (jy > H - 1)
    assert 0 < outside.mean() < 0.2


def test_remap_bilinear_matches_jax(rects):
    """Random 0-255 images through both remaps on the left maps and on
    maps pushed partly out of bounds (those pixels must be 0)."""
    jr, _ = rects
    img, _ = _images()
    mx, my = jr.maps.lx, jr.maps.ly
    rng = np.random.default_rng(1)
    shifted = (mx + rng.uniform(-40, 40, mx.shape).astype(np.float32),
               my + rng.uniform(-40, 40, my.shape).astype(np.float32))
    for x, y in ((mx, my), shifted):
        want = np.asarray(jrect.remap_bilinear(jnp.asarray(img),
                                               jnp.asarray(x),
                                               jnp.asarray(y)))
        got = trect.remap_bilinear(torch.from_numpy(img),
                                   torch.from_numpy(x),
                                   torch.from_numpy(y)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        oob = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
        assert oob.any() and (got[oob] == 0).all()


def test_host_path_equals_jax(rects):
    jr, tr = rects
    left, right = _images(2)
    for g, w in zip(tr(left, right), jr(left, right)):
        np.testing.assert_array_equal(g, w)


def test_remap_pair_matches_host_path(rects):
    """The device path (here on the CPU) against the host path, on uint8
    images as a driver hands them over."""
    _, tr = rects
    left, right = (np.clip(x, 0, 255).astype(np.uint8) for x in _images(3))
    dl, dr = tr.remap_pair(left, right)
    assert dl.device == tr.device and dl.dtype == torch.float32
    hl, hr = tr(left, right)
    np.testing.assert_allclose(dl.numpy(), hl, atol=1e-3, rtol=0)
    np.testing.assert_allclose(dr.numpy(), hr, atol=1e-3, rtol=0)


def test_load_rectification_from_yaml_equals_jax(tmp_path):
    """A YAML written to disk, through both packages' parsers and loaders,
    and the flat dict: the same maps."""
    path = tmp_path / "euroc_like.yaml"
    path.write_text(_yaml(_flat()))
    text = path.read_text()
    tflat, jflat = t_parse(text), j_parse(text)
    assert tflat.keys() == jflat.keys()
    for k in tflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    t_yaml = trect.load_rectification(str(path), device="cpu")
    j_yaml = jrect.load_rectification(str(path))
    t_dict = trect.load_rectification(_flat(), device="cpu")
    for a, b, c in zip(t_yaml.maps, j_yaml.maps, t_dict.maps):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, atol=1e-3, rtol=0)


@pytest.mark.parametrize("missing", ["LEFT.K", "RIGHT.P", "LEFT.width"])
def test_no_rectification_blocks_gives_none(missing):
    flat = _flat()
    del flat[missing]
    assert trect.load_rectification(flat, device="cpu") is None
    assert jrect.load_rectification(flat) is None


def test_identity_calibration_returns_the_image():
    K = np.array([[450.0, 0.0, 320.0], [0.0, 450.0, 240.0], [0.0, 0.0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    flat = {}
    for side in ("LEFT", "RIGHT"):
        flat.update({f"{side}.K": K, f"{side}.D": np.zeros((1, 5)),
                     f"{side}.R": np.eye(3), f"{side}.P": P,
                     f"{side}.width": 640, f"{side}.height": 480})
    rect = trect.load_rectification(flat, device="cpu")
    img = np.random.default_rng(4).integers(0, 256, (480, 640)
                                            ).astype(np.uint8)
    for out in (*rect(img, img), *(t.numpy() for t in rect.remap_pair(img,
                                                                      img))):
        np.testing.assert_allclose(out, img, atol=1e-3, rtol=0)
