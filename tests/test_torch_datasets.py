"""The port's PNG codec (``utils/png.py``) and dataset loaders
(``utils/datasets.py``).

  * the reader against PIL, bit for bit: 8-bit gray, RGB, RGBA and 16-bit
    gray, in files written by PIL and by cv2 with their default adaptive
    filters, and rows encoded here under each of the five filter types
    (and a mix of them); RGB to gray as PIL's ``convert("L")``;
  * the writer, read back by PIL;
  * every loader held bit-equal (arrays and timestamps) to the JAX
    package's on the same written directory: ``associate_tum``,
    ``iter_tum_rgbd``, ``iter_kitti_stereo``, ``iter_euroc_stereo`` with
    and without a timestamp file, ``iter_isl_stereo`` on JPEG,
    ``iter_ird_realsense`` with a resized depth, ``load_tum_groundtruth``.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from orbslam2_tpu.utils import datasets as jds  # noqa: E402
from orbslam2_tpu_torch.utils import datasets as tds  # noqa: E402
from orbslam2_tpu_torch.utils import png  # noqa: E402

FORMATS = ["gray8", "rgb8", "rgba8", "gray16"]


def _image(fmt, h=48, w=61, seed=0):
    """A smooth image with noise, so that the encoders' adaptive filters
    pick several filter types."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 7.0) * np.cos(y / 5.0) \
        + rng.normal(0, 6, (h, w))
    if fmt == "gray16":
        return np.clip(base * 200 + rng.integers(0, 200, (h, w)), 0,
                       65535).astype(np.uint16)
    ch = {"gray8": 0, "rgb8": 3, "rgba8": 4}[fmt]
    if ch:
        base = np.stack([base + 17 * k for k in range(ch)], -1)
    return np.clip(base, 0, 255).astype(np.uint8)


def _filters_used(path):
    data = open(path, "rb").read()
    pos, hdr, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    w, h, depth, color = hdr[:4]
    stride = w * {0: 1, 2: 3, 6: 4}[color] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


@pytest.mark.parametrize("writer", ["pil", "cv2"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_reader_equals_pil_on_encoder_files(fmt, writer, tmp_path):
    img = _image(fmt)
    path = str(tmp_path / f"{fmt}.png")
    if writer == "pil":
        Image.fromarray(img).save(path)
    else:
        cv2.imwrite(path, img[..., [2, 1, 0, 3][:img.shape[2]]]
                    if img.ndim == 3 else img)
    got = png.read_png(path)
    want = np.asarray(Image.open(path))
    assert got.dtype == (np.uint16 if fmt == "gray16" else np.uint8)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))
    np.testing.assert_array_equal(got, img)
    if writer == "pil" and fmt in ("gray8", "gray16"):
        assert len(_filters_used(path)) >= 2     # an adaptive mix


def _filter_rows(rows, types, bpp):
    """The PNG row filters, by the spec's definitions: uint8 [H, stride]
    image bytes and a filter type per row → the filtered scanlines."""
    h, stride = rows.shape
    x = rows.astype(np.int32)
    prior = np.vstack([np.zeros((1, stride), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), x[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), prior[:, :-bpp]])
    p = left + prior - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, prior, upleft))
    preds = [np.zeros_like(x), left, prior, (left + prior) // 2, paeth]
    out = np.empty((h, stride + 1), np.uint8)
    for y in range(h):
        out[y, 0] = types[y]
        out[y, 1:] = (x[y] - preds[types[y]][y]) % 256
    return out


def _png_bytes(img, types):
    h, w = img.shape[:2]
    if img.dtype == np.uint16:
        color, depth, rows, bpp = 0, 16, img.astype(">u2"), 2
    else:
        ch = 1 if img.ndim == 2 else img.shape[2]
        color, depth, rows, bpp = {1: 0, 3: 2, 4: 6}[ch], 8, img, ch
    rows = np.ascontiguousarray(rows).reshape(h, -1).view(np.uint8)
    scan = _filter_rows(rows, types, bpp)

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(
            ">I", zlib.crc32(t + b))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(scan.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("fmt", ["gray8", "rgb8", "gray16"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_reader_undoes_each_filter_type(fmt, ftype, tmp_path):
    img = _image(fmt, h=23, w=37, seed=3)
    h = img.shape[0]
    types = (np.random.default_rng(1).integers(0, 5, h) if ftype == "mixed"
             else np.full(h, ftype))
    data = _png_bytes(img, types)
    np.testing.assert_array_equal(png.decode_png(data), img)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(
        np.asarray(Image.open(path)).astype(np.int64), img.astype(np.int64))


@pytest.mark.parametrize("fmt", FORMATS)
def test_writer_is_read_back_by_pil(fmt, tmp_path):
    img = _image(fmt, seed=5)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(path)).astype(np.int64), img.astype(np.int64))
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("ch", [3, 4])
def test_rgb_to_l_is_pils_convert(ch):
    rng = np.random.default_rng(ch)
    rgb = rng.integers(0, 256, (64, 64, ch), dtype=np.uint8)
    rgb[0, :8, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                      [0, 0, 255], [1, 2, 3], [128, 128, 128],
                      [254, 1, 127]]
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(png.rgb_to_l(rgb), want)


@pytest.mark.parametrize("case", ["palette", "rgb16", "bad_crc", "not_png"])
def test_reader_refuses_what_it_does_not_read(case, tmp_path):
    path = tmp_path / "x.png"
    if case == "palette":
        Image.fromarray(_image("gray8")).convert("P").save(path)
    elif case == "rgb16":
        cv2.imwrite(str(path), np.zeros((4, 5, 3), np.uint16))
    elif case == "not_png":
        path.write_bytes(b"GIF89a" + bytes(32))
    else:
        data = bytearray(_png_bytes(_image("gray8"), np.zeros(48, int)))
        data[40] ^= 1                                 # inside IDAT
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(str(path))


def test_jpeg_without_pil_names_the_package(tmp_path, monkeypatch):
    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, _image("gray8"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tds._imread_gray(path)


# ------------------------------------------------------------- the loaders
def _assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert type(a) is type(b) and a == b


def test_associate_tum_equals_jax():
    rng = np.random.default_rng(2)
    t1 = np.cumsum(rng.uniform(0.02, 0.05, 40))
    t2 = np.sort(t1 + rng.normal(0, 0.012, 40))
    first = [(float(t), f"rgb/{i}.png") for i, t in enumerate(t1)]
    second = [(float(t), f"depth/{i}.png") for i, t in enumerate(t2)]
    for maxd in (0.02, 0.005):
        assert (tds.associate_tum(first, second, maxd)
                == jds.associate_tum(first, second, maxd))


def _write_tum(root, n=5):
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(n):
        t = 1305031102.175304 + 0.0333 * i
        td = t + 0.004 * (-1) ** i
        Image.fromarray(_image("rgb8", seed=i)).save(root / f"rgb/{i}.png")
        cv2.imwrite(str(root / f"depth/{i}.png"), _image("gray16", seed=i))
        rgb_lines.append(f"{t:.6f} rgb/{i}.png")
        depth_lines.append(f"{td:.6f} depth/{i}.png")
        gt_lines.append(f"{t:.4f} {0.1 * i} {0.2 * i} -{0.01 * i} 0 0 0 1")
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")


def test_tum_rgbd_and_groundtruth_equal_jax(tmp_path):
    _write_tum(tmp_path)
    for factor in (5000.0, 1000.0):
        _assert_frames_equal(list(tds.iter_tum_rgbd(str(tmp_path), factor)),
                             list(jds.iter_tum_rgbd(str(tmp_path), factor)))
    for a, b in zip(tds.load_tum_groundtruth(str(tmp_path)),
                    jds.load_tum_groundtruth(str(tmp_path))):
        np.testing.assert_array_equal(a, b)


def test_kitti_stereo_equals_jax(tmp_path):
    for cam in ("image_0", "image_1"):
        (tmp_path / cam).mkdir()
        for i in range(4):
            cv2.imwrite(str(tmp_path / cam / f"{i:06d}.png"),
                        _image("gray8", seed=10 * i + len(cam)))
    (tmp_path / "times.txt").write_text(
        "".join(f"{0.103 * i:e}\n" for i in range(4)))
    _assert_frames_equal(list(tds.iter_kitti_stereo(str(tmp_path))),
                         list(jds.iter_kitti_stereo(str(tmp_path))))


@pytest.mark.parametrize("with_file", [False, True])
def test_euroc_stereo_equals_jax(with_file, tmp_path):
    stamps = [str(1403636579763555584 + 50_000_000 * i) for i in range(5)]
    for cam in ("cam0", "cam1"):
        (tmp_path / cam / "data").mkdir(parents=True)
        for k, s in enumerate(stamps):
            if cam == "cam1" and k == 2:
                continue                  # an unpaired frame is skipped
            Image.fromarray(_image("gray8", seed=k)).save(
                tmp_path / cam / "data" / f"{s}.png")
    tfile = None
    if with_file:
        tfile = str(tmp_path / "times.txt")
        (tmp_path / "times.txt").write_text(
            "#stamps\n" + "\n".join(stamps[::-1][1:]) + "\n")
    got = list(tds.iter_euroc_stereo(str(tmp_path), tfile))
    _assert_frames_equal(got, list(jds.iter_euroc_stereo(str(tmp_path),
                                                         tfile)))
    assert len(got) == (3 if with_file else 4)


def test_isl_stereo_jpeg_equals_jax(tmp_path):
    (tmp_path / "l").mkdir()
    (tmp_path / "r").mkdir()
    stamps = [str(1400000000000000000 + i * 100_000_000) for i in range(3)]
    for i, s in enumerate(stamps):
        cv2.imwrite(str(tmp_path / "l" / f"{s}_left.jpg"),
                    _image("rgb8", seed=i))
        cv2.imwrite(str(tmp_path / "r" / f"{s}_right.jpg"),
                    _image("gray8", seed=i))
    (tmp_path / "t.txt").write_text("\n".join(stamps) + "\n")
    args = (str(tmp_path / "l"), str(tmp_path / "r"), str(tmp_path / "t.txt"))
    _assert_frames_equal(list(tds.iter_isl_stereo(*args)),
                         list(jds.iter_isl_stereo(*args)))


def test_ird_realsense_resized_depth_equals_jax(tmp_path):
    (tmp_path / "infrared").mkdir()
    (tmp_path / "depth").mkdir()
    for i in range(5):
        t = 1000.0 + 0.1 * i
        cv2.imwrite(str(tmp_path / "infrared" / f"{t:.6f}.png"),
                    _image("gray8", seed=i))
        png.write_png(str(tmp_path / "depth" / f"{t:.6f}.png"),
                      _image("gray16", seed=i)[::2, ::2])
    got = list(tds.iter_ird_realsense(str(tmp_path)))
    _assert_frames_equal(got, list(jds.iter_ird_realsense(str(tmp_path))))
    assert len(got) == 3 and got[0][1].shape == got[0][0].shape
