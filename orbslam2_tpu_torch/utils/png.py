"""PNG read and write with zlib and numpy, for hosts without PIL or cv2.

The dataset layouts (KITTI, EuRoC, TUM RGB-D, RealSense IRD) store their
frames as non-interlaced PNG: 8-bit gray, 8-bit RGB or RGBA, and 16-bit
gray depth (big-endian in the file).  ``read_png`` decodes those, with all
five row filters; ``write_png`` writes them with filter 0 (None) on every
row.  RGB and RGBA convert to gray as PIL's ``convert("L")`` does, bit for
bit (``rgb_to_l``).  A well-formed PNG of any other format (palette,
gray+alpha, 16-bit colour, gray under 8 bits, interlaced) raises
``UnsupportedPNG``, a ``ValueError`` that callers catch to read the file
another way; a corrupt stream raises a plain ``ValueError``.

Average and Paeth rows depend on the pixel to their left, so a row cannot
be undone in one vector step.  Pixel (y, p) depends on (y, p-1), (y-1, p)
and (y-1, p-1) only, so every pixel of one anti-diagonal y + p = d can be
undone at once: ``_unfilter_wavefront`` walks the H + W - 1 diagonals of a
skewed copy of the image, each step a handful of numpy operations on
contiguous slices.  Images whose rows use only None, Sub and Up are undone
row by row (Sub is a running sum modulo 256).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


class UnsupportedPNG(ValueError):
    """A valid PNG in a format ``decode_png`` does not read."""


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def read_png(path: str) -> np.ndarray:
    """A PNG file → uint8 [H, W] / [H, W, 3] / [H, W, 4], or uint16 [H, W]
    for 16-bit gray."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def decode_png(data: bytes) -> np.ndarray:
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG stream")
    pos, hdr, idat = 8, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: bad CRC")
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None or not idat:
        raise ValueError("PNG stream without IHDR or IDAT")
    w, h, depth, color, comp, filt, interlace = hdr
    if comp or filt:
        raise ValueError(f"PNG compression method {comp}, filter method "
                         f"{filt} (only 0 exists)")
    if (color not in _CHANNELS or depth not in (8, 16)
            or (depth == 16 and color != 0) or interlace):
        raise UnsupportedPNG(
            f"unsupported PNG (colour type {color}, bit depth {depth}, "
            f"interlace {interlace}): read are non-interlaced 8-bit gray, "
            f"RGB and RGBA, and 16-bit gray")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    rows = _unfilter(raw[:, 1:], raw[:, 0], bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    return rows.reshape(h, w, ch)[..., 0] if ch == 1 else \
        rows.reshape(h, w, ch)


def _unfilter(f: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: f uint8 [H, stride] filtered bytes, types [H]
    → uint8 [H, stride]."""
    if np.any(types > 4):
        raise ValueError(f"PNG filter type {int(types.max())} (0-4 exist)")
    if np.any(types >= 3):
        return _unfilter_wavefront(f, types, bpp)
    out = np.empty_like(f)
    prev = np.zeros(f.shape[1], np.uint8)
    for y in range(f.shape[0]):
        row = f[y]
        if types[y] == 1:        # Sub: a running sum of each byte lane
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif types[y] == 2:      # Up
            row = row + prev
        out[y] = row
        prev = out[y]
    return out


def _unfilter_wavefront(f: np.ndarray, types: np.ndarray,
                        bpp: int) -> np.ndarray:
    h, stride = f.shape
    wp = stride // bpp
    n_diag = h + wp - 1
    ys = np.arange(h)[:, None]
    cols = ys + np.arange(wp)[None, :]              # skewed column y + p
    skew = np.zeros((h, n_diag, bpp), np.int16)
    skew[ys, cols] = f.reshape(h, wp, bpp)
    # recon in skewed columns, offset 2 (left and upper-left pads) and a
    # zero row above the image: pixel (y, p) at rec[y + 1, y + p + 2]
    rec = np.zeros((h + 1, n_diag + 2, bpp), np.int16)
    t = types.reshape(h, 1)
    sub, up, avg, paeth = (t == 1), (t == 2), (t == 3), (t == 4)
    for d in range(n_diag):
        y0, y1 = max(0, d - wp + 1), min(h, d + 1)
        a = rec[y0 + 1:y1 + 1, d + 1]               # left
        b = rec[y0:y1, d + 1]                       # above
        c = rec[y0:y1, d]                           # upper left
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        pred_paeth = np.where((pa <= pb) & (pa <= pc), a,
                              np.where(pb <= pc, b, c))
        pred = np.where(sub[y0:y1], a,
                        np.where(up[y0:y1], b,
                                 np.where(avg[y0:y1], (a + b) >> 1,
                                          np.where(paeth[y0:y1], pred_paeth,
                                                   0))))
        rec[y0 + 1:y1 + 1, d + 2] = (skew[y0:y1, d] + pred) & 255
    return rec[1:][ys, cols + 2].astype(np.uint8).reshape(h, stride)


def rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3 or 4] → uint8 [H, W], as PIL's ``convert("L")``
    (ITU-R 601-2 in 16-bit fixed point, rounded; alpha ignored)."""
    px = rgb[..., :3].astype(np.uint32)
    return ((px[..., 0] * 19595 + px[..., 1] * 38470 + px[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """uint8 [H, W] / [H, W, 3] / [H, W, 4] or uint16 [H, W] → a PNG file,
    filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        color, depth, rows = 0, 16, img.astype(">u2")
    elif img.dtype == np.uint8 and img.ndim == 2:
        color, depth, rows = 0, 8, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        color, depth, rows = (2 if img.shape[2] == 3 else 6), 8, img
    else:
        raise ValueError(f"write_png: {img.dtype} {img.shape} (uint8 gray, "
                         f"RGB or RGBA, or uint16 gray)")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1).view(np.uint8)
    scan = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(scan.tobytes(), level))
                + chunk(b"IEND", b""))
