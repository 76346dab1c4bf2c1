"""Hierarchical binary-descriptor vocabulary: loading and building.

Port of ``orbslam2_tpu/models/vocabulary.py``.  Level d holds k^(d+1)
centroids; the children of node n are rows n·k … n·k+k−1 of level d+1's
table, and leaf ids at level L are word ids in [0, k^L).  The centroids
are the JAX package's uint32 words as int32 (same bits, the port's
descriptor layout).

``default_vocabulary`` loads ``data/vocab_k{k}_l{levels}.npz`` and, where
it is missing, builds the tree as the JAX package does: descriptors
harvested from synthetic worlds textured by real rasters and procedural
families (``harvest_training_descriptors``), clustered by hierarchical
k-majority (``build_vocabulary``), and written in the JAX package's npz
layout, which either package reads back.

Every k-majority assignment (a first-index argmin of the Hamming distance
to k centroids) goes through ``ops/hamming_top2.hamming_top2``: on the
card the hand-written kernel, counted under the launch site
``vocab_build``; on CPU tensors its plain version.  The random draws stay
a numpy ``Generator`` on the host, made in the JAX package's order, so the
tree is the JAX package's on the same descriptors and seed, bit for bit.
"""

from __future__ import annotations

import os
from typing import Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import CameraConfig, OrbConfig
from orbslam2_tpu_torch.ops import extractor
from orbslam2_tpu_torch.ops import image as image_ops
from orbslam2_tpu_torch.ops.hamming_top2 import hamming_top2, launch_site
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.utils import synthetic

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "data")
DEFAULT_K = 10
DEFAULT_LEVELS = 4


class Vocabulary(NamedTuple):
    centroids: Tuple[torch.Tensor, ...]  # per level: [k^(d+1), 8] int32
    idf: torch.Tensor                    # [k^L] float32
    k: int
    levels: int

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    def to(self, device) -> "Vocabulary":
        return self._replace(
            centroids=tuple(c.to(device) for c in self.centroids),
            idf=self.idf.to(device))


def from_numpy(centroids, idf, k: int, levels: int, device=None
               ) -> Vocabulary:
    """uint32 centroid tables + idf (the JAX layout) → a Vocabulary."""
    cents = tuple(torch.from_numpy(np.ascontiguousarray(
        np.asarray(c, np.uint32)).view(np.int32).copy()).to(device)
        for c in centroids)
    return Vocabulary(centroids=cents,
                      idf=torch.as_tensor(np.asarray(idf, np.float32),
                                          device=device),
                      k=int(k), levels=int(levels))


# ------------------------------------------------------------ building -----

def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[M, 8] int32 words → [M, 256] uint8 bits; bit j of word w is bit
    32·w + j (numpy's little-endian ``unpackbits`` of the uint32 words).
    The shift is arithmetic on int32 (torch has no uint32 ``>>`` on the
    CPU); ``& 1`` makes it exact for negative words too."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.to(torch.uint8).reshape(words.shape[0], 256)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[M, 256] bits → [M, 8] int32 words (the uint32 words' bits)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _nearest(words: torch.Tensor, cent_words: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Hamming distance to the nearest centroid, its first index) of each
    row: hamming_top2's best and best_idx, every row and column valid."""
    with launch_site("vocab_build"):
        best, idx, _ = hamming_top2(
            words, torch.ones(words.shape[0], dtype=torch.bool,
                              device=words.device),
            cent_words, torch.ones(cent_words.shape[0], dtype=torch.bool,
                                   device=words.device))
    return best, idx.to(torch.int64)


def _majority_step(bits: torch.Tensor, words: torch.Tensor,
                   assign: torch.Tensor, cent: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """One update of the reference's ``for j in range(k)`` loop.  A
    non-empty cluster takes the bitwise majority of its members (``mean >
    0.5`` is ``2·count > n`` in integers).  An empty cluster j is re-seeded
    at the point farthest from the table as the loop sees it then: rows
    < j already updated, rows ≥ j still old; first index on ties."""
    counts = torch.zeros(k, bits.shape[1], dtype=torch.int32,
                         device=bits.device)
    counts.index_add_(0, assign, bits.to(torch.int32))   # integer: exact
    n = torch.bincount(assign, minlength=k)
    new = torch.where((n > 0)[:, None],
                      (2 * counts > n[:, None]).to(torch.uint8), cent)
    for j in torch.nonzero(n == 0).flatten().tolist():
        d, _ = _nearest(words, _pack_bits(torch.cat([new[:j], cent[j:]])))
        new[j] = bits[torch.argmax(d)]
    return new


def _kmajority(bits: torch.Tensor, k: int, rng: np.random.Generator,
               iters: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-majority clustering of binary vectors [M, 256] uint8 → (centroid
    bits [k, 256] uint8, assignment [M] int64), on ``bits``'s device.  The
    draws come from ``rng`` on the host, in the reference's order."""
    m = bits.shape[0]
    dev = bits.device
    if m == 0:
        c = rng.integers(0, 2, size=(k, bits.shape[1])).astype(np.uint8)
        return (torch.from_numpy(c).to(dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    init = rng.choice(m, size=min(k, m), replace=False)
    cent = bits[torch.from_numpy(init).to(dev)]          # a copy
    if cent.shape[0] < k:  # degenerate: duplicate + perturb
        extra = rng.integers(0, 2, size=(k - cent.shape[0], bits.shape[1]))
        cent = torch.cat([cent, torch.from_numpy(
            extra.astype(np.uint8)).to(dev)])
    words = _pack_bits(bits)
    for _ in range(iters):
        _, assign = _nearest(words, _pack_bits(cent))
        cent = _majority_step(bits, words, assign, cent, k)
    _, assign = _nearest(words, _pack_bits(cent))
    return cent, assign


def _as_words(descriptors, device: torch.device) -> torch.Tensor:
    """[M, 8] descriptors, the port's int32 tensor or the JAX layout's
    uint32 array → an int32 tensor on ``device``."""
    if isinstance(descriptors, torch.Tensor):
        return descriptors.to(device=device, dtype=torch.int32)
    arr = np.ascontiguousarray(np.asarray(descriptors).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def build_vocabulary(descriptors, k: int = 10, levels: int = 3,
                     seed: int = 0, device=None) -> Vocabulary:
    """descriptors: [M, 8] (int32 tensor, or uint32 numpy as in the JAX
    package).  Builds the full k^levels tree on ``device`` (by default the
    card), group by group in the reference's order: one k-majority per
    node, 7 hamming_top2 launches each on the card (and one more for each
    empty cluster met)."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    bits = _unpack_bits(_as_words(descriptors, dev))
    groups = [torch.arange(bits.shape[0], device=dev)]
    level_cents: List[torch.Tensor] = []
    for d in range(levels):
        cents = torch.zeros(k ** (d + 1), 256, dtype=torch.uint8, device=dev)
        new_groups: List[torch.Tensor] = []
        for n, idx in enumerate(groups):
            c, a = _kmajority(bits[idx], k, rng)
            cents[n * k:(n + 1) * k] = c
            # members of each child in their order in idx: a stable sort
            order = torch.sort(a, stable=True).indices
            sizes = torch.bincount(a, minlength=k).tolist()
            new_groups.extend(torch.split(idx[order], sizes))
        level_cents.append(_pack_bits(cents))
        groups = new_groups
    # idf from leaf occupancy (empty words get max idf), in float64 on the
    # host as the reference computes it
    counts = np.array([len(g) for g in groups], np.float64)
    total = max(counts.sum(), 1.0)
    idf = np.log(total / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(centroids=tuple(level_cents),
                      idf=torch.from_numpy(idf).to(dev), k=k, levels=levels)


# -------------------------------------------------- harvesting corpus -----
# Copies of the JAX package's numpy texture and augmentation functions:
# importing them from there would import jax, which the GPU host does not
# have.  tests/test_torch_copies.py holds them equal.
#
# The reference's orb_mur vocabulary is trained on varied REAL imagery.
# No photo dataset ships with the repository, so the corpus breaks the
# train-on-the-test-renderer circularity three ways: (a) real raster data shipped with matplotlib (two raster
# images + hill-shaded topo-bathymetry) used both directly and as world
# textures, (b) procedural texture FAMILIES disjoint from the test
# renderer's multi-octave value noise (stripes, Voronoi cells, warped
# checkerboards), (c) photometric augmentation — exposure/gamma drift,
# vignetting, motion/defocus blur, sensor noise — applied per view.
# Where matplotlib is missing the real-raster bank is empty, and the tree
# differs from one built with it.


def _real_textures() -> List[np.ndarray]:
    """Real raster data available offline (matplotlib sample_data)."""
    out: List[np.ndarray] = []
    try:
        import matplotlib
        import matplotlib.image as mpimg
        base = os.path.join(os.path.dirname(matplotlib.__file__),
                            "mpl-data", "sample_data")
        for name in ("logo2.png", "Minduka_Present_Blue_Pack.png"):
            img = mpimg.imread(os.path.join(base, name))
            g = img[..., :3].mean(-1) if img.ndim == 3 else img
            if g.max() <= 1.0:
                g = g * 255.0
            out.append(g.astype(np.float32))
        topo = np.load(os.path.join(base, "topobathy.npz"))["topo"]
        topo = topo.astype(np.float32)
        up = np.kron(topo, np.ones((4, 4), np.float32))      # 364×480
        for _ in range(2):                                   # cheap smooth
            up = 0.25 * (up + np.roll(up, 1, 0) + np.roll(up, 1, 1)
                         + np.roll(np.roll(up, 1, 0), 1, 1))
        gy, gx = np.gradient(up)
        shade = 128.0 + 90.0 * (gx - gy) / (
            np.abs(gx) + np.abs(gy) + 1e-6)
        out.append(np.clip(shade, 0, 255).astype(np.float32))
    except Exception:                           # matplotlib data absent
        pass
    return out


def _alt_texture(rng: np.random.Generator, real_bank: List[np.ndarray],
                 size: int = 512) -> np.ndarray:
    """A texture from a family DISJOINT from the test renderer's value
    noise: real raster crop, stripes, Voronoi cells, or warped checker."""
    kind = rng.integers(0, 4)
    if kind == 0 and real_bank:
        src = real_bank[rng.integers(len(real_bank))]
        h, w = src.shape
        # random crop, tiled out to `size`
        ch = rng.integers(h // 3, h + 1)
        cw = rng.integers(w // 3, w + 1)
        y0 = rng.integers(0, h - ch + 1)
        x0 = rng.integers(0, w - cw + 1)
        crop = src[y0:y0 + ch, x0:x0 + cw]
        if rng.random() < 0.5:
            crop = crop[::-1]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        reps = (size // ch + 1, size // cw + 1)
        return np.tile(crop, reps)[:size, :size].copy()
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    if kind == 1:                                # anisotropic stripes
        th = rng.uniform(0, np.pi)
        freq = rng.uniform(0.02, 0.3)
        phase = (xx * np.cos(th) + yy * np.sin(th)) * freq
        wob = rng.uniform(0, 6) * np.sin(yy * rng.uniform(0.01, 0.05))
        v = np.sign(np.sin(phase + wob))
        return (128 + rng.uniform(40, 90) * v).astype(np.float32)
    if kind == 2:                                # Voronoi cells
        n = int(rng.integers(30, 120))
        cxs = rng.uniform(0, size, n)
        cys = rng.uniform(0, size, n)
        vals = rng.uniform(30, 225, n).astype(np.float32)
        d = ((xx[..., None] - cxs) ** 2 + (yy[..., None] - cys) ** 2)
        return vals[np.argmin(d, axis=-1)]
    # warped checkerboard
    cell = rng.uniform(12, 60)
    warp = rng.uniform(0, 10)
    xw = xx + warp * np.sin(yy * rng.uniform(0.01, 0.06))
    yw = yy + warp * np.cos(xx * rng.uniform(0.01, 0.06))
    v = ((xw // cell + yw // cell) % 2).astype(np.float32)
    return 70.0 + 120.0 * v


def photometric_augment(img: np.ndarray, rng: np.random.Generator
                        ) -> np.ndarray:
    """Exposure/gamma drift + vignette + motion/defocus blur + noise —
    the photometric stress the test renderer never applies."""
    img = np.clip(img, 0.0, 255.0) / 255.0
    img = img ** rng.uniform(0.6, 1.6)                        # gamma
    img = img * rng.uniform(0.6, 1.25) + rng.uniform(-0.08, 0.08)
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
    img = img * (1.0 - rng.uniform(0.0, 0.45) * r2)           # vignette
    n = int(rng.integers(0, 4))
    if n:                                                     # motion blur
        dx, dy = rng.integers(-1, 2), rng.integers(-1, 2)
        if dx or dy:
            acc = img.copy()
            for s in range(1, n + 1):
                acc += np.roll(np.roll(img, s * dy, 0), s * dx, 1)
            img = acc / (n + 1)
    for _ in range(int(rng.integers(0, 3))):                  # defocus
        img = 0.25 * (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
                      + np.roll(np.roll(img, 1, 0), 1, 1))
    img = img * 255.0
    img = img + rng.normal(0, rng.uniform(1.0, 6.0), img.shape)
    return np.clip(img, 0.0, 255.0).astype(np.float32)


# the harvest's camera and extractor settings (the reference's)
HARVEST_CAMERA = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                              bf=150.0, width=640, height=480)
HARVEST_ORB = OrbConfig(n_features=1000)


def training_views(n_worlds: int = 12, views_per_world: int = 6,
                   seed: int = 11) -> Iterator[np.ndarray]:
    """The harvest's augmented views, float32 [480, 640] on the host, in
    the reference's order and with its draws: (a) direct views of the real
    rasters, scaled/flipped crops framed to the camera size, 6 each; (b)
    ``views_per_world`` views of each of ``n_worlds`` randomized worlds
    textured from the alternative families."""
    rng = np.random.default_rng(seed)
    cam = HARVEST_CAMERA
    real_bank = _real_textures()
    for src in real_bank:
        for _ in range(6):
            t = _alt_texture(rng, [src], size=512)
            frame = np.tile(t, (cam.height // 512 + 1,
                                cam.width // 512 + 1))[:cam.height,
                                                       :cam.width]
            yield photometric_augment(frame, rng)
    for _ in range(n_worlds):
        world = synthetic.make_world(
            rng, kind="random",
            tex_fn=lambda r: _alt_texture(r, real_bank))
        for _ in range(views_per_world):
            pose = synthetic.look_ahead_pose(
                np.array([rng.uniform(-2, 2), rng.uniform(-1, 1),
                          rng.uniform(0, 6)]),
                yaw=rng.uniform(-0.4, 0.4))
            img = synthetic.render_world(world, cam, pose, rng, noise=0.0)
            yield photometric_augment(img, rng)


def view_descriptors(img: np.ndarray, device) -> torch.Tensor:
    """One view's valid ORB descriptors [n, 8] int32 on ``device``, in the
    extractor's order (the reference's ``desc[valid]``)."""
    dev = device_mod.resolve(device)
    gray = torch.from_numpy(np.asarray(img, np.float32)).to(dev)
    f = extractor.extract(image_ops.build_pyramid(
        gray, HARVEST_ORB.n_levels, HARVEST_ORB.scale_factor), HARVEST_ORB)
    return f.desc[f.valid]


def harvest_training_descriptors(n_worlds: int = 12,
                                 views_per_world: int = 6, seed: int = 11,
                                 device=None) -> torch.Tensor:
    """ORB descriptors [M, 8] int32 for vocabulary training, extracted on
    ``device`` (by default the card) from ``training_views``: deliberately
    DISJOINT from the test worlds (other texture families, another seed
    family, augmented optics)."""
    dev = device_mod.resolve(device)
    return torch.cat([view_descriptors(img, dev) for img in
                      training_views(n_worlds, views_per_world, seed)])


def _shipped_path(k: int, levels: int) -> str:
    return os.path.abspath(os.path.join(DATA_DIR,
                                        f"vocab_k{k}_l{levels}.npz"))


def default_vocabulary(force_rebuild: bool = False, k: int = DEFAULT_K,
                       levels: int = DEFAULT_LEVELS, device=None,
                       path=None) -> Vocabulary:
    """The default tree, on ``device``.

    Loads ``path`` (by default ``data/vocab_k{k}_l{levels}.npz``) where it
    exists.  Otherwise, or with ``force_rebuild``, harvests descriptors
    and builds the tree on ``device`` (by default the card), then writes
    it there in the JAX package's layout.  ``force_rebuild`` writes only to
    a ``path`` the caller gives: the shipped trees, which both packages
    load, are never overwritten.  A loaded tree with no ``device`` stays
    in host memory."""
    shipped = _shipped_path(k, levels)
    path = os.path.abspath(path) if path is not None else shipped
    if force_rebuild and (path == shipped or (
            os.path.dirname(path) == os.path.abspath(DATA_DIR)
            and os.path.exists(path))):
        raise ValueError(
            f"default_vocabulary(force_rebuild=True) needs a path of its "
            f"own: it does not overwrite the shipped {path}")
    if not force_rebuild and os.path.exists(path):
        z = np.load(path)
        lv = int(z["levels"])
        return from_numpy([z[f"cent{d}"] for d in range(lv)], z["idf"],
                          int(z["k"]), lv, device)
    dev = device_mod.resolve(device)
    voc = build_vocabulary(harvest_training_descriptors(device=dev), k=k,
                           levels=levels, device=dev)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:    # the name as given: no ".npz" added
        np.savez_compressed(       # the JAX package's layout
            f, idf=voc.idf.cpu().numpy(), k=voc.k, levels=voc.levels,
            **{f"cent{d}": c.cpu().numpy().view(np.uint32)
               for d, c in enumerate(voc.centroids)})
    return voc
