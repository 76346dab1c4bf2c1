"""The port's vocabulary building (``orbslam2_tpu_torch/models/
vocabulary.py``) against the JAX package's, on the same numpy inputs.

  * bit packing both ways, k-majority (centroids, assignment and the numpy
    ``Generator``'s state afterwards: random rows, fewer rows than k, no
    rows, and rows that leave clusters empty so that the re-seed runs);
  * ``build_vocabulary``: every level's centroids and ``idf`` equal;
  * the harvest, bit-exact on a small corpus (one raster in both packages'
    bank, one world, one view), given the same pyramid;
  * ``default_vocabulary``: a missing tree is built and written in the JAX
    layout, which JAX's loader reads back equal; ``force_rebuild`` needs a
    path and leaves the shipped trees alone; ``SlamEngine`` starts with
    loop closing on for a (k, levels) that ships no tree.

Tolerance: none; every output is integer, and ``idf`` is computed in
float64 numpy on the host in both packages.

Two float reductions.  JAX's ``build_pyramid`` and the moment sums of
its IC angles are XLA matrix products on the CPU, whose summation order
depends on the matrix shapes (a resized pixel's two taps are summed with
one FMA or as two rounded products; the 961 moment terms in Eigen's
blocked order).  The port sums in torch's order, so on the harvest's
non-integer images (gamma, vignette, blur, noise) a pyramid pixel or an
angle can differ by an ULP, and such an ULP can move a FAST comparison or
the rounding of a steered BRIEF point.  (The angle's sums round on every
resized level, integer frames included: only level 0 of an integer
image sums exactly.)  The harvest tests therefore hand the port JAX's
pyramid and JAX's angles (tests/jax_angles.py), and hold everything
else bit-exact: FAST, NMS, selection, blur, BRIEF, the valid mask, the
views' order, renders and draws.

JAX's own harvest runs its extractor eagerly, whose first call spends ~2
minutes compiling op by op on a CPU; the small test runs the same
extractor jitted level by level with the Gaussian blur left eager (under
``jit`` XLA fuses the blur's multiply-adds into FMAs, which changes its
bits against the eager run).  The ``slow`` test runs JAX's harvest as it
is.
"""

import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import vocabulary as jvoc
from orbslam2_tpu.ops import extractor as jext
from orbslam2_tpu.ops import fast as jfast
from orbslam2_tpu.ops import image as jimage
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.models import vocabulary as tvoc
from orbslam2_tpu_torch.ops import extractor as text
from orbslam2_tpu_torch.ops import hamming_top2 as tk
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.utils import synthetic

from jax_angles import with_jax_angles, with_jax_pyramid

torch.set_num_threads(2)


def _words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _t(desc_u32):
    return torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32))


def _clustered(rng, n_protos, copies, flips):
    """Prototype descriptors, each copied with ``flips`` random bit flips:
    tight clusters, and whole groups of equal rows at the deeper levels."""
    protos = _words(rng, n_protos)
    out = np.repeat(protos, copies, axis=0)
    w = rng.integers(0, 8, (len(out), flips))
    b = rng.integers(0, 32, (len(out), flips)).astype(np.uint32)
    for j in range(flips):
        out[np.arange(len(out)), w[:, j]] ^= np.uint32(1) << b[:, j]
    return out[rng.permutation(len(out))]


def _assert_voc_equal(tv, jv):
    assert (tv.k, tv.levels) == (jv.k, jv.levels)
    assert len(tv.centroids) == len(jv.centroids) == jv.levels
    for d, (a, b) in enumerate(zip(tv.centroids, jv.centroids)):
        assert a.dtype == torch.int32 and a.shape == b.shape, d
        np.testing.assert_array_equal(a.cpu().numpy().view(np.uint32),
                                      np.asarray(b), err_msg=f"level {d}")
    assert tv.idf.dtype == torch.float32
    np.testing.assert_array_equal(tv.idf.cpu().numpy(), np.asarray(jv.idf))


# ------------------------------------------------------------- the bits ---

def test_bits_unpack_and_pack_like_jax():
    rng = np.random.default_rng(0)
    d = _words(rng, 300)
    d[0] = 0
    d[1] = 0xFFFFFFFF
    d[2] = 0x80000000                  # negative as int32
    tb = tvoc._unpack_bits(_t(d))
    jb = jvoc._unpack_bits(d)
    assert tb.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(tvoc._pack_bits(tb).numpy().view(np.uint32),
                                  jvoc._pack_bits(jb))


# ------------------------------------------------------------ k-majority --

def _kmajority_input(case):
    rng = np.random.default_rng(1)
    if case == "random":
        return _words(rng, 500), 10
    if case == "fewer_rows_than_k":
        return _words(rng, 3), 10
    if case == "no_rows":
        return _words(rng, 0), 10
    # 60 rows of 3 distinct descriptors, k = 5: equal initial centroids
    # leave clusters empty, and the re-seed runs
    return _words(rng, 3)[rng.integers(0, 3, 60)], 5


@pytest.mark.parametrize("case", ["random", "fewer_rows_than_k", "no_rows",
                                  "empty_clusters"])
def test_kmajority_matches_jax(case, monkeypatch):
    desc, k = _kmajority_input(case)
    calls = []
    nearest = tvoc._nearest
    monkeypatch.setattr(tvoc, "_nearest",
                        lambda *a: calls.append(1) or nearest(*a))
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    cj, aj = jvoc._kmajority(jvoc._unpack_bits(desc), k, rj)
    ct, at = tvoc._kmajority(tvoc._unpack_bits(_t(desc)), k, rt)
    assert ct.dtype == torch.uint8 and at.dtype == torch.int64
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(at.numpy(), aj)
    assert rt.bit_generator.state == rj.bit_generator.state
    # 6 iterations and the final assignment, then one per re-seed
    if case == "no_rows":
        assert calls == []
    elif case == "random":
        assert len(calls) == 7
    else:
        assert len(calls) > 7


# ------------------------------------------------------ build_vocabulary --

@pytest.mark.parametrize("k,levels,data", [
    (5, 2, "random"), (8, 2, "clustered"), (10, 3, "random"),
    (10, 3, "clustered")])
def test_build_vocabulary_matches_jax(k, levels, data):
    """2k-20k descriptors; the clustered sets hold groups of equal rows
    deep in the tree, where clusters fall empty.  The port takes the JAX
    layout (uint32 numpy) and its own (int32 tensor) alike."""
    rng = np.random.default_rng(k * 10 + levels)
    n = {(5, 2): 2000, (8, 2): 6000, (10, 3): 20000}[(k, levels)]
    desc = _words(rng, n) if data == "random" else \
        _clustered(rng, n // 50, 50, 6)
    jv = jvoc.build_vocabulary(desc, k=k, levels=levels, seed=3)
    given = desc if data == "random" else _t(desc)
    tv = tvoc.build_vocabulary(given, k=k, levels=levels, seed=3,
                               device="cpu")
    _assert_voc_equal(tv, jv)


# ------------------------------------------------------------ the harvest --

def test_texture_and_augment_copies_match_jax():
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    bank = [np.asarray(synthetic._make_texture(np.random.default_rng(5),
                                               256))]
    for _ in range(12):          # every family, the raster crop included
        np.testing.assert_array_equal(tvoc._alt_texture(rng_t, bank, 128),
                                      jvoc._alt_texture(rng_j, bank, 128))
    img = np.random.default_rng(6).uniform(0, 255, (60, 80))
    for _ in range(4):
        np.testing.assert_array_equal(tvoc.photometric_augment(img, rng_t),
                                      jvoc.photometric_augment(img, rng_j))
    assert rng_t.bit_generator.state == rng_j.bit_generator.state


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_keypoints(img, cap, cfg):
    score = jfast.nms_3x3(jfast.fast_score(img))
    xy, resp, valid = jext._select_keypoints(
        score, cap, float(cfg.ini_th_fast), float(cfg.min_th_fast),
        border=cfg.edge_threshold)
    return xy, resp, valid, jext.keypoint_angles(img, xy)


_jax_descriptors = jax.jit(jext._descriptors)
_jax_pyramid = jax.jit(jimage.build_pyramid, static_argnums=(1, 2))


def _jax_extract(img, cfg):
    """``orbslam2_tpu.ops.extractor.extract``, its level bodies jitted and
    the blur eager (the module docstring says why); the same bits as the
    eager extractor on the small harvest's views."""
    plan = jext.level_plan(cfg)
    parts = []
    for lv, level_img in enumerate(_jax_pyramid(img, cfg.n_levels,
                                                cfg.scale_factor)):
        xy, resp, valid, angle = _jax_keypoints(level_img, plan.caps[lv],
                                                cfg)
        desc = _jax_descriptors(jimage.gaussian_blur(level_img, 7, 2.0), xy,
                                angle)
        parts.append((xy * plan.scales[lv],
                      jnp.full((plan.caps[lv],), lv, jnp.int32), angle, resp,
                      valid, desc))
    return jext.Features(*(jnp.concatenate([p[i] for p in parts])
                           for i in range(6)))


def _one_raster_bank():
    return [np.asarray(synthetic._make_texture(np.random.default_rng(5),
                                               256))]


def test_small_harvest_matches_jax(monkeypatch):
    """One raster in both banks (6 direct views) and one world seen once:
    the port's descriptors equal JAX's, row for row."""
    for mod in (jvoc, tvoc):
        monkeypatch.setattr(mod, "_real_textures", _one_raster_bank)
    monkeypatch.setattr(jext, "extract", _jax_extract)
    monkeypatch.setattr(tvoc.image_ops, "build_pyramid", with_jax_pyramid)
    monkeypatch.setattr(text, "keypoint_angles", with_jax_angles)
    want = jvoc.harvest_training_descriptors(n_worlds=1, views_per_world=1)
    got = tvoc.harvest_training_descriptors(n_worlds=1, views_per_world=1,
                                            device="cpu")
    assert got.dtype == torch.int32 and len(want) > 3000
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ---------------------------------------------------- default_vocabulary --

def _small_harvest(monkeypatch, tmp_path):
    """default_vocabulary's harvest cut to one world seen once, no raster
    bank; DATA_DIR pointed at ``tmp_path``."""
    monkeypatch.setattr(tvoc, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(tvoc, "_real_textures", lambda: [])
    monkeypatch.setattr(tvoc, "harvest_training_descriptors",
                        functools.partial(tvoc.harvest_training_descriptors,
                                          n_worlds=1, views_per_world=1))


def test_default_vocabulary_builds_a_missing_tree(tmp_path, monkeypatch):
    _small_harvest(monkeypatch, tmp_path)
    voc = tvoc.default_vocabulary(k=5, levels=2, device="cpu")
    path = tmp_path / "vocab_k5_l2.npz"
    z = np.load(path)
    assert sorted(z.files) == ["cent0", "cent1", "idf", "k", "levels"]
    assert z["cent1"].dtype == np.uint32 and z["idf"].dtype == np.float32
    # JAX's loader reads the file back to the port's tree, which is JAX's
    # build on the same descriptors
    monkeypatch.setattr(jvoc, "_DATA_DIR", str(tmp_path))
    _assert_voc_equal(voc, jvoc.default_vocabulary(k=5, levels=2))
    desc = tvoc.harvest_training_descriptors(device="cpu")
    _assert_voc_equal(voc, jvoc.build_vocabulary(
        desc.numpy().view(np.uint32), k=5, levels=2))
    # a second call loads the written tree
    monkeypatch.setattr(tvoc, "harvest_training_descriptors", None)
    _assert_voc_equal(tvoc.default_vocabulary(k=5, levels=2),
                      jvoc.default_vocabulary(k=5, levels=2))


def test_force_rebuild_needs_a_path_and_keeps_the_shipped_trees(
        tmp_path, monkeypatch):
    shipped = [os.path.join(tvoc.DATA_DIR, f"vocab_k10_l{lv}.npz")
               for lv in (3, 4)]
    before = [hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in shipped]
    with pytest.raises(ValueError, match="vocab_k10_l4.npz"):
        tvoc.default_vocabulary(force_rebuild=True, device="cpu")
    with pytest.raises(ValueError, match="vocab_k10_l3.npz"):
        tvoc.default_vocabulary(force_rebuild=True, k=4, levels=2,
                                device="cpu", path=shipped[0])
    # with a path it rebuilds there, even where the file exists
    _small_harvest(monkeypatch, tmp_path)
    out = tmp_path / "sub" / "mine.vocab"         # written as named
    out.parent.mkdir()
    out.write_bytes(b"stale")
    voc = tvoc.default_vocabulary(force_rebuild=True, k=4, levels=2,
                                  device="cpu", path=str(out))
    back = tvoc.default_vocabulary(k=4, levels=2, path=str(out))
    assert (back.k, back.levels) == (4, 2)
    assert all(torch.equal(a, b) for a, b in zip(back.centroids,
                                                  voc.centroids))
    assert torch.equal(back.idf, voc.idf)
    assert [hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in shipped] == before


def test_slam_engine_starts_with_loop_closing_on_a_built_tree(
        tmp_path, monkeypatch):
    """No vocab_k5_l2.npz ships: the engine builds it on its device."""
    _small_harvest(monkeypatch, tmp_path)
    cfg = tconfig.SlamConfig(capacity=tconfig.CapacityConfig(
        max_keyframes=4, max_map_points=1024, local_ba_keyframes=2,
        local_ba_points=256, vocab_k=5, vocab_levels=2))
    eng = SlamEngine(cfg, device="cpu")
    assert eng.loop_closer is not None
    voc = eng.loop_closer.voc
    assert (voc.k, voc.levels, voc.n_words) == (5, 2, 25)
    assert voc.centroids[1].device.type == "cpu"
    assert (tmp_path / "vocab_k5_l2.npz").exists()


# --------------------------------------------------------------- slow ----

@pytest.mark.slow
def test_default_harvest_and_tree_match_jax(monkeypatch):
    """The full default harvest (every bank raster, 12 worlds × 6 views),
    JAX's extractor as it is (the port given its pyramid and angles), and
    the k=10, levels=4 tree built from it:
    held against JAX's rebuild on the same descriptors.  Not against
    data/vocab_k10_l4.npz: a JAX rebuild today differs from that file at
    every level and in idf."""
    want = jvoc.harvest_training_descriptors()
    monkeypatch.setattr(tvoc.image_ops, "build_pyramid", with_jax_pyramid)
    monkeypatch.setattr(text, "keypoint_angles", with_jax_angles)
    got = tvoc.harvest_training_descriptors(device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    _assert_voc_equal(tvoc.build_vocabulary(got, k=10, levels=4,
                                            device="cpu"),
                      jvoc.build_vocabulary(want, k=10, levels=4))


def test_hamming_top2_counts_the_build_only_on_the_card():
    """On CPU tensors the assignment runs the plain version: no launch
    is counted, under vocab_build or elsewhere."""
    before = dict(tk.hamming_top2.launches_by_site), tk.hamming_top2.launches
    tvoc.build_vocabulary(_words(np.random.default_rng(2), 500), k=4,
                          levels=2, device="cpu")
    assert (dict(tk.hamming_top2.launches_by_site),
            tk.hamming_top2.launches) == before
