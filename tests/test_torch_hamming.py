"""Hamming distance, the plain hamming_top2 and match_descriptors of the
port against the JAX package.  Tolerance: bit-exact (integer outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import hamming as jh
from orbslam2_tpu.ops import matching as jm
from orbslam2_tpu_torch.convert import to_tensor
from orbslam2_tpu_torch.ops import hamming as th
from orbslam2_tpu_torch.ops import hamming_top2 as tk
from orbslam2_tpu_torch.ops import matching as tm

torch.set_num_threads(2)


def _words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _jax_top2(a, av, b, bv):
    d = jh.masked_hamming_matrix(jnp.asarray(a), jnp.asarray(av),
                                 jnp.asarray(b), jnp.asarray(bv))
    return [np.asarray(x) for x in jm.best_and_second(d)]


def _port_top2(a, av, b, bv):
    out = tk.hamming_top2(to_tensor(a), to_tensor(av), to_tensor(b),
                          to_tensor(bv))
    assert all(x.dtype == torch.int32 for x in out)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("A,B", [(1024, 1024), (600, 512), (256, 300)])
def test_hamming_top2_plain_matches_jax(A, B):
    rng = np.random.default_rng(A + B)
    a, b = _words(rng, A), _words(rng, B)
    av, bv = rng.random(A) < 0.9, rng.random(B) < 0.9
    for got, ref in zip(_port_top2(a, av, b, bv), _jax_top2(a, av, b, bv)):
        np.testing.assert_array_equal(got, ref)


def _edge_case(name, rng):
    a, b = _words(rng, 40), _words(rng, 90)
    av, bv = rng.random(40) < 0.9, rng.random(90) < 0.9
    if name == "all_invalid_rows":
        av[:5] = False
    elif name == "all_invalid_bank":
        bv[:] = False
    elif name == "bank_of_one":
        b, bv = b[:1], np.ones(1, bool)
    elif name == "no_query_rows":
        a, av = a[:0], av[:0]
    elif name == "ties":
        base = _words(rng, 10)
        b = np.concatenate([base, base, base])
        bv = np.ones(30, bool)
        a = b[rng.permutation(30)[:20]]
        av = np.ones(20, bool)
    return a, av, b, bv


@pytest.mark.parametrize("name", ["all_invalid_rows", "all_invalid_bank",
                                  "bank_of_one", "ties", "no_query_rows"])
def test_hamming_top2_edge_cases_match_jax(name):
    a, av, b, bv = _edge_case(name, np.random.default_rng(1))
    got = _port_top2(a, av, b, bv)
    for g, r in zip(got, _jax_top2(a, av, b, bv)):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    if name == "all_invalid_rows":
        assert (got[0][:5] == 256).all() and (got[1][:5] == 0).all()
        assert (got[2][:5] == 256).all()
    if name == "bank_of_one":
        assert (got[2] == 256).all()
    if name == "ties":           # duplicates: best and second both 0
        assert (got[0] == 0).all() and (got[2] == 0).all()


def _slice_top2(a, av, b, bv, cols):
    """The plain version on the bank columns ``cols`` (ascending), its
    indices mapped back to the whole bank.  No columns reads (257,
    INT32_MAX, 257), as a lane or warp of the kernel that saw none."""
    if len(cols) == 0:
        empty = torch.full((a.shape[0],), tk.MAX_DIST + 1, dtype=torch.int32)
        return (empty, torch.full_like(empty, np.iinfo(np.int32).max),
                empty.clone())
    best, idx, second = tk.hamming_top2_reference(
        to_tensor(a), to_tensor(av), to_tensor(b[cols]), to_tensor(bv[cols]))
    return best, torch.from_numpy(cols.astype(np.int32))[idx.long()], second


@pytest.mark.parametrize("split", ["lanes-2", "lanes-32", "splits-2",
                                   "splits-3"])
@pytest.mark.parametrize("name", ["random", "all_invalid_rows",
                                  "all_invalid_bank", "bank_of_one", "ties"])
def test_merge_top2_folds_column_slices_exactly(name, split):
    """The kernel's merge rule (``merge_top2``): the bank cut into column
    slices, strided as the kernel cuts it among the lanes of a warp, or
    in contiguous ranges (the rule holds for any cut into disjoint
    slices), the plain version on each slice, the partials folded in
    order and clamped to 256 — bit-exact against the JAX package's
    best_and_second(masked_hamming_matrix)."""
    rng = np.random.default_rng(2)
    if name == "random":
        a, b = _words(rng, 64), _words(rng, 301)
        av, bv = rng.random(64) < 0.9, rng.random(301) < 0.9
    else:
        a, av, b, bv = _edge_case(name, rng)
    kind, P = split.split("-")
    P, cols = int(P), np.arange(b.shape[0])
    slices = ([cols[lane::P] for lane in range(P)] if kind == "lanes"
              else np.array_split(cols, P))
    parts = [_slice_top2(a, av, b, bv, c) for c in slices]
    best, idx, second = parts[0]
    for part in parts[1:]:
        best, idx, second = tk.merge_top2((best, idx, second), part)
    got = [torch.clamp(best, max=tk.MAX_DIST), idx,
           torch.clamp(second, max=tk.MAX_DIST)]
    for g, r in zip(got, _jax_top2(a, av, b, bv)):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("N,M", [(37, 53), (1100, 1000)])
def test_hamming_matrix_matches_jax(N, M):
    """(1100, 1000) is past the JAX MXU threshold: its bf16 form must
    agree with the port's SWAR popcount too."""
    rng = np.random.default_rng(N)
    a, b = _words(rng, N), _words(rng, M)
    np.testing.assert_array_equal(
        th.hamming_matrix(to_tensor(a), to_tensor(b)).numpy(),
        np.asarray(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        th.hamming_pairwise(to_tensor(a[:30]), to_tensor(b[:30])).numpy(),
        np.asarray(jh.hamming_pairwise(jnp.asarray(a[:30]),
                                       jnp.asarray(b[:30]))))


def _matchable(rng, A, B, flips=20):
    """A bank and queries that are noisy, shuffled copies of bank rows."""
    b = _words(rng, B)
    src = rng.permutation(B)[:A]
    a = b[src].copy()
    bits = rng.integers(0, 256, (A, flips))
    for i in range(A):
        for k in bits[i, : rng.integers(0, flips)]:
            a[i, k // 32] ^= np.uint32(1) << np.uint32(k % 32)
    ang_b = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    ang_a = (ang_b[src] + rng.normal(0, 0.05, A)).astype(np.float32)
    return a, b, ang_a, ang_b


@pytest.mark.parametrize("A,B,with_angles",
                         [(300, 400, True), (512, 512, True),
                          (200, 256, False)])
def test_match_descriptors_matches_jax(A, B, with_angles):
    rng = np.random.default_rng(A)
    a, b, ang_a, ang_b = _matchable(rng, A, B)
    av, bv = rng.random(A) < 0.95, rng.random(B) < 0.95
    if not with_angles:           # no rotation-histogram check
        ang_a = ang_b = None
    jm_, jd = jm.match_descriptors(
        jnp.asarray(a), jnp.asarray(av), jnp.asarray(b), jnp.asarray(bv),
        nn_ratio=0.7, th=jm.TH_LOW,
        angle_a=None if ang_a is None else jnp.asarray(ang_a),
        angle_b=None if ang_b is None else jnp.asarray(ang_b))
    tm_, td = tm.match_descriptors(
        to_tensor(a), to_tensor(av), to_tensor(b), to_tensor(bv),
        nn_ratio=0.7, th=tm.TH_LOW,
        angle_a=None if ang_a is None else to_tensor(ang_a),
        angle_b=None if ang_b is None else to_tensor(ang_b))
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (tm_.numpy() >= 0).sum() > A // 4


def test_hamming_top2_refuses_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused:
    the wrapper has no silent fallback to the plain version."""
    a = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    v = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        tk.hamming_top2(a, v, a, v)
