"""The hand-written Hopper kernel against its plain PyTorch version, on
the card.  Skipped where torch has no CUDA device; ``python3
chip_smoke.py`` runs the same comparisons at the main path's shapes.

Tolerance: bit-exact (integer outputs)."""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.ops import hamming_top2 as tk
from orbslam2_tpu_torch.ops import matching

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    # decided per test, not at import: every xdist worker collects alike
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU interpret "
                    "mode)")


def _inputs(A, B, seed=0):
    rng = np.random.default_rng(seed)

    def words(n):
        return torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8),
                                             dtype=np.uint32).view(np.int32)
                                ).cuda()

    return (words(A), torch.from_numpy(rng.random(A) < 0.9).cuda(),
            words(B), torch.from_numpy(rng.random(B) < 0.9).cuda())


@pytest.mark.parametrize("A,B", [(1024, 1024), (600, 512), (256, 300),
                                 (1024, 16384), (7, 1)])
def test_kernel_matches_plain(A, B):
    args = _inputs(A, B)
    got = tk.hamming_top2(*args)
    ref = tk.hamming_top2_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_match_descriptors_launches_the_kernel():
    a, av, b, bv = _inputs(512, 512, seed=1)
    before = tk.hamming_top2.launches
    m, d = matching.match_descriptors(a, av, b, bv)
    torch.cuda.synchronize()
    assert tk.hamming_top2.launches == before + 1
    assert m.is_cuda and d.is_cuda


def test_wrapper_rejects_bad_inputs():
    a, av, b, bv = _inputs(64, 64)
    with pytest.raises(TypeError):
        tk.hamming_top2(a.long(), av, b, bv)
    with pytest.raises(ValueError):
        tk.hamming_top2(a.t().contiguous().t(), av, b, bv)  # non-contiguous
    with pytest.raises(ValueError):
        tk.hamming_top2(a[:, :4].contiguous(), av, b, bv)
    with pytest.raises(ValueError):
        tk.hamming_top2(a, av, b.cpu(), bv)
