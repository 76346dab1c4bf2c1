"""Checks of the port's int32 Hamming arithmetic against Python's bit count
and against the former int64 formula, on any torch device.  No JAX here:
tests/test_torch_cuda.py runs the same checks on the card, whose host has
no JAX; tests/test_torch_hamming.py runs them on the CPU and adds the JAX
package's functions."""

import numpy as np
import torch

from orbslam2_tpu_torch.ops import hamming as th

_M32 = 0xFFFFFFFF


def as_int32(w: int) -> int:
    """A uint32 bit pattern read as int32."""
    return int(np.array(w & _M32, dtype=np.uint32).view(np.int32))


# 0, all ones, INT_MIN, INT_MAX, alternating bits, and one set bit at each
# of the 32 positions
EDGE_WORDS = ([0, -1, -2 ** 31, 2 ** 31 - 1, as_int32(0x55555555),
               as_int32(0xAAAAAAAA)] + [as_int32(1 << i) for i in range(32)])


def python_count(w: int) -> int:
    return bin(w & _M32).count("1")


def popcount32_int64(x: torch.Tensor) -> torch.Tensor:
    """The port's former popcount: SWAR over the word widened to int64."""
    v = x.to(torch.int64) & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def hamming_int64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 8] × [M, 8] distances by the former formula, as int32."""
    return torch.sum(popcount32_int64(a[:, None, :] ^ b[None, :, :]),
                     dim=-1).to(torch.int32)


def check_popcount(words, device):
    x = torch.tensor(words, dtype=torch.int32, device=device)
    got = th.popcount32(x)
    assert got.dtype == torch.int32 and got.device == x.device
    assert got.cpu().tolist() == [python_count(w) for w in words]


def descriptor_rows(rng, n):
    """[n, 8] int32 words: random rows, then rows of each edge word."""
    rows = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)
    edges = np.repeat(np.array(EDGE_WORDS, np.int32)[:, None], 8, axis=1)
    return np.concatenate([rows, edges])


def check_hamming(a, av, b, bv, device):
    """The three distance functions on ``device`` against the int64
    formula on the CPU: bit-equal, int32.  Returns their numpy outputs."""
    ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    tav = torch.from_numpy(av).to(device)
    tbv = torch.from_numpy(bv).to(device)
    ref = hamming_int64(torch.from_numpy(a), torch.from_numpy(b))
    d = th.hamming_matrix(ta, tb)
    md = th.masked_hamming_matrix(ta, tav, tb, tbv)
    k = min(len(a), len(b))
    pw = th.hamming_pairwise(ta[:k], tb[:k])
    for t in (d, md, pw):
        assert t.dtype == torch.int32 and t.device == ta.device
    d, md, pw = d.cpu(), md.cpu(), pw.cpu()
    assert torch.equal(d, ref)
    mask = torch.from_numpy(av[:, None] & bv[None, :])
    assert torch.equal(md, torch.where(mask, ref, th.MAX_DIST))
    assert torch.equal(pw, torch.diagonal(ref[:k, :k]).contiguous())
    return d.numpy(), md.numpy(), pw.numpy()
