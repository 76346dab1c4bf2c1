"""Batched 256-bit Hamming distance.

Port of ``orbslam2_tpu/ops/hamming.py``.  Descriptors are [N, 8] int32
words carrying the uint32 bit pattern (torch has no ``>>`` and no popcount
for uint32 on the CPU); popcount is the SWAR bit trick over the word
widened to int64.  There is no matrix-unit form here: the JAX version's
bf16 unpack exists for the TPU's MXU only.
"""

from __future__ import annotations

import torch

MAX_DIST = 256  # distances are in [0, 256]; used as +inf sentinel

_M32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (read as uint32) → int64."""
    v = x.to(torch.int64) & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 8] × [M, 8] → [N, M] int32 distances (word loop, one [N, M]
    accumulator)."""
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32,
                      device=a.device)
    for k in range(a.shape[-1]):
        acc += popcount32(a[:, k, None] ^ b[None, :, k]).to(torch.int32)
    return acc


def hamming_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 8] × [..., 8] → [...] elementwise distances."""
    return torch.sum(popcount32(a ^ b), dim=-1).to(torch.int32)


def masked_hamming_matrix(a: torch.Tensor, a_valid: torch.Tensor,
                          b: torch.Tensor, b_valid: torch.Tensor
                          ) -> torch.Tensor:
    """Hamming matrix with invalid rows/cols forced to MAX_DIST."""
    d = hamming_matrix(a, b)
    mask = a_valid[:, None] & b_valid[None, :]
    return torch.where(mask, d, torch.full_like(d, MAX_DIST))
