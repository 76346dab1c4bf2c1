"""Batched 256-bit Hamming distance.

Port of ``orbslam2_tpu/ops/hamming.py``.  Descriptors are [N, 8] int32
words carrying the uint32 bit pattern.  All arithmetic stays in int32:
:func:`popcount32` counts bits with the SWAR trick on the low 31 bits of
each word (no step leaves int32's range, so no step relies on signed
overflow) and adds the sign bit through the arithmetic ``>> 31``.

:func:`hamming_matrix` takes the matrix form of the JAX version's large
path: the words unpacked to ±1 float32 bits, whose inner product
``s = Σ a_i·b_i`` gives ``d = (32·W − s) / 2``.  Every term and every
partial sum is an integer of magnitude ≤ 32·W, exact in float32 (and in
TF32 or bf16 operands with float32 accumulation), so the distances are
bit-identical to the popcount's in any summation order, on the CPU and
on the card.
"""

from __future__ import annotations

import torch

MAX_DIST = 256  # distances are in [0, 256]; used as +inf sentinel


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (read as uint32) → int32."""
    v = x & 0x7FFFFFFF
    v -= (v >> 1).bitwise_and_(0x55555555)
    v = (v & 0x33333333).add_((v >> 2).bitwise_and_(0x33333333))
    v += v >> 4
    v &= 0x0F0F0F0F                      # bytes hold their counts (≤ 8)
    v += v >> 8
    v += v >> 16
    v &= 0x3F
    v -= x >> 31                         # −1 where the sign bit is set
    return v


def _signed_bits(x: torch.Tensor) -> torch.Tensor:
    """[N, W] int32 words → [N, 32·W] float32 of ±1 (bit set: −1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    bits = (x[:, :, None] >> shifts) & 1
    return (1 - 2 * bits).flatten(1).to(torch.float32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, W] × [M, W] → [N, M] int32 distances (one matrix product)."""
    n_bits = 32 * a.shape[-1]
    # filled on the device: a tensor from a Python scalar would be a
    # blocking host-to-device copy, and a stream sync, on every call
    half = torch.full((), 0.5 * n_bits, dtype=torch.float32,
                      device=a.device)
    s = torch.addmm(half, _signed_bits(a), _signed_bits(b).T, alpha=-0.5)
    return s.to(torch.int32)


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
