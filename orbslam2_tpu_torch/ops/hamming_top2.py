"""Fused 256-bit Hamming distance + top-2 reduction.

Port of ``orbslam2_tpu/ops/pallas_hamming.py`` (``hamming_top2``, the
JAX package's one Pallas kernel).  On a CUDA tensor :func:`hamming_top2`
launches the hand-written Hopper kernel ``csrc/hamming_top2.cu``; on CPU
tensors it runs :func:`hamming_top2_reference`, the plain PyTorch
version.  There is no fallback from the card to the plain version: a
build or launch failure raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orbslam2_tpu_torch.ops import hamming

MAX_DIST = hamming.MAX_DIST


def hamming_top2_reference(a_desc: torch.Tensor, a_valid: torch.Tensor,
                           b_desc: torch.Tensor, b_valid: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version: ``best_and_second(masked_hamming_matrix(...))`` —
    (best [A], first best column [A], second-best excluding that column
    [A]), all int32."""
    d = hamming.masked_hamming_matrix(a_desc, a_valid, b_desc, b_valid)
    best = torch.amin(d, dim=1)
    idx = torch.argmin(d, dim=1)            # first index of the minimum
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), idx] = MAX_DIST
    second = torch.amin(d2, dim=1)
    return best, idx.to(torch.int32), second


def _lib():
    from orbslam2_tpu_torch.kernels import build

    lib = build.load("hamming_top2")
    fn = lib.hamming_top2_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"hamming_top2: {name} is on {t.device}, not CUDA")
    if t.dtype != dtype:
        raise TypeError(f"hamming_top2: {name} is {t.dtype}, needs {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"hamming_top2: {name} has shape {tuple(t.shape)}, "
                         f"needs {shape}")
    if not t.is_contiguous():
        raise ValueError(f"hamming_top2: {name} is not contiguous")


def hamming_top2(a_desc: torch.Tensor, a_valid: torch.Tensor,
                 b_desc: torch.Tensor, b_valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[A, 8] × [B, 8] int32 words → (best, best_idx, second) [A] int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``hamming_top2.launches`` counts those launches)."""
    if all(t.device.type == "cpu" for t in (a_desc, a_valid, b_desc,
                                             b_valid)):
        return hamming_top2_reference(a_desc, a_valid, b_desc, b_valid)
    A, B = a_desc.shape[0], b_desc.shape[0]
    if B < 1:
        raise ValueError("hamming_top2: the bank B is empty")
    _check("a_desc", a_desc, torch.int32, (A, 8))
    _check("a_valid", a_valid, torch.bool, (A,))
    _check("b_desc", b_desc, torch.int32, (B, 8))
    _check("b_valid", b_valid, torch.bool, (B,))
    dev = a_desc.device
    if any(t.device != dev for t in (a_valid, b_desc, b_valid)):
        raise ValueError("hamming_top2: inputs are on different devices")
    fn = _lib()
    best = torch.empty(A, dtype=torch.int32, device=dev)
    idx = torch.empty(A, dtype=torch.int32, device=dev)
    second = torch.empty(A, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a_desc.data_ptr(), a_valid.data_ptr(), b_desc.data_ptr(),
                 b_valid.data_ptr(), A, B, best.data_ptr(), idx.data_ptr(),
                 second.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hamming_top2 kernel launch failed: CUDA error "
                           f"{err}")
    hamming_top2.launches += 1
    return best, idx, second


hamming_top2.launches = 0
