"""Fused 256-bit Hamming distance + top-2 reduction.

Port of ``orbslam2_tpu/ops/pallas_hamming.py`` (``hamming_top2``, the
JAX package's one Pallas kernel).  On a CUDA tensor :func:`hamming_top2`
launches the hand-written Hopper kernel ``csrc/hamming_top2.cu``; on CPU
tensors it runs :func:`hamming_top2_reference`, the plain PyTorch
version.  There is no fallback from the card to the plain version: a
build or launch failure raises.

``hamming_top2.launches`` counts kernel launches; ``launches_by_site``
splits that count by the caller that named itself with
:func:`launch_site` (the paths that reach the kernel: tracking's
TrackReferenceKeyFrame, loop closing's Sim3 matching, relocalization;
the windowed engine's in-window fallback counts as
``window/track_ref_kf``).  Both counters are updated under one lock:
the async engine launches from its tracking thread and from its mapping
worker.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Tuple

import torch

from orbslam2_tpu_torch.ops import hamming

MAX_DIST = hamming.MAX_DIST

_site = threading.local()
_count_lock = threading.Lock()


@contextlib.contextmanager
def launch_site(name: str):
    """Attribute this thread's kernel launches inside the block to
    ``name`` in ``hamming_top2.launches_by_site``; inside another site's
    block the name is ``outer/name``."""
    prev = getattr(_site, "name", None)
    _site.name = f"{prev}/{name}" if prev else name
    try:
        yield
    finally:
        _site.name = prev


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


def merge_top2(x: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
               y: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's merge rule in plain PyTorch: two partial (best, first
    best column, second excluding it) over disjoint column sets → the same
    over their union.  The winner has the smaller best, on a tie the
    smaller column; second = min(winner's second, loser's best), exact
    because the loser's best column is not the winner's."""
    xb, xi, xs = x
    yb, yi, ys = y
    x_wins = (xb < yb) | ((xb == yb) & (xi < yi))
    return (torch.where(x_wins, xb, yb), torch.where(x_wins, xi, yi),
            torch.minimum(torch.where(x_wins, xs, ys),
                          torch.where(x_wins, yb, xb)))


_kernel = None                 # the ctypes launch function


def _kernel_fn():
    global _kernel
    if _kernel is None:
        from orbslam2_tpu_torch.kernels import build

        fn = build.load("hamming_top2").hamming_top2_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, p, p]
        fn.restype = i
        _kernel = fn
    return _kernel


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


def _check_inputs(a_desc, a_valid, b_desc, b_valid):
    """Device, type, shape, contiguity and alignment of the kernel's
    inputs → (A, B, device); raises on anything the kernel does not take."""
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
    if a_desc.data_ptr() % 16 or b_desc.data_ptr() % 16:
        raise ValueError("hamming_top2: descriptors must be 16-byte aligned")
    return A, B, dev


def hamming_top2(a_desc: torch.Tensor, a_valid: torch.Tensor,
                 b_desc: torch.Tensor, b_valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[A, 8] × [B, 8] int32 words → (best, best_idx, second) [A] int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``hamming_top2.launches`` counts those launches)."""
    if all(t.device.type == "cpu" for t in (a_desc, a_valid, b_desc,
                                             b_valid)):
        return hamming_top2_reference(a_desc, a_valid, b_desc, b_valid)
    A, B, dev = _check_inputs(a_desc, a_valid, b_desc, b_valid)
    out = a_desc.new_empty((3, A))                      # int32, on dev
    if A == 0:
        return out.unbind(0)
    launch = _kernel_fn()
    with torch.cuda.device(dev):
        err = launch(a_desc.data_ptr(), a_valid.data_ptr(),
                     b_desc.data_ptr(), b_valid.data_ptr(), A, B,
                     out.data_ptr(),
                     # the current stream's handle without building a
                     # torch.cuda.Stream (6 us of host time on the H100)
                     torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"hamming_top2 kernel launch failed: CUDA error "
                           f"{err}")
    site = getattr(_site, "name", None) or "other"
    with _count_lock:
        hamming_top2.launches += 1
        by_site = hamming_top2.launches_by_site
        by_site[site] = by_site.get(site, 0) + 1
    return out.unbind(0)


def reset_launch_counts() -> None:
    with _count_lock:
        hamming_top2.launches = 0
        hamming_top2.launches_by_site.clear()


hamming_top2.launches = 0
hamming_top2.launches_by_site = {}
