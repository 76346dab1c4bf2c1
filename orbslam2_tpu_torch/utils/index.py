"""JAX index semantics, made explicit for torch.

No JAX counterpart: these helpers pin down the four places where JAX and
torch disagree silently and the map code depends on JAX's behaviour.

* Out-of-bounds scatter writes: JAX drops them, torch raises (CPU) or
  device-asserts (CUDA).  Every scatter here writes into a buffer with
  ONE extra dump row that masked entries target, then slices it off.
* Duplicate-index ``.at[].set``: JAX leaves the winner unspecified; XLA
  on the CPU (the reference the tests hold the port to) applies updates
  in order, so the LAST source wins.  ``scatter_set`` makes that rule
  explicit and deterministic on every device.
* ``lax.top_k`` breaks ties to the lower index; ``torch.topk`` promises
  no order.  ``topk`` here is a stable descending sort.
* ``argmin``/``argmax`` return the first index in both frameworks
  (torch documents it), so they need no helper.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _dump_buffer(dst: torch.Tensor) -> torch.Tensor:
    buf = torch.empty((dst.shape[0] + 1,) + tuple(dst.shape[1:]),
                      dtype=dst.dtype, device=dst.device)
    buf[:-1] = dst
    return buf


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, src,
                ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dst.at[idx].set(src)`` along dim 0 with masked rows (``ok`` False)
    dropped; among sources writing the same row the last one wins.
    Returns a new tensor; ``dst`` is not modified."""
    M = dst.shape[0]
    idx = idx.long()
    n = idx.shape[0]
    if ok is None:
        ok = torch.ones(n, dtype=torch.bool, device=idx.device)
    tgt = torch.where(ok, idx, M)
    pos = torch.arange(n, device=idx.device)
    last = torch.full((M + 1,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, tgt, pos, reduce="amax")
    keep = ok & (last[tgt] == pos)
    buf = _dump_buffer(dst)
    src = torch.as_tensor(src).to(device=dst.device, dtype=dst.dtype)
    src = src.expand((n,) + tuple(dst.shape[1:]))
    buf[torch.where(keep, idx, M)] = src
    return buf[:M]


def scatter_add(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dst.at[idx].add(src)`` along dim 0 with masked rows dropped."""
    M = dst.shape[0]
    idx = idx.long()
    if ok is not None:
        idx = torch.where(ok, idx, M)
    buf = _dump_buffer(dst)
    buf.index_add_(0, idx, src.to(device=dst.device, dtype=dst.dtype))
    return buf[:M]


def scatter_min(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor
                ) -> torch.Tensor:
    """``dst.at[idx].min(src)`` along dim 0 (all indices in range)."""
    return dst.clone().scatter_reduce_(0, idx.long(), src.to(dst.dtype),
                                       reduce="amin")


def mask_of(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """``zeros(size, bool).at[where(ok, idx, size)].set(True)``."""
    buf = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    buf[torch.where(ok, idx.long(), size)] = True
    return buf[:size]


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
