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
* Out-of-bounds gathers: JAX (``mode="clip"``) first wraps a negative
  index by the axis length, as numpy indexing does, then clamps it into
  the axis; torch wraps negatives but raises past either end.
  ``gather_clamped`` does JAX's two steps.
* ``argmin``/``argmax`` return the first index in both frameworks
  (torch documents it), so they need no helper.

One more rule is the port's own: a float sum over duplicate indices must
not depend on the run.  On CUDA ``index_add_`` adds by atomics in arrival
order, and that alone made the loop closer's choices vary from run to
run on the card; ``scatter_add`` below sorts the indices there.
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
    """``dst.at[idx].add(src)`` along dim 0 with masked rows (``ok`` False)
    dropped, in sums that do not depend on the run.  Returns a new tensor.

    On CUDA the rows go through ``index_put_(accumulate=True)``, which
    sorts the indices and adds each index's rows in order (torch's
    deterministic form of ``index_add_``, whose atomics add in arrival
    order).  It adds a run of equal indices serially, so each masked row
    gets a dump row of its own instead of one shared dump row.  On the
    CPU ``index_add_`` adds in index order already.  An index equal to
    ``len(dst)`` is dropped too (JAX drops out-of-bounds updates)."""
    M, n = dst.shape[0], idx.shape[0]
    idx = idx.long()
    n_dump = 1
    if ok is not None:
        idx = torch.where(ok, idx, M + 1 + torch.arange(n, device=idx.device))
        n_dump += n
    buf = torch.cat([dst, dst.new_zeros((n_dump,) + tuple(dst.shape[1:]))])
    src = src.to(device=dst.device, dtype=dst.dtype)
    if buf.is_cuda:
        buf.index_put_((idx,), src, accumulate=True)
    else:
        buf.index_add_(0, idx, src)
    return buf[:M]


def scatter_min(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor
                ) -> torch.Tensor:
    """``dst.at[idx].min(src)`` along dim 0 (all indices in range)."""
    return dst.clone().scatter_reduce_(0, idx.long(), src.to(dst.dtype),
                                       reduce="amin")


def gather_clamped(x: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].get(mode="clip")``: one index tensor per leading axis
    of ``x``; a negative index is wrapped by the axis length, then every
    index is clamped into its axis (−1 reads the last row, −n−1 the
    first)."""
    def norm(i, n):
        i = i.long()
        return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)

    return x[tuple(norm(i, n) for i, n in zip(idx, x.shape))]


def mask_of(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """``zeros(size, bool).at[where(ok, idx, size)].set(True)``."""
    buf = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    buf[torch.where(ok, idx.long(), size)] = True
    return buf[:size]


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
