"""A 1-D mesh of shards: one thread per shard, sums across them.

Port of ``orbslam2_tpu/parallel/mesh.py``.  JAX lays a ``Mesh`` over its
devices on the axis ``"data"`` and ``shard_map`` runs one program per
device, with ``lax.psum`` closing a sum across them.  Torch has neither,
so a :class:`Mesh` here holds this process's shards as a tuple of
``torch.device`` (a device may repeat: four shards on ``cuda:0`` stand in
for JAX's virtual devices of one CPU, and ``["cpu"] * 8`` is the tests'
mesh) and, optionally, a ``torch.distributed`` process group whose other
ranks hold the other shards.  Shard ``i`` of rank ``r`` is global shard
``r · local + i`` of ``world · local``.

:meth:`Mesh.run` runs a function once per local shard, each on a thread of
its own, on its device and, on CUDA, on a stream of its own.  Inside it,
:meth:`Mesh.allsum` is the ``psum``: a rendezvous collects every local
shard's tensor, ONE sum is made in shard order (through
``dist.all_reduce`` across the group when there is one: Gloo on the CPU,
NCCL across GPUs), and a copy goes back to every shard.  So every shard
holds the same bits, which is what lets each shard's host take the same
branch on a reduced value.  A shard's exception, a shard that returns
while the others wait in a collective, or a collective that outlasts the
mesh's timeout aborts the rendezvous: the call raises in the caller
instead of hanging, and the threads are joined every time.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import torch

from orbslam2_tpu_torch.runtime import device as device_mod

DEFAULT_TIMEOUT_S = 300.0   # the longest wait at one collective


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_devices() -> List[torch.device]:
    """This process's CUDA devices (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class MeshAborted(RuntimeError):
    """A collective that cannot complete: another shard failed or left."""


class _Rendezvous:
    """The local shards' meeting point for one :meth:`Mesh.run`.

    The shards take turns: one runs (issues its work) from one collective
    to the next while the others wait, in shard order, and the last to
    arrive makes the sum.  Free-running, their threads contend for the
    GIL (each torch call drops and retakes it) and, on the CPU, for the
    intra-op threads (``tools/scaling.py --threads`` measures both
    modes; PERF.md §6).  On CUDA the card runs every shard's queued work
    meanwhile."""

    def __init__(self, n: int, timeout: float):
        self._cv = threading.Condition()
        self._n = n
        self._timeout = timeout
        self._slots: list = [None] * n
        self._count = 0
        self._gen = 0
        self._turn = 0
        self._left = 0
        self._out = None
        self._broken: Optional[str] = None

    def _wait(self, ready: Callable[[], bool]) -> None:
        """Wait until ``ready()``; raise if the rendezvous breaks."""
        if not self._cv.wait_for(lambda: ready() or self._broken is not None,
                                 self._timeout):
            self._break(f"a shard waited over {self._timeout} s")
        if self._broken is not None:
            raise MeshAborted(self._broken)

    def start(self, i: int) -> None:
        with self._cv:
            self._wait(lambda: self._turn == i)

    def exchange(self, i: int, value, reduce: Callable):
        """Hand in shard ``i``'s value; the last to arrive runs ``reduce``
        on the values in shard order.  Returns ``reduce``'s result, once
        it is shard ``i``'s turn again."""
        with self._cv:
            if self._broken is None and self._left:
                self._break("a shard returned before this collective")
            if self._broken is not None:
                raise MeshAborted(self._broken)
            gen = self._gen
            self._slots[i] = value
            self._count += 1
            if self._count == self._n:
                try:
                    out = reduce(self._slots)
                except BaseException as e:
                    self._break(f"the sum failed: {e!r}")
                    raise
                self._out = out
                self._slots = [None] * self._n
                self._count = 0
                self._gen += 1
                self._turn = 0
            else:
                self._turn = i + 1
            self._cv.notify_all()
            self._wait(lambda: self._gen != gen and self._turn == i)
            return self._out      # the next sum needs this shard: still ours

    def leave(self, i: int, reason: str, failed: bool) -> None:
        """Shard ``i`` returned or failed: no collective can complete
        without it, so break one that waits for it now (a later one
        raises); else the next shard takes its turn."""
        with self._cv:
            self._left += 1
            if failed or self._count > 0:
                self._break(reason)
            else:
                self._turn = i + 1
                self._cv.notify_all()

    def _break(self, reason: str) -> None:
        if self._broken is None:
            self._broken = reason
        self._cv.notify_all()


_local = threading.local()


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal shards compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _on(device: torch.device, stream):
    if stream is None:
        return contextlib.nullcontext()
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.cuda.device(device))
    ctx.enter_context(torch.cuda.stream(stream))
    return ctx


class Mesh:
    """This process's shards (``devices``) and, optionally, the process
    ``group`` that holds the others (see the module docstring)."""

    def __init__(self, devices: Sequence, group=None,
                 timeout: float = DEFAULT_TIMEOUT_S):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.timeout = timeout
        if group is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1
        self._streams: Optional[list] = None

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards in all, across the group."""
        return self.world * self.n_local

    def shard_index(self, i: int) -> int:
        """Global index of local shard ``i``."""
        return self.rank * self.n_local + i

    def _shard_streams(self) -> list:
        if self._streams is None:
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices]
        return self._streams

    def run(self, fn: Callable, *per_shard_args: Sequence) -> list:
        """``fn(*args_i)`` for every local shard ``i`` (``args_i`` the
        ``i``-th entry of each of ``per_shard_args``), each on a thread
        of its own on its device and stream; returns the results in
        shard order, handed to the caller's streams.  Tensors in the
        arguments are handed to the shard's stream from the caller's."""
        n = self.n_local
        for a in per_shard_args:
            if len(a) != n:
                raise ValueError(f"{len(a)} arguments for {n} shards")
        streams = self._shard_streams()
        ready = {d: device_mod.mark(d) for d in set(self.devices)}
        rv = _Rendezvous(n, self.timeout)
        results: list = [None] * n
        errors: list = [None] * n

        def body(i: int) -> None:
            _local.ctx = (self, rv, i)
            dev = self.devices[i]
            try:
                rv.start(i)
                with _on(dev, streams[i]):
                    args = [a[i] for a in per_shard_args]
                    device_mod.handoff(args, ready[dev])
                    out = fn(*args)
                    results[i] = (out, device_mod.mark(dev))
                rv.leave(i, f"local shard {i} returned while others wait "
                         "at a collective", failed=False)
            except BaseException as e:   # the shard's boundary: raised in
                errors[i] = e            # the caller after the join
                rv.leave(i, f"local shard {i} raised {e!r}", failed=True)
            finally:
                _local.ctx = None

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"mesh-shard-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors
                      if e is not None and not isinstance(e, MeshAborted)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return [device_mod.handoff(out, done) for out, done in results]

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        """Inside :meth:`run`: the sum of ``x`` over every shard of the
        mesh, the same bits on each (``lax.psum``)."""
        ctx = getattr(_local, "ctx", None)
        if ctx is None or ctx[0] is not self:
            raise RuntimeError("Mesh.allsum outside Mesh.run")
        _, rv, i = ctx
        out = rv.exchange(i, (x, device_mod.mark(x.device)), self._sum)
        mine, done = out[i]
        return device_mod.handoff(mine, done)

    def _sum(self, slots) -> list:
        """The one sum, in shard order, on local shard 0's device and
        stream; then across the group; then a copy for every shard."""
        dev0 = self.devices[0]
        streams = self._shard_streams()
        with _on(dev0, streams[0]):
            acc = None
            for x, ev in slots:
                device_mod.handoff(x, ev)
                x = x.to(dev0)
                acc = x.clone() if acc is None else acc + x
            if self.group is not None:
                import torch.distributed as dist
                dist.all_reduce(acc, group=self.group)
            outs = [acc.to(d, copy=True) for d in self.devices]
            done = device_mod.mark(dev0)
        return [(o, done) for o in outs]


def make_mesh(devices: Optional[Sequence] = None, group=None,
              timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A mesh over ``devices`` (by default every local CUDA device; there
    is no quiet CPU mesh: pass ``["cpu"] * n`` for one)."""
    if devices is None:
        devices = local_devices()
        if not devices:
            raise RuntimeError("make_mesh: torch finds no CUDA device; pass "
                               "the shards' devices, e.g. [\"cpu\"] * 8")
    return Mesh(devices, group=group, timeout=timeout)


def auto_mesh(device) -> Optional[Mesh]:
    """The engines' rule, JAX's ``device_count() > 1``: a mesh over every
    local CUDA device where there is more than one and ``device`` is a
    CUDA device; else None (one card, or the CPU).  ``device`` is shard 0,
    the others follow in order, so the component's results land on its
    own card."""
    local = local_devices()
    if torch.device(device).type != "cuda" or len(local) < 2:
        return None
    own = _indexed(torch.device(device))
    return make_mesh([own] + [d for d in local if d != own])
