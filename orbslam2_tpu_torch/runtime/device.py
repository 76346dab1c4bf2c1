"""Where the port's stateful entry points (``SlamEngine``, ``LoopCloser``)
run: on the CUDA card unless the caller asks for another device."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as given; by default the CUDA card.  With no CUDA device
    and none asked for, raise: an entry point never carries on on the CPU
    unless told to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "orbslam2_tpu_torch runs on a CUDA device by default and torch "
            "finds none; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _tensors(obj):
    """The tensors in ``obj``: a tensor, or tuples (named ones too), lists
    and dicts of them, nested."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def mark(device, stream=None):
    """An event recorded on ``stream`` (by default the calling thread's
    current stream) of a CUDA ``device``: it completes once the work
    queued there so far has run.  None for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device) if stream is None
                 else stream)
    return event


def handoff(obj, event):
    """Hand the tensors of ``obj``, made on another CUDA stream up to
    ``event`` (from :func:`mark`), to the calling thread's current stream:
    that stream waits on the event, and each tensor is marked as used on it
    (``record_stream``), so that the caching allocator gives its block to
    no new tensor of the producer's stream while this one may still read
    it.  PyTorch's side streams do not synchronise with the default
    stream.  Nothing to do when ``event`` is None (the CPU).  The stream
    is that of the first tensor's device; tensors on other devices (the
    blocks of a DB sharded over several cards) stay with their own
    devices' streams."""
    if event is None:
        return obj
    ts = [t for t in _tensors(obj) if t.is_cuda]
    stream = torch.cuda.current_stream(ts[0].device if ts else None)
    stream.wait_event(event)
    for t in ts:
        if t.device == stream.device:
            t.record_stream(stream)
    return obj
