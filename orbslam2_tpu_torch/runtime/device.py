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
