"""Carry state between the JAX package and the port as numpy dicts.

The SLAM system has no weights: its carried-over state is the map
(``MapState``), the frame (``FrameData``) and the config.  These helpers
take and return plain ``{field: np.ndarray}`` dicts, e.g.
``{k: np.asarray(v) for k, v in ms._asdict().items()}`` of a JAX
``MapState``, so both packages can be given the same inputs.

Descriptor words are uint32 in the JAX package and int32 here (same bit
pattern, ``np.uint32`` ↔ ``.view(np.int32)``): torch on the CPU has no
``>>`` and no popcount for uint32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from orbslam2_tpu_torch.models.frame import FrameData
from orbslam2_tpu_torch.models.map_state import MapState

DESC_FIELDS = frozenset({"desc", "kf_desc", "mp_desc", "mp_desc_ring"})


def to_tensor(a, device=None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def map_state_from_numpy(d: Dict[str, np.ndarray], device=None) -> MapState:
    return MapState(**{k: to_tensor(d[k], device) for k in MapState._fields})


def frame_data_from_numpy(d: Dict[str, np.ndarray], device=None
                          ) -> FrameData:
    return FrameData(**{k: to_tensor(d[k], device) for k in FrameData._fields})


def to_numpy(nt: NamedTuple) -> Dict[str, np.ndarray]:
    """NamedTuple of tensors → dict of numpy arrays in the JAX package's
    dtypes (descriptor words back to uint32)."""
    out = {}
    for k, v in nt._asdict().items():
        arr = v.detach().cpu().numpy()
        out[k] = arr.view(np.uint32) if k in DESC_FIELDS else arr
    return out
