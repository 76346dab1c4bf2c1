"""Map checkpoint/resume, in the JAX package's file format.

Port of ``orbslam2_tpu/runtime/serialization.py:25-46``, which replaces
``System::SaveMap/LoadMap`` (System.cc:831-874: boost serialization of
the whole pointer graph, KeyFrame.cc:671-741).  The map is already
arrays, so a checkpoint is one ``np.savez_compressed`` of

  * ``ms_<field>`` for every ``MapState`` field, in the JAX dtypes
    (descriptor words as uint32; the port holds them as int32, the same
    bits: ``convert.to_numpy`` / ``convert.to_tensor``);
  * ``db_bow`` and ``db_valid``, the keyframe DB, when there is one;
  * ``counters_json``, the engine counters as JSON bytes (uint8).

A file written by either package loads in the other.  As in the
reference, the vocabulary is not stored (System.cc:862-869 re-attaches
it on load).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import keyframe_db as db_mod
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.runtime import device as device_mod


def save_map(path: str, ms: M.MapState, db: Optional[db_mod.KeyFrameDB],
             counters: dict) -> None:
    """Write ``ms``, ``db`` and ``counters`` (plain ints) to ``path``."""
    arrays = {f"ms_{k}": v for k, v in convert.to_numpy(ms).items()}
    if db is not None:
        d = convert.to_numpy(db)
        arrays["db_bow"] = d["bow"]
        arrays["db_valid"] = d["valid"]
    counters = {k: int(v) for k, v in counters.items()}
    arrays["counters_json"] = np.frombuffer(
        json.dumps(counters).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device=None
             ) -> Tuple[M.MapState, Optional[db_mod.KeyFrameDB], dict]:
    """(MapState, KeyFrameDB or None, counters) from ``path``, the tensors
    on ``device``: the CUDA card unless another is named
    (``device="cpu"``)."""
    dev = device_mod.resolve(device)
    with np.load(path) as z:
        ms = convert.map_state_from_numpy(
            {k: z[f"ms_{k}"] for k in M.MapState._fields}, dev)
        db = None
        if "db_bow" in z:
            db = convert.keyframe_db_from_numpy(
                {"bow": z["db_bow"], "valid": z["db_valid"]}, dev)
        counters = json.loads(bytes(z["counters_json"]).decode())
    return ms, db, counters
