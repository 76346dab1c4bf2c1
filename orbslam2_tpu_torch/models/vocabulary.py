"""Hierarchical binary-descriptor vocabulary: the loading half.

Port of the ``Vocabulary`` tuple and the loading half of
``default_vocabulary`` in ``orbslam2_tpu/models/vocabulary.py``.  Level d
holds k^(d+1) centroids; the children of node n are rows n·k … n·k+k−1 of
level d+1's table, and leaf ids at level L are word ids in [0, k^L).

The centroids are the JAX package's uint32 words as int32 (same bits, the
port's descriptor layout).  Building a vocabulary (harvesting descriptors,
k-majority clustering) is not ported: the loader reads the prebuilt
``data/vocab_k{k}_l{levels}.npz`` and raises when it is missing — it never
rebuilds.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "data")
DEFAULT_K = 10
DEFAULT_LEVELS = 4


class Vocabulary(NamedTuple):
    centroids: Tuple[torch.Tensor, ...]  # per level: [k^(d+1), 8] int32
    idf: torch.Tensor                    # [k^L] float32
    k: int
    levels: int

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    def to(self, device) -> "Vocabulary":
        return self._replace(
            centroids=tuple(c.to(device) for c in self.centroids),
            idf=self.idf.to(device))


def from_numpy(centroids, idf, k: int, levels: int, device=None
               ) -> Vocabulary:
    """uint32 centroid tables + idf (the JAX layout) → a Vocabulary."""
    cents = tuple(torch.from_numpy(np.ascontiguousarray(
        np.asarray(c, np.uint32)).view(np.int32).copy()).to(device)
        for c in centroids)
    return Vocabulary(centroids=cents,
                      idf=torch.as_tensor(np.asarray(idf, np.float32),
                                          device=device),
                      k=int(k), levels=int(levels))


def default_vocabulary(k: int = DEFAULT_K, levels: int = DEFAULT_LEVELS,
                       device=None) -> Vocabulary:
    """Load the prebuilt default vocabulary onto ``device``."""
    path = os.path.abspath(os.path.join(DATA_DIR,
                                        f"vocab_k{k}_l{levels}.npz"))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"vocabulary {path} is missing; the port loads the prebuilt "
            f"tree and does not build one")
    z = np.load(path)
    lv = int(z["levels"])
    return from_numpy([z[f"cent{d}"] for d in range(lv)], z["idf"],
                      int(z["k"]), lv, device)
