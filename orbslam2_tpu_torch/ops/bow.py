"""Bag-of-words transform and scoring.

Port of ``orbslam2_tpu/ops/bow.py``: word assignment is a per-level
gather + Hamming argmin over the k children (first index on ties, as
``jnp.argmin``), tf-idf vectors are dense [n_words] tensors, similarity
is a dot product.  Invalid features map to the sentinel word ``n_words``,
whose count ``index.scatter_add`` drops as JAX drops the out-of-bounds
``.at[].add``.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch.models.vocabulary import Vocabulary
from orbslam2_tpu_torch.ops.hamming import popcount32
from orbslam2_tpu_torch.utils.index import scatter_add


def descriptors_to_words(voc: Vocabulary, desc: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words → [N] int64 word ids (invalid → n_words)."""
    n = desc.shape[0]
    dev = desc.device
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    ar = torch.arange(voc.k, device=dev)
    for d in range(voc.levels):
        child_ids = node[:, None] * voc.k + ar                   # [N, k]
        cand = voc.centroids[d][child_ids]                       # [N, k, 8]
        dist = torch.sum(popcount32(desc[:, None, :] ^ cand), dim=-1)
        node = torch.gather(child_ids, 1,
                            torch.argmin(dist, dim=-1, keepdim=True))[:, 0]
    return torch.where(valid, node, voc.n_words)


def bow_vector(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor
               ) -> torch.Tensor:
    """[N, 8] descriptors → L2-normalised tf-idf vector [n_words]."""
    words = descriptors_to_words(voc, desc, valid)
    counts = scatter_add(torch.zeros(voc.n_words, dtype=torch.float32,
                                     device=desc.device), words,
                         valid.to(torch.float32))
    tf = counts / torch.clamp(torch.sum(counts), min=1.0)
    v = tf * voc.idf
    norm = torch.linalg.vector_norm(v)
    return v / torch.where(norm < 1e-12, torch.ones_like(norm), norm)


def score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Similarity of two normalised BoW vectors in [0, 1]."""
    return torch.dot(a, b)
