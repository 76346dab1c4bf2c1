"""Keyframe database: place-recognition queries as dense masked products.

Port of ``orbslam2_tpu/models/keyframe_db.py``: a dense [K, n_words] BoW
matrix stands for KeyFrameDatabase's inverted file, so a loop or
relocalization query is one FP32 matvec (TF32 off, the package default:
JAX's "highest" precision) plus covisibility-group accumulation over a
bounded candidate pool.  Every ``lax.top_k`` goes through ``index.topk``,
which keeps JAX's tie order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.utils.index import topk


class KeyFrameDB(NamedTuple):
    bow: torch.Tensor      # [K, W] float32 — L2-normalised tf-idf rows
    valid: torch.Tensor    # [K] bool — registered (KeyFrameDatabase::add)

    @staticmethod
    def empty(max_keyframes: int, n_words: int, device=None) -> "KeyFrameDB":
        return KeyFrameDB(
            bow=torch.zeros((max_keyframes, n_words), dtype=torch.float32,
                            device=device),
            valid=torch.zeros(max_keyframes, dtype=torch.bool,
                              device=device))

    def add(self, kf: int, vec: torch.Tensor) -> "KeyFrameDB":
        return KeyFrameDB(bow=M._set_row(self.bow, kf, vec),
                          valid=M._set_row(self.valid, kf, True))

    def erase(self, kf: int) -> "KeyFrameDB":
        return self._replace(valid=M._set_row(self.valid, kf, False))


CAND_POOL = 32  # min score-gated candidates entering group accumulation


def _cand_pool(K: int) -> int:
    """Pool size scaled with map capacity: K/8, at least CAND_POOL."""
    return min(max(CAND_POOL, K // 8), K)


def group_accumulated_scores(cscore: torch.Tensor, w_cand: torch.Tensor,
                             cok: torch.Tensor, top_n: int = 10
                             ) -> torch.Tensor:
    """Covisibility-group score accumulation (KeyFrameDatabase.cc:145-171)
    over the candidate pool: each candidate's group is itself plus its
    top-10 covisible neighbours in the pool.  Returns acc [C]."""
    C = cscore.shape[0]
    n = min(top_n, C)
    dev = cscore.device
    w = torch.where(cok[None, :], w_cand, -1)
    topw, topi = topk(w, n)                                    # [C, n]
    member = torch.zeros((C, C + 1), dtype=torch.bool, device=dev)
    member.scatter_(1, torch.where(topw > 0, topi, C), True)
    member = member[:, :C]
    ar = torch.arange(C, device=dev)
    member[ar, ar] = True
    s = torch.where(cok, cscore, 0.0)
    return member.to(torch.float32) @ s


def detect_candidates(db: KeyFrameDB, ms: M.MapState,
                      query_bow: torch.Tensor, query_kf: int,
                      min_score, n_candidates: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared core of DetectLoopCandidates / DetectRelocalizationCandidates.

    Loop mode (``query_kf`` ≥ 0): exclude the query and everything
    covisible with it, gate by ``min_score``.  Relocalization: query_kf −1
    and min_score 0.  Returns (candidate kf ids [n_candidates] int64,
    scores), −1 padded."""
    K = db.bow.shape[0]
    dev = db.bow.device
    scores = db.bow @ query_bow                               # [K]
    ok = db.valid & ms.kf_valid
    if query_kf >= 0:
        q_row = M.covisibility_row(ms, query_kf)
        connected = (q_row > 0) | (torch.arange(K, device=dev) == query_kf)
        ok = ok & ~connected
    ok = ok & (scores >= min_score)

    C = _cand_pool(K)
    cscore, cids = topk(torch.where(ok, scores, -1.0), C)
    cok = cscore > 0
    w_rows = M.covisibility_rows(ms, torch.where(cok, cids, 0))   # [C, K]
    w_cand = torch.gather(w_rows, 1, cids[None, :].expand(C, C))  # [C, C]

    acc = group_accumulated_scores(cscore, w_cand, cok)
    best_acc = torch.max(torch.where(cok, acc, 0.0))
    group_ok = cok & (acc >= 0.75 * best_acc)
    cand_score = torch.where(group_ok, cscore, -1.0)
    nc = min(n_candidates, C)
    top_s, top_i = topk(cand_score, nc)
    cand_ids = torch.where(top_s > 0, cids[top_i], -1)
    if n_candidates > nc:
        pad = n_candidates - nc
        cand_ids = torch.cat([cand_ids, torch.full(
            (pad,), -1, dtype=cand_ids.dtype, device=dev)])
        top_s = torch.cat([top_s, torch.full((pad,), -1.0, device=dev)])
    return cand_ids, top_s
