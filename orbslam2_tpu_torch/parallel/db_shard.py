"""The keyframe database sharded by rows over a mesh.

Port of ``orbslam2_tpu/parallel/db_shard.py``.  The database is a dense
[K, W] BoW matrix (``models/keyframe_db.py``); its rows are cut into one
block of K/D rows a shard (K padded up to a multiple of D with rows that
are never valid), each block a ``KeyFrameDB`` on its shard's device.  A
query is a [K/D, W]·[W] product on each block, the [K] scores gathered
in shard order on the database's home device, the dense database's
device and so the loop closer's, where the map lies (across a process
group, one sum of zero-filled [K] vectors: the only traffic a query
makes); the covisibility-group accumulation runs on [K]-sized objects
there, through the same ``keyframe_db.detect_candidates`` as the dense
database.
``ShardedKeyFrameDB`` answers ``add``, ``erase``, ``valid`` and
``scores`` as ``KeyFrameDB`` does, so every reader of a loop closer's
``db`` takes either; ``gathered()`` is the dense database (``save_map``
writes it, so the file format does not change).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from orbslam2_tpu_torch.models import keyframe_db as db_mod
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.parallel.mesh import Mesh, pad_to_multiple


class ShardedKeyFrameDB(NamedTuple):
    mesh: Mesh
    blocks: Tuple[db_mod.KeyFrameDB, ...]   # this process's shards, in order
    n_rows: int                             # K
    home: torch.device                      # where gathered results land

    def _locate(self, kf) -> Optional[Tuple[int, int]]:
        """(local shard, row in its block) of keyframe row ``kf``, None
        where another rank owns it."""
        d, r = divmod(int(kf), self.blocks[0].bow.shape[0])
        i = d - self.mesh.rank * self.mesh.n_local
        return (i, r) if 0 <= i < self.mesh.n_local else None

    def _with_block(self, kf, f) -> "ShardedKeyFrameDB":
        at = self._locate(kf)
        if at is None:
            return self
        i, r = at
        blocks = list(self.blocks)
        blocks[i] = f(blocks[i], r)
        return self._replace(blocks=tuple(blocks))

    def add(self, kf, vec: torch.Tensor) -> "ShardedKeyFrameDB":
        return self._with_block(
            kf, lambda b, r: b.add(r, vec.to(b.bow.device)))

    def erase(self, kf) -> "ShardedKeyFrameDB":
        return self._with_block(kf, lambda b, r: b.erase(r))

    def _gather(self, parts) -> torch.Tensor:
        """Per-block [R, ...] tensors → [K, ...] on the home device, in
        shard order."""
        out = torch.cat([p.to(self.home) for p in parts])
        mesh = self.mesh
        if mesh.group is not None:
            import torch.distributed as dist
            full = out.new_zeros((mesh.world * out.shape[0],)
                                 + tuple(out.shape[1:]))
            full[mesh.rank * out.shape[0]:(mesh.rank + 1) * out.shape[0]] = out
            dist.all_reduce(full, group=mesh.group)
            out = full
        return out[:self.n_rows]

    @property
    def valid(self) -> torch.Tensor:
        return self._gather([b.valid.to(torch.int32)
                             for b in self.blocks]) > 0

    def scores(self, vec: torch.Tensor) -> torch.Tensor:
        """[K] BoW similarity of every row to ``vec``: one [K/D, W]
        product a shard."""
        return self._gather([b.scores(vec.to(b.bow.device))
                             for b in self.blocks])

    def gathered(self) -> db_mod.KeyFrameDB:
        """The dense [K, W] database on the home device."""
        return db_mod.KeyFrameDB(
            bow=self._gather([b.bow for b in self.blocks]), valid=self.valid)


def shard_db(mesh: Mesh, db) -> ShardedKeyFrameDB:
    """Lay the rows of ``db`` (a ``KeyFrameDB``, or a sharded one) out
    over ``mesh``; gathered results come back to ``db``'s device."""
    if isinstance(db, ShardedKeyFrameDB):
        if db.mesh is mesh:
            return db
        db = db.gathered()
    K = db.bow.shape[0]
    R = pad_to_multiple(K, mesh.size) // mesh.size
    pad = R * mesh.size - K
    bow = torch.cat([db.bow, db.bow.new_zeros((pad, db.bow.shape[1]))])
    valid = torch.cat([db.valid, db.valid.new_zeros((pad,))])
    blocks = []
    for i, dev in enumerate(mesh.devices):
        rows = slice(mesh.shard_index(i) * R, (mesh.shard_index(i) + 1) * R)
        blocks.append(db_mod.KeyFrameDB(bow=bow[rows].to(dev, copy=True),
                                        valid=valid[rows].to(dev, copy=True)))
    return ShardedKeyFrameDB(mesh=mesh, blocks=tuple(blocks), n_rows=K,
                             home=db.bow.device)


def detect_candidates_sharded(mesh: Mesh, db, ms: M.MapState,
                              query_bow: torch.Tensor, query_kf: int,
                              min_score, n_candidates: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DetectLoopCandidates on the sharded database: the same results as
    ``keyframe_db.detect_candidates`` on the dense one."""
    return db_mod.detect_candidates(shard_db(mesh, db), ms, query_bow,
                                    query_kf, min_score, n_candidates)
