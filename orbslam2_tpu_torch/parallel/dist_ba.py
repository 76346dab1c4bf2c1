"""Global bundle adjustment sharded by point block over a mesh.

Port of ``orbslam2_tpu/parallel/dist_ba.py``.  Points are cut into
contiguous blocks, one a shard, and every observation goes to the shard
that owns its point (a stable counting sort on the host, once a solve:
``_partition_by_point``, a copy of JAX's numpy).  Each shard then runs
the same LM/CG schedule of ``ops/bundle.bundle_adjust(allsum=...)`` on
its own observations and point block (``parallel/mesh.Mesh.run``): the
point-side segment sums stay local, the poses are replicated, and each
camera-side sum closes with one ``Mesh.allsum`` — per LM iteration Hcc,
g_c, the CG rhs and block diagonal and the trial cost, per CG step one
[C, 6] sum (``collectives_accounting``).  The reduced system is the same
bits on every shard, so every shard takes the same LM branches and ends
with the same poses.  The inlier mask comes back in the original
observation order through one [O] allsum, and the points in full on
every shard (and every rank of a group) through one allsum of
zero-filled blocks.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.ops import bundle
from orbslam2_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
from orbslam2_tpu_torch.utils import camera as cam_mod


def collectives_accounting(lm_iters: int, cg_iters: int, C: int) -> Dict:
    """Closed-form collective count/volume per sharded bundle_adjust call."""
    per_lm = cg_iters + 3 + 1          # matvec psums + (Hcc, g_c, diagS) + cost
    return {
        "psums_per_lm_iter": per_lm,
        "psum_bytes_per_cg_iter": 24 * C,
        "psums_total": lm_iters * per_lm + 2,   # +2 outlier-pass relinearize
    }


def _partition_by_point(prob: bundle.BAProblem, n_dev: int):
    """Route observations to the device owning their point (stable
    counting sort on the host).  Returns (obs_dict, flat_src, P_pad, O_loc)
    where obs_dict holds [n_dev·O_loc] reordered observation arrays and
    flat_src maps padded row → original observation index (−1 = padding).
    """
    O = int(prob.cam_i.shape[0])
    Pn = int(prob.points.shape[0])
    P_pad = pad_to_multiple(Pn, n_dev)
    P_loc = P_pad // n_dev
    pt_i = np.asarray(prob.pt_i)
    dev = np.clip(pt_i, 0, Pn - 1) // P_loc
    order = np.argsort(dev, kind="stable")
    counts = np.bincount(dev, minlength=n_dev)
    O_loc = int(pad_to_multiple(max(int(counts.max()), 1), 8))
    flat_src = np.full((n_dev, O_loc), -1, np.int64)
    off = 0
    for d in range(n_dev):
        c = int(counts[d])
        flat_src[d, :c] = order[off:off + c]
        off += c
    flat_src = flat_src.reshape(-1)
    take = np.maximum(flat_src, 0)

    def g(x):
        return np.asarray(x)[take]

    valid = np.where(flat_src >= 0, g(prob.valid), False)
    obs = {
        "cam_i": g(prob.cam_i).astype(np.int32),
        "pt_i": g(prob.pt_i).astype(np.int32),
        "uv": g(prob.uv).astype(np.float32),
        "ur": g(prob.ur).astype(np.float32),
        "inv_sigma2": g(prob.inv_sigma2).astype(np.float32),
        "valid": valid,
    }
    return obs, flat_src, P_pad, O_loc


def _on_host(prob: bundle.BAProblem) -> bundle.BAProblem:
    return bundle.BAProblem(*(t.detach().cpu().numpy() for t in prob))


def shard_bundle_adjust(mesh: Mesh, cam: cam_mod.Camera,
                        prob: bundle.BAProblem, n_free: int,
                        iters_a: int = 5, iters_b: int = 10,
                        fix_first_free: bool = False, cg_iters: int = 48
                        ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
    """Every local shard's (poses, points [P], obs_inlier [O]), in shard
    order, each on its shard's device: the poses are the same bits on
    every shard, the points and the mask in the original order."""
    n_dev = mesh.size
    O = int(prob.cam_i.shape[0])
    Pn = int(prob.points.shape[0])
    host = _on_host(prob)
    obs, flat_src, P_pad, O_loc = _partition_by_point(host, n_dev)
    P_loc = P_pad // n_dev
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:Pn] = host.points
    pv = np.zeros((P_pad,), bool)
    pv[:Pn] = host.point_valid

    shards = []
    for i, dev in enumerate(mesh.devices):
        d = mesh.shard_index(i)
        rows = slice(d * O_loc, (d + 1) * O_loc)
        blk = slice(d * P_loc, (d + 1) * P_loc)
        pt_i = obs["pt_i"][rows].astype(np.int64)
        # as dist_ba.py:108-113: local point indices, observations of
        # points another shard owns masked out
        owned = (pt_i >= d * P_loc) & (pt_i < (d + 1) * P_loc)
        local = np.clip(pt_i - d * P_loc, 0, P_loc - 1)

        def put(a, dev=dev):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        shards.append((d, bundle.BAProblem(
            poses=prob.poses.to(dev), points=put(pts[blk]),
            point_valid=put(pv[blk]),
            cam_i=put(obs["cam_i"][rows].astype(np.int64)), pt_i=put(local),
            uv=put(obs["uv"][rows]), ur=put(obs["ur"][rows]),
            inv_sigma2=put(obs["inv_sigma2"][rows]),
            valid=put(obs["valid"][rows] & owned)),
            put(flat_src[rows])))

    def kernel(shard):
        d, p, src = shard
        poses, points, inlier = bundle.bundle_adjust(
            cam, p, n_free, iters_a=iters_a, iters_b=iters_b,
            fix_first_free=fix_first_free, solver="cg", cg_iters=cg_iters,
            allsum=mesh.allsum)
        # un-permute the inlier mask (one [O] sum): row → its original
        # observation index; padding rows (src < 0) are dropped
        inl = torch.zeros(O + 1, dtype=torch.int32, device=src.device)
        inl[torch.where(src >= 0, src, O)] = inlier.to(torch.int32)
        inl = mesh.allsum(inl[:O]) > 0
        full = torch.zeros((P_pad, 3), dtype=points.dtype,
                           device=points.device)
        full[d * P_loc:(d + 1) * P_loc] = points
        return poses, mesh.allsum(full)[:Pn], inl

    return mesh.run(kernel, shards)


def distributed_bundle_adjust(
    mesh: Mesh,
    cam: cam_mod.Camera,
    prob: bundle.BAProblem,
    n_free: int,
    iters_a: int = 5,
    iters_b: int = 10,
    fix_first_free: bool = False,
    solver: str = "cg",
    cg_iters: int = 48,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (poses, points, obs_inlier [O]), in the original order, on
    the mesh's first device (see the module docstring)."""
    if solver != "cg":
        raise ValueError("distributed BA is CG-Schur only")
    poses, points, inlier = shard_bundle_adjust(
        mesh, cam, prob, n_free, iters_a=iters_a, iters_b=iters_b,
        fix_first_free=fix_first_free, cg_iters=cg_iters)[0]
    return poses, points, inlier
