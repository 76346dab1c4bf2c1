"""The map as fixed-capacity tensors with functional updates.

Port of ``orbslam2_tpu/models/map_state.py``.  Every update returns a new
``MapState`` whose changed fields are fresh tensors — the JAX semantics,
which the engine relies on when it keeps a snapshot across a frame.
JAX drops out-of-bounds scatter writes and the map code masks rows that
way; here every masked scatter goes through ``utils/index.py`` (a dump
row that is sliced off).  Duplicate targets of a ``set``: the last
source wins (``index.scatter_set``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.ops.hamming import popcount32
from orbslam2_tpu_torch.utils.index import mask_of, scatter_add, scatter_set

NO_MP = -1
DESC_RING = 4   # recent observation descriptors kept per map point


class MapState(NamedTuple):
    # ----- keyframes [K, ...] -----
    kf_pose: torch.Tensor        # [K, 4, 4] Tcw
    kf_valid: torch.Tensor       # [K] bool
    kf_frame_id: torch.Tensor    # [K] int32
    kf_timestamp: torch.Tensor   # [K] float32
    kf_xy: torch.Tensor          # [K, N, 2]
    kf_level: torch.Tensor       # [K, N] int32
    kf_angle: torch.Tensor       # [K, N] float32
    kf_desc: torch.Tensor        # [K, N, 8] int32 words (uint32 bits)
    kf_kp_valid: torch.Tensor    # [K, N] bool
    kf_ur: torch.Tensor          # [K, N] float32
    kf_depth: torch.Tensor       # [K, N] float32
    kf_mp: torch.Tensor          # [K, N] int32 feature → map point (−1)
    kf_parent: torch.Tensor      # [K] int32 spanning-tree parent (−1)
    # ----- map points [P, ...] -----
    mp_pos: torch.Tensor         # [P, 3]
    mp_valid: torch.Tensor       # [P] bool
    mp_desc: torch.Tensor        # [P, 8] int32
    mp_desc_ring: torch.Tensor   # [P, DESC_RING, 8] int32
    mp_desc_n: torch.Tensor      # [P] int32
    mp_normal_sum: torch.Tensor  # [P, 3]
    mp_n_obs: torch.Tensor       # [P] int32
    mp_min_dist: torch.Tensor    # [P]
    mp_max_dist: torch.Tensor    # [P]
    mp_ref_kf: torch.Tensor      # [P] int32
    mp_first_kf: torch.Tensor    # [P] int32
    mp_visible: torch.Tensor     # [P] int32
    mp_found: torch.Tensor       # [P] int32

    @property
    def K(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def N(self) -> int:
        return self.kf_xy.shape[1]

    @property
    def P(self) -> int:
        return self.mp_pos.shape[0]

    def mp_normal(self) -> torch.Tensor:
        s = self.mp_normal_sum
        return s / torch.clamp(torch.linalg.vector_norm(s, dim=-1,
                                                        keepdim=True),
                               min=1e-9)

    def kf_center(self) -> torch.Tensor:
        """[K, 3] camera centres Ow = −Rᵀt."""
        R = self.kf_pose[:, :3, :3]
        t = self.kf_pose[:, :3, 3]
        return -torch.einsum("kji,kj->ki", R, t)


def empty_map(cfg: SlamConfig, device=None) -> MapState:
    K = cfg.capacity.max_keyframes
    N = cfg.orb.n_features_padded
    P = cfg.capacity.max_map_points
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return MapState(
        kf_pose=torch.eye(4, device=device).repeat(K, 1, 1),
        kf_valid=z(K, dtype=torch.bool), kf_frame_id=z(K, dtype=i32),
        kf_timestamp=z(K), kf_xy=z(K, N, 2), kf_level=z(K, N, dtype=i32),
        kf_angle=z(K, N), kf_desc=z(K, N, 8, dtype=i32),
        kf_kp_valid=z(K, N, dtype=torch.bool),
        kf_ur=full((K, N), -1.0, f32), kf_depth=full((K, N), -1.0, f32),
        kf_mp=full((K, N), NO_MP, i32), kf_parent=full((K,), -1, i32),
        mp_pos=z(P, 3), mp_valid=z(P, dtype=torch.bool),
        mp_desc=z(P, 8, dtype=i32), mp_desc_ring=z(P, DESC_RING, 8, dtype=i32),
        mp_desc_n=z(P, dtype=i32), mp_normal_sum=z(P, 3),
        mp_n_obs=z(P, dtype=i32), mp_min_dist=z(P), mp_max_dist=z(P),
        mp_ref_kf=z(P, dtype=i32), mp_first_kf=z(P, dtype=i32),
        mp_visible=z(P, dtype=i32), mp_found=z(P, dtype=i32))


def _set_row(t: torch.Tensor, row, value) -> torch.Tensor:
    out = t.clone()
    out[row] = value
    return out


def add_keyframe(ms: MapState, slot, Tcw, frame_id, timestamp, xy, level,
                 angle, desc, kp_valid, ur, depth, kp_mp, parent) -> MapState:
    """Write a keyframe into row ``slot`` (KeyFrame ctor)."""
    return ms._replace(
        kf_pose=_set_row(ms.kf_pose, slot, Tcw),
        kf_valid=_set_row(ms.kf_valid, slot, True),
        kf_frame_id=_set_row(ms.kf_frame_id, slot, frame_id),
        kf_timestamp=_set_row(ms.kf_timestamp, slot, timestamp),
        kf_xy=_set_row(ms.kf_xy, slot, xy),
        kf_level=_set_row(ms.kf_level, slot, level),
        kf_angle=_set_row(ms.kf_angle, slot, angle),
        kf_desc=_set_row(ms.kf_desc, slot, desc),
        kf_kp_valid=_set_row(ms.kf_kp_valid, slot, kp_valid),
        kf_ur=_set_row(ms.kf_ur, slot, ur),
        kf_depth=_set_row(ms.kf_depth, slot, depth),
        kf_mp=_set_row(ms.kf_mp, slot, kp_mp.to(torch.int32)),
        kf_parent=_set_row(ms.kf_parent, slot, parent))


def add_observations(ms: MapState, kf, feat_idx: torch.Tensor,
                     mp_idx: torch.Tensor, ok: torch.Tensor,
                     scale_factor: float, n_levels: int) -> MapState:
    """Associate features of keyframe ``kf`` with map points and update the
    incremental statistics (MapPoint::AddObservation +
    UpdateNormalAndDepth + ComputeDistinctiveDescriptors over a
    DESC_RING-deep ring).  Rows with ok=False are ignored."""
    feat_idx = feat_idx.long()
    mp_idx = mp_idx.long()
    mp_safe = torch.where(ok, mp_idx, 0)
    f_safe = torch.where(ok, feat_idx, 0)
    kf_mp = _set_row(ms.kf_mp, kf, scatter_set(ms.kf_mp[kf], feat_idx,
                                               mp_idx, ok))

    center = ms.kf_center()[kf]
    ray = ms.mp_pos[mp_safe] - center
    dist = torch.linalg.vector_norm(ray, dim=-1)
    unit = ray / torch.clamp(dist[:, None], min=1e-9)
    normal_sum = scatter_add(ms.mp_normal_sum, mp_idx, unit, ok)
    inc = torch.where(ms.kf_ur[kf][f_safe] >= 0, 2, 1).to(torch.int32)
    n_obs = scatter_add(ms.mp_n_obs, mp_idx, inc, ok)
    lvl = ms.kf_level[kf][f_safe].to(torch.float32)
    maxd = dist * torch.pow(scale_factor, lvl)
    mind = maxd / (scale_factor ** (n_levels - 1))
    max_dist = scatter_set(ms.mp_max_dist, mp_idx, maxd, ok)
    min_dist = scatter_set(ms.mp_min_dist, mp_idx, mind, ok)

    # distinctive descriptor: the ring slot with the least median Hamming
    # distance to the other stored slots (self-distance 0 included)
    new_desc = ms.kf_desc[kf][f_safe]                       # [n, 8]
    cnt = ms.mp_desc_n[mp_safe].long()
    P = ms.P
    ring = scatter_set(ms.mp_desc_ring.reshape(P * DESC_RING, 8),
                       mp_idx * DESC_RING + cnt % DESC_RING, new_desc, ok
                       ).reshape(P, DESC_RING, 8)
    desc_n = scatter_add(ms.mp_desc_n, mp_idx,
                         torch.ones_like(mp_idx, dtype=torch.int32), ok)

    cand = ring[mp_safe]                                    # [n, R, 8]
    n_stored = torch.clamp(cnt + 1, max=DESC_RING)
    slot_ok = (torch.arange(DESC_RING, device=cand.device)[None, :]
               < n_stored[:, None])
    dmat = torch.sum(popcount32(cand[:, :, None, :] ^ cand[:, None, :, :]),
                     dim=-1)                                # [n, R, R]
    big = 1 << 20
    pair_ok = slot_ok[:, :, None] & slot_ok[:, None, :]
    dmat = torch.where(pair_ok, dmat, big)
    dsort = torch.sort(dmat, dim=-1).values
    med_idx = ((n_stored - 1) // 2)[:, None, None].expand(-1, DESC_RING, 1)
    med = torch.gather(dsort, 2, med_idx)[..., 0]
    med = torch.where(slot_ok, med, big)
    best_slot = torch.argmin(med, dim=-1)
    rep = cand[torch.arange(cand.shape[0], device=cand.device), best_slot]
    desc = scatter_set(ms.mp_desc, mp_idx, rep, ok)
    return ms._replace(kf_mp=kf_mp, mp_normal_sum=normal_sum, mp_n_obs=n_obs,
                       mp_desc=desc, mp_desc_ring=ring, mp_desc_n=desc_n,
                       mp_max_dist=max_dist, mp_min_dist=min_dist)


def compact_mask(mask: torch.Tensor, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first ``cap`` True entries of ``mask``, in index
    order: (ids [cap] int64, ok [cap] bool); unused ids read 0."""
    M = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (rank < cap), rank, cap)
    ids = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    ids[tgt] = torch.arange(M, device=mask.device)
    ok = torch.zeros(cap + 1, dtype=torch.bool, device=mask.device)
    ok[tgt] = True
    return ids[:cap], ok[:cap]


def alloc_mp_slots(ms: MapState, ok: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One free map-point row per ok=True entry, lowest free rows first.
    Returns (slots [n], ok' [n]) with requests that did not fit masked."""
    n = ok.shape[0]
    free_ids, has = compact_mask(~ms.mp_valid, n)
    rank = torch.clamp(torch.cumsum(ok.to(torch.int64), 0) - 1, 0, n - 1)
    return free_ids[rank], ok & has[rank]


def add_map_points(ms: MapState, slots: torch.Tensor, pos: torch.Tensor,
                   ok: torch.Tensor, ref_kf, first_kf=None) -> MapState:
    """Create map points in rows ``slots`` (MapPoint ctor); ``first_kf`` is
    the monotonic keyframe ordinal used by MapPointCulling's age test."""
    if first_kf is None:
        first_kf = ref_kf
    i32 = torch.int32

    def put(t, v):
        return scatter_set(t, slots, v, ok)

    return ms._replace(
        mp_pos=put(ms.mp_pos, pos), mp_valid=put(ms.mp_valid, True),
        mp_normal_sum=put(ms.mp_normal_sum, 0.0),
        mp_n_obs=put(ms.mp_n_obs, 0), mp_desc_n=put(ms.mp_desc_n, 0),
        mp_ref_kf=put(ms.mp_ref_kf, torch.as_tensor(ref_kf).to(i32)),
        mp_first_kf=put(ms.mp_first_kf, torch.as_tensor(first_kf).to(i32)),
        mp_visible=put(ms.mp_visible, 1), mp_found=put(ms.mp_found, 1))


# ---------------------------------------------------------- covisibility ----

def kf_obs_ok(ms: MapState) -> torch.Tensor:
    """[K, N] bool: feature n of keyframe k carries a live association."""
    return (ms.kf_mp >= 0) & ms.kf_kp_valid & ms.kf_valid[:, None]


def points_of_kf(ms: MapState, kf) -> torch.Tensor:
    """[P] bool mask of the map points observed by keyframe ``kf``."""
    row = ms.kf_mp[kf]
    return mask_of(row, (row >= 0) & ms.kf_kp_valid[kf], ms.P)


def points_of_kfs(ms: MapState, kf_mask: torch.Tensor) -> torch.Tensor:
    """[P] bool mask of map points observed by any keyframe in kf_mask."""
    ok = kf_obs_ok(ms) & kf_mask[:, None]
    return mask_of(ms.kf_mp.reshape(-1), ok.reshape(-1), ms.P)


def kf_share_counts(ms: MapState, mp_mask: torch.Tensor) -> torch.Tensor:
    """[K] int32: per keyframe, how many of its points fall in mp_mask."""
    ok = kf_obs_ok(ms)
    hit = mp_mask[torch.where(ok, ms.kf_mp, 0).long()] & ok
    return torch.sum(hit.to(torch.int32), dim=1, dtype=torch.int32)


def covisibility_row(ms: MapState, kf) -> torch.Tensor:
    """[K] shared-point counts of one keyframe vs all others."""
    w = kf_share_counts(ms, points_of_kf(ms, kf))
    w = _set_row(w, kf, 0)
    return torch.where(ms.kf_valid, w, 0)


# ------------------------------------------------------------- map points ----

def remove_observations(ms: MapState, kf, feat_idx: torch.Tensor,
                        ok: torch.Tensor) -> MapState:
    """Erase feature→MP associations of one keyframe, decrementing n_obs
    (by 2 for stereo features)."""
    feat_idx = feat_idx.long()
    f_safe = torch.where(ok, feat_idx, 0)
    mp = ms.kf_mp[kf][f_safe].long()
    really = ok & (mp >= 0)
    kf_mp = _set_row(ms.kf_mp, kf, scatter_set(ms.kf_mp[kf], feat_idx,
                                               NO_MP, really))
    dec = torch.where(ms.kf_ur[kf][f_safe] >= 0, 2, 1).to(torch.int32)
    n_obs = scatter_add(ms.mp_n_obs, mp, -dec, really)
    return ms._replace(kf_mp=kf_mp, mp_n_obs=n_obs)


def remove_observations_batch(ms: MapState, kfs: torch.Tensor,
                              ok2d: torch.Tensor) -> MapState:
    """Erase associations of many keyframes at once; kfs [M] ids, ok2d
    [M, N] features to erase."""
    kfs = kfs.long()
    N = ms.N
    mp = ms.kf_mp[kfs].long()
    really = ok2d & (mp >= 0)
    flat = (kfs[:, None] * N
            + torch.arange(N, device=kfs.device)[None, :]).reshape(-1)
    kf_mp = scatter_set(ms.kf_mp.reshape(-1), flat, NO_MP,
                        really.reshape(-1)).reshape(ms.K, N)
    dec = torch.where(ms.kf_ur[kfs] >= 0, 2, 1).to(torch.int32)
    n_obs = scatter_add(ms.mp_n_obs, mp.reshape(-1), -dec.reshape(-1),
                        really.reshape(-1))
    return ms._replace(kf_mp=kf_mp, mp_n_obs=n_obs)


def invalidate_map_points(ms: MapState, bad_mask: torch.Tensor) -> MapState:
    """MapPoint::SetBadFlag batched: kill points and their associations."""
    has = ms.kf_mp >= 0
    dead_ref = bad_mask[torch.where(has, ms.kf_mp, 0).long()] & has
    return ms._replace(mp_valid=ms.mp_valid & (~bad_mask),
                       kf_mp=torch.where(dead_ref, NO_MP, ms.kf_mp))


def replace_map_points(ms: MapState, old_to_new: torch.Tensor) -> MapState:
    """MapPoint::Replace batched: redirect kf_mp old→new, invalidate old.
    old_to_new: [P], −1 for identity."""
    has_redir = old_to_new >= 0
    has = ms.kf_mp >= 0
    mp_ref = torch.where(has, ms.kf_mp, 0).long()
    redirected = torch.where(has & has_redir[mp_ref],
                             old_to_new[mp_ref].to(torch.int32), ms.kf_mp)
    return ms._replace(kf_mp=redirected, mp_valid=ms.mp_valid & (~has_redir))
