"""Background preemptible global bundle adjustment.

Port of ``orbslam2_tpu/runtime/gba.py`` (single-device path): the GBA of
LoopClosing::RunGlobalBundleAdjustment runs on a Python thread over an
immutable map snapshot — every map update in the package returns new
tensors, so nothing the engine does later writes into it.  The solve runs
in chunks of 5 LM iterations (robust first, plain after, on the surviving
inliers) through ``bundle_adjust(fix_first_free=True)``, with the abort
flag checked between chunks.  Up to 256 keyframe slots a chunk solves the
reduced camera system densely; past that it takes the matrix-free CG
solver, as the JAX version does (``gba.py:99``), because the dense
coupling grows as P·K.  ``merge`` applies a finished
result to the CURRENT map: snapshot keyframes still alive under the same
identity take their optimized poses, keyframes born during the GBA are
rebased through their spanning-tree parents over PROPAGATE_DEPTH steps,
points take their optimized position or follow their reference keyframe.

The thread issues its work on the default CUDA stream.  Its map crosses
streams explicitly (``device.handoff``), since the caller may issue on
another one (the async engine's mapping worker has its own): ``launch``
records an event on the caller's current stream, which the thread's
stream waits on before it reads the snapshot; the thread records one
after its solve, which the caller's stream waits on in
``poll_and_merge`` before the merge.  With the caller on the default
stream too, both waits are no-ops.

With a mesh (``parallel/mesh.py``; the loop closer hands on its own,
which the engines' auto rule makes where its device is one of several
local CUDA devices; None: no mesh) the solve takes the JAX version's
mesh path (``gba.py:252-294``): the same chunked schedule through
``parallel/dist_ba.distributed_bundle_adjust`` (CG, observations sharded
by point block), the shard threads started from the GBA thread.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.ops import bundle
from orbslam2_tpu_torch.parallel import dist_ba
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.utils import camera as cam_mod
from orbslam2_tpu_torch.utils import lie

PROPAGATE_DEPTH = 8   # spanning-tree chains among keyframes born mid-GBA


class GbaResult(NamedTuple):
    snap_kf_frame_id: torch.Tensor   # [K] identity of snapshot keyframes
    snap_kf_valid: torch.Tensor      # [K]
    old_poses: torch.Tensor          # [K, 4, 4] poses at snapshot time
    new_poses: torch.Tensor          # [K, 4, 4] optimized
    snap_mp_first: torch.Tensor      # [P] identity of snapshot points
    snap_mp_valid: torch.Tensor      # [P]
    new_points: torch.Tensor         # [P, 3] optimized


def full_map_problem(cfg: SlamConfig, ms: M.MapState,
                     obs_ok: torch.Tensor) -> bundle.BAProblem:
    """Every keyframe slot a camera, every point a landmark, observation
    (k, n) taking part where ``obs_ok`` [K, N] holds."""
    K, N, dev = ms.K, ms.N, ms.kf_xy.device
    sigma2 = np.array([cfg.orb.scale_factor ** (2 * l)
                       for l in range(cfg.orb.n_levels)], np.float32)
    inv_sigma2 = torch.as_tensor((1.0 / sigma2).astype(np.float32),
                                 device=dev)
    cam_i = torch.arange(K, device=dev)[:, None].expand(K, N)
    return bundle.BAProblem(
        poses=ms.kf_pose, points=ms.mp_pos, point_valid=ms.mp_valid,
        cam_i=cam_i.reshape(-1),
        pt_i=torch.where(obs_ok, ms.kf_mp, 0).long().reshape(-1),
        uv=ms.kf_xy.reshape(-1, 2), ur=ms.kf_ur.reshape(-1),
        inv_sigma2=inv_sigma2[ms.kf_level.long()].reshape(-1),
        valid=obs_ok.reshape(-1))


def with_ba_result(ms: M.MapState, poses, points) -> M.MapState:
    """Live keyframes and points take the optimized values."""
    return ms._replace(
        kf_pose=torch.where(ms.kf_valid[:, None, None], poses, ms.kf_pose),
        mp_pos=torch.where(ms.mp_valid[:, None], points, ms.mp_pos))


def make_gba_fns(cfg: SlamConfig):
    """(gba_chunk, merge) for one config."""
    cam = cam_mod.Camera.from_config(cfg.camera)

    def gba_chunk(ms: M.MapState, obs_w: torch.Tensor, use_huber: bool
                  ) -> Tuple[M.MapState, torch.Tensor]:
        """5 LM iterations of full-map Schur BA (robust when
        ``use_huber``; dense up to 256 keyframe slots, CG past that);
        returns the updated snapshot and the post-chunk inlier mask
        [K·N], the next chunk's weights."""
        K = ms.K
        prob = full_map_problem(
            cfg, ms, M.kf_obs_ok(ms) & obs_w.reshape(K, ms.N))
        iters = (5, 0) if use_huber else (0, 5)
        poses, points, inlier = bundle.bundle_adjust(
            cam, prob, n_free=K, iters_a=iters[0], iters_b=iters[1],
            fix_first_free=True, solver="dense" if K <= 256 else "cg")
        return with_ba_result(ms, poses, points), inlier

    def merge(ms: M.MapState, res: GbaResult) -> M.MapState:
        """Apply a finished GBA to the current map (LoopClosing.cc:
        715-775)."""
        in_snap = (res.snap_kf_valid & ms.kf_valid
                   & (ms.kf_frame_id == res.snap_kf_frame_id))
        pose_now = ms.kf_pose
        corrected = in_snap
        pose_new = torch.where(in_snap[:, None, None], res.new_poses,
                               pose_now)
        par = torch.clamp(ms.kf_parent, 0, ms.K - 1).long()
        T_rel = pose_now @ lie.se3_inv(pose_now[par])
        for _ in range(PROPAGATE_DEPTH):
            can = (ms.kf_valid & ~corrected & corrected[par]
                   & (ms.kf_parent >= 0))
            pose_new = torch.where(can[:, None, None], T_rel @ pose_new[par],
                                   pose_new)
            corrected = corrected | can

        pt_in_snap = (res.snap_mp_valid & ms.mp_valid
                      & (ms.mp_first_kf == res.snap_mp_first))
        ref = torch.clamp(ms.mp_ref_kf, 0, ms.K - 1).long()
        ref_ok = corrected[ref]

        def apply(T, X):
            return torch.einsum("pij,pj->pi", T[:, :3, :3], X) + T[:, :3, 3]

        X_corr = apply(lie.se3_inv(pose_new[ref]),
                       apply(pose_now[ref], ms.mp_pos))
        mp_pos = torch.where(
            pt_in_snap[:, None], res.new_points,
            torch.where((ms.mp_valid & ref_ok)[:, None], X_corr, ms.mp_pos))
        kf_pose = torch.where(corrected[:, None, None], pose_new, ms.kf_pose)
        return ms._replace(kf_pose=kf_pose, mp_pos=mp_pos)

    return gba_chunk, merge


class GbaManager:
    """Owns the background GBA thread (the reference's spawned
    RunGlobalBundleAdjustment thread with mbStopGBA / mbRunningGBA)."""

    def __init__(self, cfg: SlamConfig, n_chunks: int = 3, mesh=None):
        self.cfg = cfg
        self.n_chunks = n_chunks
        self.f_chunk, self.f_merge = make_gba_fns(cfg)
        self.mesh = mesh      # None: the unsharded solve
        self._thread: Optional[threading.Thread] = None
        self._abort = threading.Event()
        # a finished solve and the event its stream recorded after it
        self._result: Optional[Tuple[GbaResult, object]] = None
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()
        self.stats = {"launched": 0, "aborted": 0, "finished": 0,
                      "merged": 0, "distributed": 0}

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def launch(self, ms: M.MapState) -> None:
        """Start GBA on the snapshot ``ms``; a running GBA is aborted
        first (a new loop supersedes, LoopClosing.cc:446-459)."""
        self.abort()
        self._abort.clear()
        with self._lock:
            self._result = None
        self.stats["launched"] += 1
        ready = device_mod.mark(ms.kf_pose.device)
        self._thread = threading.Thread(
            target=self._run, args=(ms, ready), name="global-ba",
            daemon=True)
        self._thread.start()

    def abort(self) -> None:
        """mbStopGBA: stop the running GBA and discard its work."""
        if self.running:
            self._abort.set()
            self._thread.join()
            self.stats["aborted"] += 1
        self._thread = None
        with self._lock:
            self._result = None
        self._raise_pending()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the background solve finishes."""
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._raise_pending()

    def poll_and_merge(self, ms: M.MapState) -> Tuple[M.MapState, bool]:
        """If a finished, unaborted GBA is pending, propagate it into the
        current map.  Call from the map owner only."""
        self._raise_pending()
        with self._lock:
            out = self._result
            self._result = None
        if out is None:
            return ms, False
        res, done = out
        device_mod.handoff(res, done)
        self.stats["merged"] += 1
        return self.f_merge(ms, res), True

    def _raise_pending(self) -> None:
        """A failure on the thread surfaces in the map owner's next call."""
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("global BA failed on its thread") from err

    def _solve_chunks(self, snap: M.MapState) -> Optional[M.MapState]:
        obs_w = torch.ones(snap.K * snap.N, dtype=torch.bool,
                           device=snap.kf_xy.device)
        ms = snap
        for chunk in range(self.n_chunks):
            if self._abort.is_set():
                return None
            ms, obs_w = self.f_chunk(ms, obs_w, use_huber=(chunk == 0))
        return ms

    def _solve_distributed(self, snap: M.MapState) -> Optional[M.MapState]:
        """The mesh path: a robust first chunk, then plain chunks on the
        surviving inliers, the abort checked between chunks."""
        cam = cam_mod.Camera.from_config(self.cfg.camera)
        prob = full_map_problem(self.cfg, snap, M.kf_obs_ok(snap))
        self.stats["distributed"] += 1
        for chunk in range(self.n_chunks):
            if self._abort.is_set():
                return None
            poses, points, inlier = dist_ba.distributed_bundle_adjust(
                self.mesh, cam, prob, n_free=snap.K,
                iters_a=5 if chunk == 0 else 0,
                iters_b=0 if chunk == 0 else 5, fix_first_free=True)
            dev = prob.poses.device
            prob = prob._replace(poses=poses.to(dev), points=points.to(dev),
                                 valid=prob.valid & inlier.to(dev))
        return with_ba_result(snap, prob.poses, prob.points)

    def _run(self, snap: M.MapState, ready) -> None:
        try:
            device_mod.handoff(snap, ready)
            ms = (self._solve_distributed(snap) if self.mesh is not None
                  else self._solve_chunks(snap))
            if ms is None or self._abort.is_set():
                return
            res = GbaResult(
                snap_kf_frame_id=snap.kf_frame_id,
                snap_kf_valid=snap.kf_valid, old_poses=snap.kf_pose,
                new_poses=ms.kf_pose, snap_mp_first=snap.mp_first_kf,
                snap_mp_valid=snap.mp_valid, new_points=ms.mp_pos)
            done = device_mod.mark(snap.kf_pose.device)
        except Exception as e:   # the thread's boundary: handed to the
            # map owner, which re-raises it at its next call
            with self._lock:
                self._error = e
            return
        with self._lock:
            self._result = (res, done)
        self.stats["finished"] += 1
