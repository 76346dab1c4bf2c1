"""The System facade: the public entry point of the port.

Port of ``orbslam2_tpu/runtime/system.py:26-259``, the reference's
``System`` (include/System.h:72-149): the constructor from (vocabulary,
settings, sensor, flags), the per-frame entries Track{Stereo,RGBD,IRD,
Monocular}, localization-mode switching, ChangeCalibration, Reset and
Shutdown, the trajectory savers, the pose covariance (also in TrackIRD's
world frame), GetMap, and map save/load in the JAX package's file format
(``runtime/serialization.py``).  It drives the synchronous
``SlamEngine``; the port has no async pipeline yet.

``device`` passes through to the engine: the CUDA card unless another is
named (``device="cpu"``); ``reset`` and ``change_calibration`` rebuild
the engine on the same device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import MONOCULAR, RGBD, STEREO, SlamConfig
from orbslam2_tpu_torch.models import vocabulary as voc_mod
from orbslam2_tpu_torch.runtime import serialization, tracking
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.utils import trajectory as traj_mod
from orbslam2_tpu_torch.utils.hpose import HPose

# ORB camera axes → world axes of TrackIRD (System.cc:298-319):
# x_w = z, y_w = −x, z_w = −y
_AXES = np.array([[0.0, 0.0, 1.0],
                  [-1.0, 0.0, 0.0],
                  [0.0, -1.0, 0.0]])

# engine state carried over by change_calibration (JAX system.py:127-131)
_TRANSPLANT = ("ms", "state", "n_kfs", "kf_ordinal", "n_live_points",
               "frame_id", "last_kf_frame_id", "ref_kf", "velocity",
               "last_Tcw", "last_assoc", "last_inlier", "trajectory",
               "localization_only", "_free_kf_slots", "_culled_remap",
               "stats")


class System:
    """Facade with the reference's constructor contract (System.cc:34):
    System(voc_file, settings_file, sensor, use_viewer, save_map,
    replayer), plus the engine's ``device``."""

    def __init__(self, voc_file: Optional[str], settings_file: Optional[str],
                 sensor: int = STEREO, use_viewer: bool = False,
                 save_map: bool = False, replayer: bool = False,
                 config: Optional[SlamConfig] = None, device=None):
        if config is not None:
            self.cfg = config.replace(sensor=sensor)
        elif settings_file:
            self.cfg = SlamConfig.from_yaml(settings_file, sensor=sensor)
        else:
            self.cfg = SlamConfig(sensor=sensor)
        self.sensor = sensor
        self.save_map_on_shutdown = save_map
        self.replayer = replayer
        self.use_viewer = use_viewer

        voc = None
        if voc_file and os.path.exists(voc_file):
            with np.load(voc_file) as z:
                levels = int(z["levels"])
                voc = voc_mod.from_numpy(
                    [z[f"cent{d}"] for d in range(levels)], z["idf"],
                    int(z["k"]), levels)
        self.engine = SlamEngine(self.cfg, vocabulary=voc, device=device)

        # map reload (System.cc:55-66 + LoadMap): the first frame
        # relocalizes, in localization mode
        self.map_file = self.cfg.map_file
        if self.map_file and os.path.exists(self.map_file):
            self.load_map(self.map_file)

        self._shutdown = False

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # ------------------------------------------------------ frame entries --
    def _replayer_sync(self):
        """Replayer handshake (System.cc:169-183): in replayer mode a frame
        is not processed while a global BA is still running."""
        if self.replayer and self.engine.loop_closer is not None \
                and self.engine.loop_closer.gba.running:
            self.engine.finish_gba()

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float) -> Optional[np.ndarray]:
        """System::TrackStereo (System.cc:127)."""
        assert self.sensor == STEREO
        self._replayer_sync()
        return self.engine.track_stereo(left, right, timestamp)

    def track_rgbd(self, im: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> Optional[np.ndarray]:
        """System::TrackRGBD (System.cc:194)."""
        assert self.sensor == RGBD
        self._replayer_sync()
        return self.engine.track_rgbd(im, depth, timestamp)

    def track_ird(self, ir: np.ndarray, depth: np.ndarray,
                  timestamp: float) -> Optional[HPose]:
        """System::TrackIRD (System.cc:247): RGB-D tracking with an HPose
        in the world frame (the axis remap of System.cc:298-319)."""
        assert self.sensor == RGBD
        Tcw = self.engine.track_rgbd(ir, depth, timestamp)
        if Tcw is None:
            return None
        return HPose.from_Tcw(Tcw).to_world_frame()

    def track_monocular(self, im: np.ndarray, timestamp: float
                        ) -> Optional[np.ndarray]:
        """System::TrackMonocular (System.cc:325)."""
        assert self.sensor == MONOCULAR
        self._replayer_sync()
        return self.engine.track_monocular(im, timestamp)

    def change_calibration(self, settings_file: str) -> None:
        """Tracking::ChangeCalibration (Tracking.cc:1656): new intrinsics,
        distortion and bf from ``settings_file``, the map kept.  The
        camera is baked into the engine's step functions, so the engine is
        rebuilt on the same device around the new calibration and its
        state is carried over.  A windowed engine is flushed first under
        the old calibration; its held keyframe slots and the references
        of its unretired windows are carried over too, so that no slot in
        use is freed.  A running global BA of the old loop closer is
        dropped, not merged, as in the JAX package."""
        new_cam = SlamConfig.from_yaml(settings_file,
                                       sensor=self.sensor).camera
        self.cfg = self.cfg.replace(camera=new_cam)
        old = self.engine
        kw = {}
        port_only = ()
        if hasattr(old, "flush"):
            old.flush()
            kw["window"] = old.window
            port_only = ("_window_refs", "_held_slots")
        lc = old.loop_closer
        self.engine = type(old)(self.cfg, enable_loop_closing=lc is not None,
                                device=old.device,
                                vocabulary=None if lc is None else lc.voc,
                                **kw)
        for attr in _TRANSPLANT + port_only:
            setattr(self.engine, attr, getattr(old, attr))
        if lc is not None:
            nlc = self.engine.loop_closer
            nlc.db = lc.db
            nlc.consistent_groups = lc.consistent_groups
            nlc.prev_loops = lc.prev_loops
            nlc.last_loop_kf = lc.last_loop_kf

    # ------------------------------------------------------------- modes --
    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.cc:377): tracking
        continues, mapping stops."""
        self.engine.localization_only = True

    def deactivate_localization_mode(self):
        self.engine.localization_only = False

    def reset(self):
        """System::Reset (System.cc:402): a new engine, on the same
        device, with an empty map, DB and trajectory."""
        lc = self.engine.loop_closer
        self.engine = SlamEngine(
            self.cfg, enable_loop_closing=lc is not None,
            device=self.engine.device,
            vocabulary=None if lc is None else lc.voc)

    def shutdown(self):
        """System::Shutdown (System.cc:415): wait for a running global BA
        and merge it (:435-439), then save the map if asked to."""
        self.engine.finish_gba()
        if self.save_map_on_shutdown and self.map_file:
            self.save_map(self.map_file)
        self._shutdown = True

    # ------------------------------------------------------------ queries --
    def get_tracking_state(self) -> int:
        return self.engine.state

    def map_changed(self) -> bool:
        """System::MapChanged (the big-change counter, Map.cc:70-80)."""
        return self.engine.stats["loops_closed"] > 0 or \
            self.engine.stats["kf_inserted"] > 0

    def get_map(self) -> np.ndarray:
        """System::GetMap (System.cc:793): the live point cloud [P, 3]."""
        return self.engine.map_points()

    def get_current_covariance(self) -> Optional[np.ndarray]:
        """System::GetCurrentCovarianceMatrix (System.cc:703-790): the 6×6
        covariance of the last pose, tangent [ω, υ]."""
        return self.engine.current_pose_covariance()

    def get_current_covariance_world(self) -> Optional[np.ndarray]:
        """The 6×6 covariance in TrackIRD's world frame: both 3×3 blocks
        turn by the fixed axis permutation, Σ_w = J Σ Jᵀ with J =
        diag(R_p, R_p)."""
        cov = self.engine.current_pose_covariance()
        if cov is None:
            return None
        J = np.zeros((6, 6))
        J[:3, :3] = _AXES           # rotation (so3) block
        J[3:, 3:] = _AXES           # translation block
        return J @ cov @ J.T

    def get_tracked_points(self) -> int:
        if self.engine.last_assoc is None:
            return 0
        return int(torch.sum(self.engine.last_assoc >= 0))

    # ----------------------------------------------------------- exports --
    def save_trajectory_tum(self, path: str):
        """System::SaveTrajectoryTUM (System.cc:448)."""
        poses = self.engine.frame_poses()
        ts = [e.timestamp for e in self.engine.trajectory]
        traj_mod.save_tum(path, ts, poses)

    def save_keyframe_trajectory_tum(self, path: str):
        """System::SaveKeyFrameTrajectoryTUM (System.cc:508)."""
        ms = self.engine.ms
        live = np.where(ms.kf_valid.cpu().numpy())[0]
        pose = ms.kf_pose.cpu().numpy()
        stamp = ms.kf_timestamp.cpu().numpy()
        traj_mod.save_tum(path, [float(stamp[k]) for k in live],
                          [pose[k] for k in live])

    def save_trajectory_kitti(self, path: str):
        """System::SaveTrajectoryKITTI (System.cc:546)."""
        traj_mod.save_kitti(path, self.engine.frame_poses())

    # --------------------------------------------------------- checkpoint --
    def save_map(self, path: str):
        lc = self.engine.loop_closer
        serialization.save_map(
            path, self.engine.ms, None if lc is None else lc.db,
            {"n_kfs": self.engine.n_kfs,
             "kf_ordinal": self.engine.kf_ordinal,
             "frame_id": self.engine.frame_id})

    def load_map(self, path: str):
        """LoadMap: the map and DB onto the engine's device, then LOST in
        localization mode, so the first frame relocalizes
        (Tracking.cc:157-158)."""
        eng = self.engine
        ms, db, counters = serialization.load_map(path, eng.device)
        eng.ms = ms
        # (the JAX package shards the DB over a device mesh here; the
        # port's mesh, parallel/*, is not ported yet)
        if db is not None and eng.loop_closer is not None:
            eng.loop_closer.db = db
        kf_valid = ms.kf_valid.cpu().numpy()
        eng.n_kfs = counters.get("n_kfs", int(kf_valid.sum()))
        eng.kf_ordinal = counters.get(
            "kf_ordinal", counters.get("n_kfs", int(kf_valid.sum())))
        eng._free_kf_slots = set(np.where(~kf_valid)[0].tolist())
        eng.frame_id = counters["frame_id"]
        eng.state = tracking.LOST
        eng.last_Tcw = np.eye(4, dtype=np.float32)
        N = self.cfg.orb.n_features_padded
        eng.last_assoc = torch.full((N,), -1, dtype=torch.int32,
                                    device=eng.device)
        eng.last_inlier = torch.zeros(N, dtype=torch.bool, device=eng.device)
        eng.localization_only = True
