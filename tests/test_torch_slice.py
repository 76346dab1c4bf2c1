"""The whole slice: the port's SlamEngine and the JAX SlamEngine (stereo,
loop closing off) on the same 10 synthetic 640×480 frames.

Poses are not compared frame by frame — float order changes keyframe
decisions — but the runs must agree: neither is lost, keyframe counts
within ±1, port ATE < 0.05 m and within 0.03 m of the JAX ATE.
"""

import dataclasses

import numpy as np
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchEngine

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)
CAP = CapacityConfig(max_keyframes=16, max_map_points=4096,
                     local_ba_keyframes=8, local_ba_points=1024)


def _ate(poses_est, poses_gt):
    errs = [np.sum((-Te[:3, :3].T @ Te[:3, 3]
                    + Tg[:3, :3].T @ Tg[:3, 3]) ** 2)
            for Te, Tg in zip(poses_est, poses_gt) if Te is not None]
    return float(np.sqrt(np.mean(errs))), len(errs)


def test_port_engine_tracks_like_jax_engine():
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(10, step=0.25)
    frames = [synthetic.render_world_stereo(world, CAM, T, rng, noise=1.0)
              for T in poses]
    jeng = JaxEngine(SlamConfig(camera=CAM, orb=OrbConfig(n_features=400),
                                capacity=CAP, sensor=STEREO),
                     enable_loop_closing=False)
    teng = TorchEngine(tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(CAM)),
        orb=tconfig.OrbConfig(n_features=400),
        capacity=tconfig.CapacityConfig(**dataclasses.asdict(CAP)),
        sensor=STEREO), enable_loop_closing=False, device="cpu")
    for i, (left, right) in enumerate(frames):
        assert jeng.track_stereo(left, right, 0.1 * i) is not None, i
        assert teng.track_stereo(left, right, 0.1 * i) is not None, i
    assert jeng.state == teng.state == 2
    j_ate, jn = _ate(jeng.frame_poses(), poses)
    t_ate, tn = _ate(teng.frame_poses(), poses)
    assert jn == tn == len(poses)
    assert abs(teng.stats["kf_inserted"] - jeng.stats["kf_inserted"]) <= 1, \
        (teng.stats, jeng.stats)
    assert t_ate < 0.05, t_ate
    assert abs(t_ate - j_ate) < 0.03, (t_ate, j_ate)
    assert len(teng.map_points()) > 200
