"""Both engines with loop closing on, the port's against the JAX
package's (moved from tests/test_torch_loop.py): keyframe counts ±1, ATE
within 0.03 m; the ``slow`` orbit: both close a loop, ATE < 0.5 m.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu.config import STEREO, SlamConfig
from orbslam2_tpu.models import vocabulary as jvoc
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchEngine
from test_torch_loop import A, port_cfg, port_voc

torch.set_num_threads(2)


CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0, width=640,
              height=480, fps=10.0, th_depth=60.0)


def _ate(poses_est, poses_gt, rebase=None):
    errs = []
    for Te, Tg in zip(poses_est, poses_gt):
        if Te is None:
            continue
        if rebase is not None:
            Te = Te @ rebase
        errs.append(np.sum((-Te[:3, :3].T @ Te[:3, 3]
                            + Tg[:3, :3].T @ Tg[:3, 3]) ** 2))
    return float(np.sqrt(np.mean(errs))), len(errs)


def _engines(cap, n_features, voc):
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig,
                                     OrbConfig)
    cfg = SlamConfig(camera=CameraConfig(**CAM_KW),
                     orb=OrbConfig(n_features=n_features),
                     capacity=CapacityConfig(**cap), sensor=STEREO)
    return (JaxEngine(cfg, vocabulary=voc),
            TorchEngine(port_cfg(cfg), device="cpu",
                        vocabulary=port_voc(voc)))


def test_port_engine_with_loop_closing_tracks_like_jax():
    """Both engines with loop closing on, over the 10-frame corridor of
    tests/test_torch_slice.py."""
    voc = jvoc.default_vocabulary()
    jeng, teng = _engines(dict(max_keyframes=16, max_map_points=4096,
                               local_ba_keyframes=8, local_ba_points=1024),
                          400, voc)
    assert teng.loop_closer is not None
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(10, step=0.25)
    for i, Tcw in enumerate(poses):
        left, right = synthetic.render_world_stereo(
            world, jeng.cfg.camera, Tcw, rng, noise=1.0)
        assert jeng.track_stereo(left, right, 0.1 * i) is not None, i
        assert teng.track_stereo(left, right, 0.1 * i) is not None, i
    assert jeng.finish_gba() is False and teng.finish_gba() is False
    j_ate, jn = _ate(jeng.frame_poses(), poses)
    t_ate, tn = _ate(teng.frame_poses(), poses)
    assert jn == tn == len(poses)
    assert abs(teng.stats["kf_inserted"] - jeng.stats["kf_inserted"]) <= 1
    assert abs(t_ate - j_ate) < 0.03, (t_ate, j_ate)
    # every live keyframe but the stereo-initialization one is in the DB
    live = set(np.where(A(teng.ms.kf_valid))[0].tolist())
    in_db = set(np.where(A(teng.loop_closer.db.valid))[0].tolist())
    assert in_db == live - {0}, (in_db, live)


@pytest.mark.slow
def test_port_engine_closes_the_orbit_loop_like_jax():
    """tests/test_loop_closing.py's outward orbit (1.25 turns, 72 frames):
    both engines close at least one loop and end below 0.5 m ATE."""
    from test_loop_closing import orbit_scene, outward_orbit
    voc = jvoc.default_vocabulary()
    jeng, teng = _engines(dict(max_keyframes=64, max_map_points=1 << 14,
                               local_ba_keyframes=8, local_ba_points=2048),
                          600, voc)
    rng = np.random.default_rng(0)
    scene = orbit_scene(rng)
    poses = outward_orbit(72, radius=4.0, z_center=10.0, turns=1.25)
    for i, Tcw in enumerate(poses):
        left, right = synthetic.render_stereo(scene, jeng.cfg.camera, Tcw,
                                              rng, 1.0)
        jeng.track_stereo(left, right, 0.1 * i)
        teng.track_stereo(left, right, 0.1 * i)
    for eng in (jeng, teng):
        assert eng.stats["loops_closed"] >= 1, eng.stats
        eng.finish_gba()
        ate, n = _ate(eng.frame_poses(), poses, rebase=poses[0])
        assert n > 0.85 * len(poses) and ate < 0.5, (ate, n, eng.stats)
