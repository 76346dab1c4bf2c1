"""RGB-D on the port against the JAX package: the depth lookup, the
RGB-D frontend, and both engines on a synthetic RGB-D sequence.

Tolerances:

  * ``depth_from_rgbd``: exact (a rounded, clipped gather), including
    keypoints at .5 coordinates (both round half to even), at and beyond
    the image border (JAX's clipped gather wraps a negative index by the
    axis length before it clamps: x = −3 reads column W − 3) and on zero
    depth; the virtual right coordinate
    ``x − bf/d`` within 1e-4 px (XLA may form the quotient another way);
  * the RGB-D frontend on a rendered 640×480 frame (uint8 gray, float32
    depth), the port handed JAX's IC angles (tests/jax_angles.py: their
    float32 sums round by the host CPU on resized levels; the port's own
    angles are held in test_torch_frontend.py): keypoints, levels,
    validity, descriptors and depths exact, ``ur`` 1e-4 px, angles
    within 1e-4 rad of JAX's (met trivially under the handover);
  * ``SlamEngine`` (here) and ``WindowedSlamEngine(window=4)``
    (test_torch_rgbd_windowed.py, which reuses this file's sequence and
    bars), loop closing off, 12 frames of the corridor at 0.4 m a frame, 400 features, both
    packages with uint8 gray and ``_mapper_idle`` patched to True:
    neither LOST, keyframe counts within ±1, port ATE < 0.05 m and within
    0.01 m of the JAX engine's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 RGBD, SlamConfig)
from orbslam2_tpu.models import frame as jframe
from orbslam2_tpu.ops import extractor as je
from orbslam2_tpu.ops import stereo as js
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import to_tensor
from orbslam2_tpu_torch.models import frame as tframe
from orbslam2_tpu_torch.ops import extractor as te
from orbslam2_tpu_torch.ops import stereo as ts
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchEngine

from jax_angles import hand_over as hand_over_jax_angles

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)
CAP = CapacityConfig(max_keyframes=16, max_map_points=4096,
                     local_ba_keyframes=8, local_ba_points=1024)
JCFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=400), capacity=CAP,
                  sensor=RGBD)
TCFG = tconfig.SlamConfig(
    camera=tconfig.CameraConfig(**dataclasses.asdict(CAM)),
    orb=tconfig.OrbConfig(n_features=400),
    capacity=tconfig.CapacityConfig(**dataclasses.asdict(CAP)), sensor=RGBD)
N_FRAMES, STEP = 12, 0.4


def _ate(poses_est, poses_gt):
    errs = [np.sum((-Te[:3, :3].T @ Te[:3, 3]
                    + Tg[:3, :3].T @ Tg[:3, 3]) ** 2)
            for Te, Tg in zip(poses_est, poses_gt) if Te is not None]
    return float(np.sqrt(np.mean(errs))), len(errs)


@pytest.fixture(scope="module")
def sequence():
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(N_FRAMES, step=STEP)
    frames = []
    for T in poses:
        g, d = synthetic.render_world(world, CAM, T, rng, 1.0,
                                      with_depth=True)
        frames.append((np.clip(g, 0, 255).astype(np.uint8), d))
    return poses, frames


def test_depth_from_rgbd_exact():
    rng = np.random.default_rng(5)
    H, W, n = 48, 64, 96
    depth = rng.uniform(0.5, 9.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0              # holes
    xy = np.stack([rng.uniform(-3, W + 3, n),
                   rng.uniform(-3, H + 3, n)], 1).astype(np.float32)
    # .5 coordinates round half to even; the border and beyond clamp
    xy[:8] = [[0.5, 0.5], [1.5, 2.5], [62.5, 46.5], [63.5, 47.5],
              [-0.5, 10.5], [64.5, -2.5], [63.0, 47.0], [200.0, 300.0]]
    valid = rng.random(n) < 0.9
    level = np.zeros(n, np.int32)
    desc = np.zeros((n, 8), np.uint32)
    zero = np.zeros(n, np.float32)
    jf = je.Features(xy=jnp.asarray(xy), level=jnp.asarray(level),
                     angle=jnp.asarray(zero), response=jnp.asarray(zero),
                     valid=jnp.asarray(valid), desc=jnp.asarray(desc))
    tf = te.Features(*(to_tensor(np.asarray(x)) for x in jf))
    jm = js.depth_from_rgbd(jf, jnp.asarray(depth), CAM.bf)
    tm = ts.depth_from_rgbd(tf, torch.from_numpy(depth), CAM.bf)
    np.testing.assert_array_equal(tm.depth.numpy(), np.asarray(jm.depth))
    np.testing.assert_allclose(tm.u_right.numpy(), np.asarray(jm.u_right),
                               atol=1e-4, rtol=0)
    # the pinned cases: numpy's half-to-even rounding, then JAX's clip
    # rule (a negative index wraps once, then clamps)
    for i, (x, y) in enumerate(xy[:8]):
        r, c = (int(np.clip(v + m if v < 0 else v, 0, m - 1))
                for v, m in ((np.round(y), H), (np.round(x), W)))
        want = depth[r, c] if valid[i] and depth[r, c] > 0 else -1.0
        assert float(tm.depth[i]) == want, (i, x, y)
    assert (tm.depth.numpy() == -1).any() and (tm.depth.numpy() > 0).any()


def test_rgbd_frontend_exact(sequence, monkeypatch):
    _, frames = sequence
    hand_over_jax_angles(monkeypatch)
    g, d = frames[3]
    g32 = g.astype(np.float32)
    jfd = jframe.make_frontend_rgbd(JCFG)(jnp.asarray(g32), jnp.asarray(d))
    tfd = tframe.make_frontend_rgbd(TCFG)(torch.from_numpy(g32),
                                          torch.from_numpy(d))
    for f in ("xy", "xy_raw", "level", "valid", "depth"):
        np.testing.assert_array_equal(getattr(tfd, f).numpy(),
                                      np.asarray(getattr(jfd, f)), err_msg=f)
    np.testing.assert_array_equal(tfd.desc.numpy().view(np.uint32),
                                  np.asarray(jfd.desc))
    np.testing.assert_allclose(tfd.ur.numpy(), np.asarray(jfd.ur),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tfd.angle.numpy(), np.asarray(jfd.angle),
                               atol=1e-4, rtol=0)
    assert int((tfd.depth > 0).sum()) > 200


def engines_track_alike(jeng, teng, sequence, flush=False):
    """Both engines over the sequence; the file's bars on the result."""
    poses, frames = sequence
    for eng in (jeng, teng):
        eng._mapper_idle = lambda: True
        for i, (g, d) in enumerate(frames):
            eng.track_rgbd(g, d, 0.1 * i)
        if flush:
            eng.flush()
    assert jeng.state == teng.state == 2
    j_ate, jn = _ate(jeng.frame_poses(), poses)
    t_ate, tn = _ate(teng.frame_poses(), poses)
    assert jn == tn == N_FRAMES
    assert teng.stats["kf_inserted"] >= 3, teng.stats
    assert abs(teng.stats["kf_inserted"] - jeng.stats["kf_inserted"]) <= 1, \
        (teng.stats, jeng.stats)
    assert t_ate < 0.05, t_ate
    assert abs(t_ate - j_ate) < 0.01, (t_ate, j_ate)


def test_rgbd_engine_tracks_like_jax(sequence):
    engines_track_alike(
        JaxEngine(JCFG, enable_loop_closing=False),
        TorchEngine(TCFG, enable_loop_closing=False, device="cpu"), sequence)
