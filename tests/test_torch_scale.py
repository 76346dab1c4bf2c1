"""The map-scale circuit (``orbslam2_tpu_torch/tools/scale_demo.py``)
against the JAX package: both engines at the circuit's capacity.  Its
``run_circuit`` and ``main``: tests/test_torch_scale_tool.py; the
trajectory tool: tests/test_torch_plot_trajectory.py.

  * both ``WindowedSlamEngine(window=4)``s, loop closing on, at the
    circuit's configuration and full capacity (1024 keyframe slots,
    131,072 points, 1000 features, the scale camera) over the first 12
    frames of tests/test_scale_circuit.py's scene, uint8 frames on both
    sides, ``_mapper_idle`` patched to True on both and the port handed
    JAX's frontend (tests/jax_angles.py: its pyramids, IC angles and
    stereo SAD sum in a host-dependent float order): the same
    ``kf_inserted``, ``n_kfs`` and ``n_live_points``; neither LOST; every
    camera centre and the ATE within 0.01 m of the JAX engine's
    (test_torch_windowed.py's parity bar for whole-engine runs), ATE <
    0.1 m (both packages take ~0.050 m here, at 0.54 m a frame; the
    corridor's 0.05 m bar is that scene's).

The ``slow`` test is tests/test_scale_circuit.py on the port: the same
scene, configuration and bars at that test's capacity and at the
circuit's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.tools import scale_demo as sd
from orbslam2_tpu_torch.utils import render_pool, synthetic

from jax_angles import hand_over_frontend

torch.set_num_threads(2)

N_ENGINE = 12


def _jax_cfg(tcfg):
    return SlamConfig(
        camera=CameraConfig(**dataclasses.asdict(tcfg.camera)),
        orb=OrbConfig(**dataclasses.asdict(tcfg.orb)),
        capacity=CapacityConfig(**dataclasses.asdict(tcfg.capacity)),
        sensor=STEREO)


def _u8(frames):
    return [(np.ascontiguousarray(l, dtype=np.uint8),
             np.ascontiguousarray(r, dtype=np.uint8)) for l, r in frames]


# ------------------------------------------------------ engines at scale --

def test_config_is_the_jax_scripts():
    cfg = sd.scale_config()
    assert (cfg.capacity.max_keyframes, cfg.capacity.max_map_points) == \
        (1024, 1 << 17)
    assert (cfg.camera.fx, cfg.camera.bf, cfg.camera.width,
            cfg.camera.th_depth, cfg.orb.n_features) == \
        (225.0, 120.0, 320, 35.0, 1000)
    assert (cfg.capacity.local_ba_keyframes,
            cfg.capacity.local_ba_points) == (8, 2048)
    assert isinstance(cfg, tconfig.SlamConfig)


def test_windowed_engines_at_scale_capacity_track_alike(monkeypatch):
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxW

    tcfg = sd.scale_config()
    rng = np.random.default_rng(0)
    world, poses = sd.small_circuit(rng)
    poses = poses[:N_ENGINE]
    frames = _u8(render_pool.render_frames(synthetic.render_world_stereo,
                                           world, tcfg.camera, poses, rng))
    jeng = JaxW(_jax_cfg(tcfg), enable_loop_closing=True, window=4)
    jeng._mapper_idle = lambda: True
    hand_over_frontend(monkeypatch, jax_engine=jeng)
    teng = WindowedSlamEngine(tcfg, enable_loop_closing=True, device="cpu",
                              window=4)
    teng._mapper_idle = lambda: True
    for i, (l, r) in enumerate(frames):
        jeng.track_stereo(l, r, 0.1 * i)
        teng.track_stereo(l, r, 0.1 * i)
    jeng.flush()
    teng.flush()
    assert teng.ms.K == 1024 and teng.ms.P == 1 << 17
    assert jeng.state == teng.state == 2
    got = (teng.stats["kf_inserted"], teng.n_kfs, teng.n_live_points)
    want = (jeng.stats["kf_inserted"], jeng.n_kfs, jeng.n_live_points)
    assert got == want, (got, want)
    est_t, est_j = teng.frame_poses(), jeng.frame_poses()
    assert sum(T is not None for T in est_t) == \
        sum(T is not None for T in est_j) == N_ENGINE
    gap = max(np.linalg.norm(Tt[:3, :3].T @ Tt[:3, 3]
                             - Tj[:3, :3].T @ Tj[:3, 3])
              for Tt, Tj in zip(est_t, est_j))
    t_ate, j_ate = sd.circuit_ate(est_t, poses), sd.circuit_ate(est_j, poses)
    assert gap < 0.01, gap
    assert abs(t_ate - j_ate) < 0.01, (t_ate, j_ate)
    assert t_ate < 0.1, (t_ate, j_ate)


# ------------------------------------------------------------------ slow --

@pytest.mark.slow
@pytest.mark.parametrize("max_kf,max_mp", [(128, 1 << 15), (1024, 1 << 17)],
                         ids=["128-slots", "1024-slots"])
def test_circuit_closes_loop_and_stays_bounded_on_the_port(max_kf, max_mp):
    """tests/test_scale_circuit.py on the port (its scene, configuration
    and bars), at that test's capacity and at the circuit's."""
    cfg = tconfig.SlamConfig(
        camera=tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                                    bf=75.0, width=320, height=240,
                                    fps=10.0, th_depth=40.0),
        orb=tconfig.OrbConfig(n_features=600),
        capacity=tconfig.CapacityConfig(max_keyframes=max_kf,
                                        max_map_points=max_mp,
                                        local_ba_keyframes=8,
                                        local_ba_points=2048),
        sensor=tconfig.STEREO)
    rng = np.random.default_rng(0)
    world, poses = sd.small_circuit(rng)
    n = len(poses)
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, device="cpu",
                             window=4)
    for i, T in enumerate(poses):
        l, r = synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                             noise=1.0)
        eng.track_stereo(l, r, timestamp=0.1 * i)
    eng.flush()
    eng.finish_gba()
    est = eng.frame_poses()
    tracked = sum(p is not None for p in est)
    assert tracked >= 0.95 * n, (tracked, n, eng.stats)
    assert eng.stats.get("loops_closed", 0) >= 1, eng.stats
    assert eng.n_kfs <= cfg.capacity.max_keyframes
    assert eng.stats["kf_inserted"] >= 30, eng.stats
    ate = sd.circuit_ate(est, poses)
    assert ate < 1.5, (ate, eng.stats)
