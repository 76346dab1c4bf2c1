"""Map files interchange between the JAX package and the port, and the
port's ``System`` relocalizes on a map that the JAX package saved.

One JAX stereo ``System`` map (400 features, 16 keyframes, 4096 points,
8 frames of the corridor, as tests/test_system.py:136-151) is built once
for the module and shared.

Tolerances: the map file round trip (JAX → port → JAX) is exact: the
same keys, arrays, dtypes and counters; the port relocalizes within
0.1 m of the true camera centre (the bar of tests/test_system.py:114;
measured 0.0183 m); ``pose_covariance`` against JAX's on the same (map,
frame, pose, associations): relative Frobenius error ≤ 1e-3 (measured
2.3e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.runtime import serialization as jser
from orbslam2_tpu.runtime.system import System as JaxSystem
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import map_state as TM
from orbslam2_tpu_torch.runtime import serialization as tser
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime.system import System as TorchSystem

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=400),
                 capacity=CapacityConfig(max_keyframes=16,
                                         max_map_points=4096,
                                         local_ba_keyframes=4,
                                         local_ba_points=1024),
                 sensor=STEREO)
N_FRAMES, STEP = 8, 0.3
RELOC_FRAME = 3
COV_RTOL = 1e-3


def port_cfg(cfg: SlamConfig) -> tconfig.SlamConfig:
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=tconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
        capacity=tconfig.CapacityConfig(**dataclasses.asdict(cfg.capacity)),
        sensor=cfg.sensor, map_file=cfg.map_file)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def jax_map(tmp_path_factory):
    """(JAX System after 8 frames, its saved map file, world, poses)."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(N_FRAMES, step=STEP)
    sys_ = JaxSystem(None, None, sensor=STEREO, config=CFG)
    for i, T in enumerate(poses):
        left, right = synthetic.render_world_stereo(world, CAM, T, rng, 1.0)
        sys_.track_stereo(left, right, 0.1 * i)
    assert sys_.engine.n_kfs >= 2 and sys_.engine.loop_closer is not None
    path = tmp_path_factory.mktemp("jaxmap") / "map.npz"
    sys_.save_map(str(path))
    return sys_, str(path), world, poses


def _assert_same_file(a: str, b: str):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_jax_map_round_trips_through_the_port(jax_map, tmp_path):
    """JAX save_map → port load_map → port save_map → JAX load_map: the
    same keys, arrays, dtypes (descriptor words uint32) and counters."""
    jsys, path, _, _ = jax_map
    ms, db, counters = tser.load_map(path, "cpu")
    assert ms.kf_desc.dtype == torch.int32 and ms.kf_desc.device.type == "cpu"
    assert counters == {"n_kfs": jsys.engine.n_kfs,
                        "kf_ordinal": jsys.engine.kf_ordinal,
                        "frame_id": jsys.engine.frame_id}
    out = str(tmp_path / "port.npz")
    tser.save_map(out, ms, db, counters)
    _assert_same_file(path, out)
    jms, jdb, jcounters = jser.load_map(out)
    assert jcounters == counters
    for name, a, b in ((f"ms_{k}", v, getattr(jsys.engine.ms, k))
                       for k, v in jms._asdict().items()):
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    np.testing.assert_array_equal(np.asarray(jdb.bow),
                                  np.asarray(jsys.engine.loop_closer.db.bow))
    np.testing.assert_array_equal(
        np.asarray(jdb.valid), np.asarray(jsys.engine.loop_closer.db.valid))


def test_port_system_map_loads_in_jax(jax_map, tmp_path):
    """A map that the port's System saves (here the JAX map, loaded by a
    port System) reads back in the JAX package field for field, and in
    the port bit for bit."""
    _, path, _, _ = jax_map
    tsys = TorchSystem(None, None, sensor=STEREO,
                       config=port_cfg(CFG).replace(map_file=path),
                       device="cpu")
    out = str(tmp_path / "sys.npz")
    tsys.save_map(out)
    _assert_same_file(path, out)
    jms, jdb, _ = jser.load_map(out)
    assert np.asarray(jms.kf_desc).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(jms.kf_desc),
                                  tsys.engine.ms.kf_desc.numpy().view(
                                      np.uint32))
    np.testing.assert_array_equal(np.asarray(jdb.bow),
                                  tsys.engine.loop_closer.db.bow.numpy())
    ms, db, _ = tser.load_map(out, "cpu")
    for k in TM.MapState._fields:
        assert torch.equal(getattr(ms, k), getattr(tsys.engine.ms, k)), k
    assert torch.equal(db.bow, tsys.engine.loop_closer.db.bow)


def test_port_system_relocalizes_on_a_jax_map(jax_map):
    """A port System built with the JAX-saved map starts LOST in
    localization mode, relocalizes a re-rendered frame within 0.1 m, and
    the next frame does not grow the map."""
    _, path, world, poses = jax_map
    tsys = TorchSystem(None, None, sensor=STEREO,
                       config=port_cfg(CFG).replace(map_file=path),
                       device="cpu")
    eng = tsys.engine
    assert tsys.get_tracking_state() == ttracking.LOST
    assert eng.localization_only
    assert eng.last_assoc.shape == (CFG.orb.n_features_padded,)
    assert eng._free_kf_slots == set(
        np.where(~eng.ms.kf_valid.numpy())[0].tolist())
    rng = np.random.default_rng(7)
    T_back = poses[RELOC_FRAME]
    left, right = synthetic.render_world_stereo(world, CAM, T_back, rng, 1.0)
    Tcw = tsys.track_stereo(left, right, 50.0)
    assert Tcw is not None, "relocalization against the JAX map failed"
    d = np.linalg.norm(-Tcw[:3, :3].T @ Tcw[:3, 3]
                       + T_back[:3, :3].T @ T_back[:3, 3])
    assert d < 0.1, d
    assert eng.stats["reloc"] == 1
    kfs = eng.n_kfs
    left, right = synthetic.render_world_stereo(
        world, CAM, poses[RELOC_FRAME + 1], rng, 1.0)
    tsys.track_stereo(left, right, 50.1)
    assert eng.n_kfs == kfs
    assert tsys.get_tracked_points() > 0


def test_pose_covariance_matches_jax(jax_map):
    """The fixture's last (map, frame, pose, associations) through
    convert.py: the port's pose_covariance against JAX's."""
    jsys, _, _, _ = jax_map
    je = jsys.engine
    want = jsys.get_current_covariance()
    fns = ttracking.make_tracking_fns(port_cfg(CFG))
    got = fns.pose_covariance(
        convert.map_state_from_numpy(_np(je.ms)),
        convert.frame_data_from_numpy(_np(je.last_fd)),
        torch.tensor(np.asarray(je.last_Tcw, np.float32)),
        convert.to_tensor(je.last_assoc)).numpy()
    assert got.dtype == np.float32 and got.shape == (6, 6)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= COV_RTOL, err
