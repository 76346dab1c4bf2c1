"""The port's ``System`` facade on the CPU, and its quaternion functions
against the JAX package.

Tolerances: ``quat_from_mat``, ``mat_from_quat``, ``quat_mul`` and
``euler_from_quat`` against JAX at 1e-6 (float32 inputs), on random
rotations and on rotations within 1e-3 rad of 180°, so that both kinds
of ``quat_from_mat`` branch run (the trace one and the largest-diagonal
ones); TrackIRD's HPose world position within 0.15 m of the true camera
centre remapped as System.cc:298-319 does; the world-frame covariance
keeps the spectrum (rtol 1e-4) and ``cov_w[3, 3] == cov[5, 5]`` (rtol
1e-6), as tests/test_extras.py:186-217; the trajectory savers write one
line per tracked frame, one per live keyframe.  ``change_calibration``
and ``reset`` are checked on the port alone: the JAX ones are
tests/test_system.py's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam2_tpu.utils import lie as jlie
from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, RGBD, STEREO, SlamConfig)
from orbslam2_tpu_torch.runtime import tracking
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.utils import lie as tlie
from orbslam2_tpu_torch.utils import synthetic

torch.set_num_threads(2)

CAM = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                   width=320, height=240, fps=10.0, th_depth=60.0)
# slightly other intrinsics, as tests/test_system.py:160-161 (scaled)
CAM2 = CameraConfig(fx=227.5, fy=227.5, cx=159.0, cy=121.0, bf=75.5,
                    width=320, height=240, fps=10.0, th_depth=60.0)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=200),
                 capacity=CapacityConfig(max_keyframes=8,
                                         max_map_points=1024,
                                         local_ba_keyframes=4,
                                         local_ba_points=256),
                 sensor=STEREO)
N_FRAMES, STEP = 6, 0.3


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


# ----------------------------------------------------------- quaternions --

def _rotations(kind: str, n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "random":
        w = rng.normal(size=(n, 3))
        w *= (rng.uniform(0.0, np.pi, n) / np.linalg.norm(w, axis=1))[:, None]
        R = np.stack([_so3(v) for v in w])
    else:                           # within 1e-3 rad of a half turn
        a = rng.normal(size=(n, 3))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        R = np.stack([(2 * np.outer(v, v) - np.eye(3)) @ _so3(e) for v, e in
                      zip(a, rng.normal(0, 1e-3 / np.sqrt(3), (n, 3)))])
    return R.astype(np.float32)


def _so3(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


@pytest.mark.parametrize("kind", ["random", "near_180"])
def test_quaternions_match_jax(kind):
    R = _rotations(kind)
    tr = np.trace(R, axis1=1, axis2=2)
    if kind == "random":            # both the trace and a diagonal branch
        assert (tr > 0).any() and (tr <= 0).any()
    else:                           # every diagonal branch, no trace one
        assert (tr <= 0).all()
        assert len(set(np.argmax(np.diagonal(R, axis1=1, axis2=2),
                                 axis=1).tolist())) == 3
    q_j = np.asarray(jlie.quat_from_mat(jnp.asarray(R)))
    q_t = tlie.quat_from_mat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(q_t, q_j, atol=1e-6)
    q_j = np.array(q_j)
    np.testing.assert_allclose(
        tlie.mat_from_quat(torch.from_numpy(q_j)).numpy(),
        np.asarray(jlie.mat_from_quat(jnp.asarray(q_j))), atol=1e-6)
    q2 = np.roll(q_j, 1, axis=0)
    np.testing.assert_allclose(
        tlie.quat_mul(torch.from_numpy(q_j), torch.from_numpy(q2)).numpy(),
        np.asarray(jlie.quat_mul(jnp.asarray(q_j), jnp.asarray(q2))),
        atol=1e-6)
    np.testing.assert_allclose(
        tlie.euler_from_quat(torch.from_numpy(q_j)).numpy(),
        np.asarray(jlie.euler_from_quat(jnp.asarray(q_j))), atol=1e-6)
    # the round trip gives the rotation back
    np.testing.assert_allclose(tlie.mat_from_quat(
        torch.from_numpy(q_t)).numpy(), R, atol=1e-5)


# ------------------------------------------------- TrackIRD, covariance --

@pytest.fixture(scope="module")
def ird():
    """An RGB-D System on the CPU after N_FRAMES frames through
    track_ird: (system, HPoses, true poses)."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(N_FRAMES, step=STEP)
    sys_ = System(None, None, sensor=RGBD, config=CFG, device="cpu")
    hps = []
    for i, T in enumerate(poses):
        g, d = synthetic.render_world(world, CAM, T, rng, 1.0,
                                      with_depth=True)
        hps.append(sys_.track_ird(_u8(g), d, 0.1 * i))
    return sys_, hps, poses


def test_track_ird_reports_the_world_frame(ird):
    sys_, hps, poses = ird
    assert sys_.get_tracking_state() == tracking.OK
    for hp, T in zip(hps, poses):
        assert hp is not None
        c = _centre(T)
        want = np.array([c[2], -c[0], -c[1]])    # System.cc:298-319
        assert np.linalg.norm(hp.position - want) < 0.15
        assert abs(np.linalg.norm(hp.quaternion) - 1.0) < 1e-9
    assert sys_.get_tracked_points() > 0
    assert sys_.get_map().shape[1] == 3 and sys_.map_changed()


def test_covariance_in_the_world_frame(ird):
    sys_, _, _ = ird
    cov = sys_.get_current_covariance()
    cov_w = sys_.get_current_covariance_world()
    assert cov.shape == cov_w.shape == (6, 6) and cov.dtype == np.float32
    assert np.all(np.linalg.eigvalsh((cov + cov.T) / 2) > -1e-8)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(cov)),
                               np.sort(np.linalg.eigvalsh(cov_w)), rtol=1e-4)
    np.testing.assert_allclose(cov_w[3, 3], cov[5, 5], rtol=1e-6)


def test_trajectory_savers_line_counts(ird, tmp_path):
    sys_, _, _ = ird
    sys_.save_trajectory_tum(str(tmp_path / "t.txt"))
    lines = (tmp_path / "t.txt").read_text().strip().splitlines()
    assert len(lines) == N_FRAMES and len(lines[0].split()) == 8
    sys_.save_trajectory_kitti(str(tmp_path / "k.txt"))
    lines = (tmp_path / "k.txt").read_text().strip().splitlines()
    assert len(lines) == N_FRAMES and len(lines[0].split()) == 12
    sys_.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    lines = (tmp_path / "kf.txt").read_text().strip().splitlines()
    assert len(lines) == int(sys_.engine.ms.kf_valid.sum()) >= 1


# ------------------------------------------------- calibration and reset --

def _settings(tmp_path, cam):
    path = tmp_path / "new.yaml"
    path.write_text(f"""%YAML:1.0
Camera.fx: {cam.fx}
Camera.fy: {cam.fy}
Camera.cx: {cam.cx}
Camera.cy: {cam.cy}
Camera.bf: {cam.bf}
Camera.fps: {cam.fps}
Camera.width: {cam.width}
Camera.height: {cam.height}
ThDepth: {cam.th_depth}
""")
    return str(path)


def _stereo_frames(n=N_FRAMES + 2):
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(n, step=STEP)
    return world, poses, rng


def test_change_calibration_keeps_the_map(tmp_path):
    """Tracking::ChangeCalibration on the per-frame engine: the engine is
    rebuilt on the same device with the new camera, the map, counters,
    trajectory and loop-closing DB carry over, and tracking goes on."""
    world, poses, rng = _stereo_frames()
    sys_ = System(None, None, sensor=STEREO, config=CFG, device="cpu")
    for i in range(4):
        sys_.track_stereo(*synthetic.render_world_stereo(
            world, CAM, poses[i], rng, 1.0), 0.1 * i)
    old = sys_.engine
    kfs, ms, db = old.n_kfs, old.ms, old.loop_closer.db
    assert kfs >= 1
    sys_.change_calibration(_settings(tmp_path, CAM2))
    eng = sys_.engine
    assert eng is not old and type(eng) is type(old)
    assert sys_.cfg.camera.fx == eng.cfg.camera.fx == CAM2.fx
    assert eng.device == old.device and eng.n_kfs == kfs and eng.ms is ms
    assert eng.loop_closer.db is db and len(eng.trajectory) == 4
    for i in range(4, 6):
        out = sys_.track_stereo(*synthetic.render_world_stereo(
            world, CAM2, poses[i], rng, 1.0), 0.1 * i)
    assert out is not None and sys_.get_tracking_state() == tracking.OK


def test_change_calibration_keeps_held_slots_on_the_windowed_engine(
        tmp_path):
    """On the windowed engine: flushed first under the old calibration,
    the window size kept, and the port's held keyframe slots (culled,
    still measured against by an unretired window) neither lost nor
    freed while in use.  A slot held by the window in flight is freed by
    the flush, which retires that window; one still held after the flush
    (scripted here) is carried over, and freed when its window is done."""
    world, poses, rng = _stereo_frames()
    sys_ = System(None, None, sensor=STEREO, config=CFG, device="cpu")
    sys_.engine = WindowedSlamEngine(CFG, device="cpu", window=2)
    for i in range(5):
        sys_.track_stereo(*synthetic.render_world_stereo(
            world, CAM, poses[i], rng, 1.0), 0.1 * i)
    old = sys_.engine
    assert old._pending is not None and old._window_refs == [old.ref_kf]
    held = max(old._free_kf_slots)
    old._free_kf_slots.discard(held)
    old._held_slots = {held}
    sys_.change_calibration(_settings(tmp_path, CAM2))
    eng = sys_.engine
    assert isinstance(eng, WindowedSlamEngine) and eng.window == 2
    assert old._buf == [] and old._pending is None      # flushed
    assert eng._held_slots == set() and eng._window_refs == []
    assert held in eng._free_kf_slots
    assert sys_.cfg.camera.fx == CAM2.fx and len(eng.trajectory) == 5

    eng._free_kf_slots.discard(held)
    eng._held_slots, eng._window_refs = {held}, [eng.ref_kf]
    sys_.change_calibration(_settings(tmp_path, CAM))
    new = sys_.engine
    assert new._held_slots == {held} and held not in new._free_kf_slots
    new._window_done(new._window_refs[0])
    assert new._held_slots == set() and held in new._free_kf_slots
    for i in range(5, 8):
        sys_.track_stereo(*synthetic.render_world_stereo(
            world, CAM, poses[i], rng, 1.0), 0.1 * i)
    assert sys_.get_tracking_state() == tracking.OK
    assert len(new.frame_poses()) == 8


def test_reset_keeps_the_device(monkeypatch):
    """reset() builds the new engine on the engine's device; with no CUDA
    device a rebuild on the default (the card) would raise."""
    sys_ = System(None, None, sensor=STEREO, config=CFG, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    old = sys_.engine
    sys_.reset()
    assert sys_.engine is not old
    assert sys_.device == sys_.engine.loop_closer.device == \
        torch.device("cpu")
    assert sys_.engine.ms.kf_valid.device.type == "cpu"
    assert sys_.engine.state == tracking.NO_IMAGES_YET
