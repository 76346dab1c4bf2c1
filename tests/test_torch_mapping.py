"""Local mapping of the port against the JAX package: dense-Schur bundle
adjustment on the tests/test_bundle.py cases, and one whole
make_mapping_step on a map built by the JAX engine.

Tolerances: BA poses 1e-3 (translation, m) / points 1e-2 m between the
two (float32 LM whose segment sums run in another order; both must also
meet test_bundle.py's ground-truth bounds), observation inlier masks
identical on ≥ 99%.  Mapping step: the stats vector exact except the BA
outlier count (±2% of the observations), map-state integer fields
identical on ≥ 99% of their entries, poses 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.ops import bundle as jb
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import (frame_data_from_numpy,
                                        map_state_from_numpy, to_numpy,
                                        to_tensor)
from orbslam2_tpu_torch.ops import bundle as tb
from orbslam2_tpu_torch.runtime import local_mapping as tlm
from orbslam2_tpu_torch.utils import camera as tcam
from test_bundle import CAM_CFG, _make_ba_problem, _pose_errors

torch.set_num_threads(2)


def _port_problem(prob):
    d = {k: np.asarray(v) for k, v in prob._asdict().items()}
    d["cam_i"] = d["cam_i"].astype(np.int64)
    d["pt_i"] = d["pt_i"].astype(np.int64)
    return tb.BAProblem(**{k: to_tensor(v) for k, v in d.items()})


@pytest.mark.parametrize("case", ["converges", "improves", "gauge_fixed",
                                  "mono"])
def test_bundle_adjust_dense_matches_jax(case):
    rng = np.random.default_rng(0)
    kw, ba_kw, n_free = {}, {}, 6
    if case == "improves":
        kw = dict(pose_pert=0.03, pt_pert=0.1)
    elif case == "gauge_fixed":
        kw, n_free = dict(n_free=8, n_fixed=0), 8
        ba_kw = dict(fix_first_free=True, iters_a=10, iters_b=10)
    elif case == "mono":
        kw = dict(stereo=False, outlier_frac=0.0)
    cam, prob, poses_true, pts_true, _ = _make_ba_problem(rng, **kw)
    jp, jx, ji = (np.asarray(x) for x in jb.bundle_adjust(
        cam, prob, n_free=n_free, **ba_kw))
    tcam_ = tcam.Camera.from_config(
        tconfig.CameraConfig(**dataclasses.asdict(CAM_CFG)))
    tp, tx, ti = (x.numpy() for x in tb.bundle_adjust(
        tcam_, _port_problem(prob), n_free=n_free, **ba_kw))
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(tp[:, :3, :3], jp[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(tx, jx, atol=1e-2)
    assert (ti == ji).mean() >= 0.99
    et, er = _pose_errors(tp, poses_true, n_free)
    assert et.max() < (2.5e-2 if case == "mono" else 8e-3), et
    if n_free < len(tp):       # fixed anchors never move
        np.testing.assert_allclose(tp[n_free:], np.asarray(prob.poses)[
            n_free:], atol=1e-7)
    if case == "gauge_fixed":
        np.testing.assert_allclose(tp[0], np.asarray(prob.poses)[0],
                                   atol=1e-6)


CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=400),
                 capacity=CapacityConfig(max_keyframes=16,
                                         max_map_points=4096,
                                         local_ba_keyframes=8,
                                         local_ba_points=1024),
                 sensor=STEREO)


def _tcfg():
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(CAM)),
        orb=tconfig.OrbConfig(n_features=400),
        capacity=tconfig.CapacityConfig(**dataclasses.asdict(CFG.capacity)),
        sensor=STEREO)


def test_mapping_step_matches_jax():
    """The JAX engine tracks 6 frames (inserting keyframes); then both
    packages run one mapping step with BA and keyframe culling on."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(6, step=0.25)
    eng = JaxEngine(CFG, enable_loop_closing=False)
    for i, T in enumerate(poses):
        eng.track_stereo(*synthetic.render_world_stereo(world, CAM, T, rng,
                                                        1.0), 0.1 * i)
    assert eng.state == 2 and eng.kf_ordinal >= 2
    ms, fd = eng.ms, eng.last_fd
    slot = min(eng._free_kf_slots)
    P = CFG.capacity.max_map_points
    zp = jnp.zeros(P, jnp.int32)
    jms, jstats = eng.f_mapping_step(
        ms, fd, jnp.asarray(eng.last_Tcw), eng.last_assoc, jnp.int32(slot),
        jnp.int32(eng.kf_ordinal), jnp.int32(eng.ref_kf),
        jnp.int32(eng.frame_id), jnp.float32(1.0), jnp.bool_(True),
        jnp.bool_(True), zp, zp)
    jstats = np.asarray(jstats)

    step = tlm.make_mapping_step(_tcfg())
    tms, tstats = step(
        map_state_from_numpy({k: np.asarray(v)
                              for k, v in ms._asdict().items()}),
        frame_data_from_numpy({k: np.asarray(v)
                               for k, v in fd._asdict().items()}),
        to_tensor(eng.last_Tcw), to_tensor(np.asarray(eng.last_assoc)),
        slot, eng.kf_ordinal, eng.ref_kf, eng.frame_id, 1.0, True, True,
        torch.zeros(P, dtype=torch.int32), torch.zeros(P, dtype=torch.int32))
    tstats = tstats.numpy()
    assert jstats[0] > 0 and jstats[2] > 0, jstats   # inserted, triangulated
    keep = [0, 1, 2, 3, 5] + list(range(7, len(jstats)))
    np.testing.assert_array_equal(tstats[keep], jstats[keep])
    n_obs = int(np.sum(np.asarray(ms.kf_mp) >= 0))
    assert abs(int(tstats[4]) - int(jstats[4])) <= max(3, 0.02 * n_obs)
    assert abs(int(tstats[6]) - int(jstats[6])) <= max(3, 0.01 * jstats[6])

    got = to_numpy(tms)
    for k in ("kf_valid", "kf_parent", "kf_frame_id", "kf_mp", "mp_valid",
              "mp_n_obs", "mp_desc", "kf_desc", "mp_first_kf"):
        ref = np.asarray(getattr(jms, k))
        same = (got[k] == ref).reshape(ref.shape[0], -1).all(1).mean()
        assert same >= 0.99, (k, same)
    np.testing.assert_allclose(got["kf_pose"], np.asarray(jms.kf_pose),
                               atol=1e-3)
    live = got["mp_valid"] & np.asarray(jms.mp_valid)
    np.testing.assert_allclose(got["mp_pos"][live],
                               np.asarray(jms.mp_pos)[live], atol=5e-2)
