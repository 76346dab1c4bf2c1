"""The port's matrix-free CG Schur solver and the GBA's switch to it,
against the port's dense solve and the JAX package.

Tolerances:

  * ``bundle_adjust(solver="cg")`` on the tests/test_bundle.py problems:
    against the port's dense solve, as test_bundle.py holds JAX's CG
    against JAX's dense (max translation errors within 5e-3 m, points
    2e-2 m); against JAX's CG, poses 1e-3 m / 1e-4 in rotation, points
    1e-2 m (float32 CG, other summation order), inlier masks identical
    on ≥ 99%;
  * ``_inv6x6``: 1e-5 relative to the JAX function and to
    ``numpy.linalg.inv``;
  * ``gba_chunk`` at 264 keyframe slots (past the 256 switch) and
    ``global_ba``, on a perturbed port-built stereo map carried to JAX
    with ``convert.py``: poses 1e-4 (3.1e-5 seen after ``global_ba``'s
    10 LM iterations, 1.2e-6 after one chunk).  Points are compared as
    seen from the gauge keyframe: bearing within 5e-5 rad (7.3e-6 seen);
    range within 5e-4 of itself nearer than the close-depth cutoff
    (th_depth · baseline = 20 m; 1.5e-4 seen), within 2e-2 of itself
    beyond it, where a 0.2 px disparity barely observes depth and 10 LM
    iterations still move a 400 m point by tens of metres (4.8e-3 seen);
    inlier masks identical.  The port's ``_schur_solve_dense`` is
    patched to raise and the size of every segment sum is recorded (none
    may exceed max(P, K)), so the test proves the CG path ran and built
    no [P, K, …] coupling.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.models import map_state as JM
from orbslam2_tpu.models import vocabulary as jvoc
from orbslam2_tpu.ops import bundle as jb
from orbslam2_tpu.runtime import gba as jgba
from orbslam2_tpu.runtime import loop_closing as jlc
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import map_state_from_numpy, to_numpy
from orbslam2_tpu_torch.models import vocabulary as tvoc
from orbslam2_tpu_torch.ops import bundle as tb
from orbslam2_tpu_torch.runtime import gba as tgba
from orbslam2_tpu_torch.runtime import loop_closing as tlc
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.utils import camera as tcam
from orbslam2_tpu_torch.utils import lie as tlie
from orbslam2_tpu_torch.utils import synthetic
from test_bundle import CAM_CFG, _make_ba_problem, _pose_errors
from test_torch_mapping import _port_problem

torch.set_num_threads(2)

TCAM = tcam.Camera.from_config(
    tconfig.CameraConfig(**dataclasses.asdict(CAM_CFG)))


@pytest.mark.parametrize("case", ["local", "gauge_fixed"])
def test_cg_matches_dense_and_jax_cg(case):
    rng = np.random.default_rng(0)
    kw, ba_kw, n_free = {}, {}, 6
    if case == "gauge_fixed":
        kw, n_free = dict(n_free=8, n_fixed=0), 8
        ba_kw = dict(fix_first_free=True)
    cam, prob, poses_true, _, _ = _make_ba_problem(rng, **kw)
    tprob = _port_problem(prob)
    dp, dx, _ = (x.numpy() for x in tb.bundle_adjust(
        TCAM, tprob, n_free=n_free, solver="dense", **ba_kw))
    cp, cx, ci = (x.numpy() for x in tb.bundle_adjust(
        TCAM, tprob, n_free=n_free, solver="cg", cg_iters=48, **ba_kw))
    jp, jx, ji = (np.asarray(x) for x in jb.bundle_adjust(
        cam, prob, n_free=n_free, solver="cg", cg_iters=48, **ba_kw))
    et_d, _ = _pose_errors(dp, poses_true, n_free)
    et_c, er_c = _pose_errors(cp, poses_true, n_free)
    # the port's CG converges to ground truth and onto its dense solve
    assert et_c.max() < 0.03 and er_c.max() < 0.1, (et_c, er_c)
    assert abs(et_c.max() - et_d.max()) < 5e-3
    np.testing.assert_allclose(cx, dx, atol=0.02)
    # ... and onto JAX's CG
    np.testing.assert_allclose(cp[:, :3, 3], jp[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(cp[:, :3, :3], jp[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(cx, jx, atol=1e-2)
    assert (ci == ji).mean() >= 0.99
    if case == "gauge_fixed":
        np.testing.assert_allclose(cp[0], np.asarray(prob.poses)[0],
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(cp[n_free:], np.asarray(prob.poses)[
            n_free:], atol=1e-7)


def test_inv6x6_matches_jax():
    rng = np.random.default_rng(3)
    B = rng.normal(size=(64, 6, 6)).astype(np.float32)
    A = (B @ B.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    got = tb._inv6x6(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb._inv6x6(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.linalg.inv(A.astype(np.float64)),
                               rtol=1e-5, atol=1e-5)


def test_unknown_solver_raises():
    _, prob, _, _, _ = _make_ba_problem(np.random.default_rng(0))
    with pytest.raises(ValueError, match="unknown solver"):
        tb.bundle_adjust(TCAM, _port_problem(prob), n_free=6,
                         solver="sparse")


# ------------------------------------------- full-map BA past 256 slots --

K_SLOTS = 264                   # past gba.py's 256-slot switch to CG
CAM = tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                           width=320, height=240, fps=10.0, th_depth=60.0)
TCFG = tconfig.SlamConfig(
    camera=CAM, orb=tconfig.OrbConfig(n_features=200),
    capacity=tconfig.CapacityConfig(max_keyframes=K_SLOTS,
                                    max_map_points=2048,
                                    local_ba_keyframes=4,
                                    local_ba_points=512),
    sensor=tconfig.STEREO)
JCFG = SlamConfig(camera=CameraConfig(**dataclasses.asdict(CAM)),
                  orb=OrbConfig(n_features=200),
                  capacity=CapacityConfig(**dataclasses.asdict(
                      TCFG.capacity)),
                  sensor=STEREO)


@pytest.fixture(scope="module")
def big_map():
    """A stereo map of 8 frames at 264 keyframe slots, built by the port
    on the CPU, then perturbed (keyframes but the first, every point) so
    that the full-map BA has work to do."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    eng = SlamEngine(TCFG, enable_loop_closing=False, device="cpu")
    for i, T in enumerate(synthetic.straight_trajectory(8, step=0.3)):
        assert eng.track_stereo(*synthetic.render_world_stereo(
            world, CAM, T, rng, 1.0), 0.1 * i) is not None, i
    d = to_numpy(eng.ms)
    r = np.random.default_rng(1)
    for k in np.flatnonzero(d["kf_valid"])[1:]:
        xi = np.concatenate([r.normal(0, 0.01, 3),
                             r.normal(0, 0.05, 3)]).astype(np.float32)
        d["kf_pose"][k] = tlie.se3_exp(torch.from_numpy(xi)).numpy() \
            @ d["kf_pose"][k]
    d["mp_pos"] = (d["mp_pos"] + r.normal(0, 0.05, d["mp_pos"].shape)
                   * d["mp_valid"][:, None]).astype(np.float32)
    assert int(d["kf_valid"].sum()) >= 3
    return d


def _jax_map(d):
    return JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_map_close(tms, jms, d):
    kv, pv = d["kf_valid"], d["mp_valid"]
    tp, jp = tms.kf_pose.numpy()[kv], np.asarray(jms.kf_pose)[kv]
    assert np.abs(tp - d["kf_pose"][kv]).max() > 1e-3   # the BA moved them
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    c0 = np.linalg.inv(d["kf_pose"][0])[:3, 3]     # the gauge keyframe
    a = tms.mp_pos.numpy()[pv] - c0
    b = np.asarray(jms.mp_pos)[pv] - c0
    ra, rb = np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)
    bearing = np.linalg.norm(a / ra[:, None] - b / rb[:, None], axis=1)
    assert bearing.max() < 5e-5, bearing.max()
    rel = np.abs(ra - rb) / ra
    near = ra < CAM.th_depth * CAM.baseline
    assert near.sum() > 100 and rel[near].max() < 5e-4, rel[near].max()
    assert rel[~near].max() < 2e-2, rel[~near].max()


@pytest.fixture
def cg_only(monkeypatch):
    """The dense solve raises; the sizes of every segment sum are kept."""
    sizes = []
    seg = tb._segment_sum

    def recording(vals, idx, n, ok):
        sizes.append(n)
        return seg(vals, idx, n, ok)

    def refuse(*a, **k):
        raise AssertionError("the dense Schur solve ran")

    monkeypatch.setattr(tb, "_segment_sum", recording)
    monkeypatch.setattr(tb, "_schur_solve_dense", refuse)
    return sizes


@pytest.mark.parametrize("use_huber", [True, False])
def test_gba_chunk_past_256_slots_takes_cg_and_matches_jax(big_map, cg_only,
                                                           use_huber):
    d = big_map
    obs = np.ones(K_SLOTS * TCFG.orb.n_features_padded, bool)
    jchunk, _ = jgba.make_gba_fns(JCFG)
    jms, jinl = jchunk(_jax_map(d), jnp.asarray(obs), use_huber=use_huber)
    tchunk, _ = tgba.make_gba_fns(TCFG)
    tms, tinl = tchunk(map_state_from_numpy(d), torch.from_numpy(obs),
                       use_huber)
    P = TCFG.capacity.max_map_points
    assert cg_only and max(cg_only) <= max(P, K_SLOTS), max(cg_only)
    _assert_map_close(tms, jms, d)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))


def test_global_ba_matches_jax(big_map, cg_only):
    d = big_map
    j_global_ba = jlc.make_loop_fns(JCFG, jvoc.default_vocabulary())[6]
    jms = j_global_ba(_jax_map(d))
    tfns = tlc.make_loop_fns(TCFG, tvoc.default_vocabulary())
    tms = tfns.global_ba(map_state_from_numpy(d))
    assert cg_only
    _assert_map_close(tms, jms, d)
    # the gauge keyframe does not move
    k0 = 0
    assert d["kf_valid"][k0]
    np.testing.assert_allclose(tms.kf_pose[k0].numpy(), d["kf_pose"][k0],
                               atol=1e-7)
