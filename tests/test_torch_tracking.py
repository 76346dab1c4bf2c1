"""Geometry, pose optimization, map-state updates and the tracking steps of
the port against the JAX package, on inputs made with numpy from a seed.

Tolerances: lie/camera 1e-5 (absolute and relative, float32), except
undistort_points at 1e-4 px (ten float32 Gauss-Newton steps, whose
rounding XLA may contract into FMAs and torch does not); pose
optimization pose 1e-4 with the inlier mask exact; map-state updates
exact for integer and bool fields, 1e-6 for float fields (same
arithmetic, same order); the tracking steps on a JAX-built map: pose
1e-4, associations identical on ≥ 99% of the features.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.models import frame as jframe
from orbslam2_tpu.models import map_state as jM
from orbslam2_tpu.ops import pose_opt as jpo
from orbslam2_tpu.runtime import tracking as jtr
from orbslam2_tpu.utils import camera as jcam
from orbslam2_tpu.utils import lie as jlie
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import (frame_data_from_numpy,
                                        map_state_from_numpy, to_numpy,
                                        to_tensor)
from orbslam2_tpu_torch.models import map_state as tM
from orbslam2_tpu_torch.ops import pose_opt as tpo
from orbslam2_tpu_torch.runtime import tracking as ttr
from orbslam2_tpu_torch.utils import camera as tcam
from orbslam2_tpu_torch.utils import lie as tlie

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _twists(rng, n):
    return np.concatenate([rng.normal(0, 0.5, (n, 3)),
                           rng.normal(0, 2.0, (n, 3))], -1).astype(np.float32)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------------ lie ----

@pytest.mark.parametrize("fn", ["se3_exp", "se3_log", "se3_inv", "hat",
                                "transform_points"])
def test_lie_matches_jax(fn):
    rng = np.random.default_rng(0)
    xi = _twists(rng, 64)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    if fn == "se3_exp":
        got, ref = tlie.se3_exp(to_tensor(xi)), jlie.se3_exp(jnp.asarray(xi))
    elif fn == "se3_log":
        got, ref = tlie.se3_log(to_tensor(T)), jlie.se3_log(jnp.asarray(T))
    elif fn == "se3_inv":
        got, ref = tlie.se3_inv(to_tensor(T)), jlie.se3_inv(jnp.asarray(T))
    elif fn == "hat":
        got, ref = tlie.hat(to_tensor(xi[:, :3])), jlie.hat(
            jnp.asarray(xi[:, :3]))
    else:
        pts = rng.normal(0, 5, (100, 3)).astype(np.float32)
        got = tlie.transform_points(to_tensor(T[0]), to_tensor(pts))
        ref = jlie.transform_points(jnp.asarray(T[0]), jnp.asarray(pts))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_transform_points_refuses_batched_poses():
    """The explicit batch rule: one pose per call (the JAX ndim dispatch is
    not copied)."""
    with pytest.raises(ValueError):
        tlie.transform_points(torch.eye(4).repeat(3, 1, 1), torch.zeros(3, 3))


# --------------------------------------------------------------- camera ----

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480)
DIST = dataclasses.replace(CAM, k1=-0.28, k2=0.07, p1=1e-3, p2=-2e-3)


def _tcfg(cfg):
    return tconfig.CameraConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("fn", ["project", "project_stereo", "backproject",
                                "in_frustum", "undistort_points",
                                "bounds"])
def test_camera_matches_jax(fn):
    rng = np.random.default_rng(1)
    jc, tc = jcam.Camera.from_config(CAM), tcam.Camera.from_config(_tcfg(CAM))
    pc = np.stack([rng.uniform(-5, 5, 200), rng.uniform(-4, 4, 200),
                   rng.uniform(1, 30, 200)], -1).astype(np.float32)
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    if fn in ("project", "project_stereo"):
        got = getattr(tcam, fn)(tc, to_tensor(pc))
        ref = getattr(jcam, fn)(jc, jnp.asarray(pc))
    elif fn == "backproject":
        got = tcam.backproject(tc, to_tensor(uv), to_tensor(pc[:, 2]))
        ref = jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(pc[:, 2]))
    elif fn == "in_frustum":
        T = np.asarray(jlie.se3_exp(jnp.asarray(_twists(rng, 1)[0] * 0.1)))
        nrm = rng.normal(0, 1, (200, 3)).astype(np.float32)
        lo = rng.uniform(0, 10, 200).astype(np.float32)
        hi = lo + rng.uniform(0, 30, 200).astype(np.float32)
        got = tcam.in_frustum(tc, to_tensor(T), to_tensor(pc),
                              to_tensor(lo), to_tensor(hi), to_tensor(nrm))
        ref = jcam.in_frustum(jc, jnp.asarray(T), jnp.asarray(pc),
                              jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(nrm))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
        return
    elif fn == "undistort_points":
        jd, td = jcam.Camera.from_config(DIST), tcam.Camera.from_config(
            _tcfg(DIST))
        np.testing.assert_allclose(
            tcam.undistort_points(td, to_tensor(uv)).numpy(),
            np.asarray(jcam.undistort_points(jd, jnp.asarray(uv))),
            rtol=1e-5, atol=1e-4)
        return
    else:       # undistorted-image bounds of a distorted camera
        jd, td = jcam.Camera.from_config(DIST), tcam.Camera.from_config(
            _tcfg(DIST))
        got = np.array([td.min_x, td.max_x, td.min_y, td.max_y])
        ref = np.array([jd.min_x, jd.max_x, jd.min_y, jd.max_y], np.float64)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


# ------------------------------------------------------------- pose opt ----

def test_pose_optimization_matches_jax():
    rng = np.random.default_rng(2)
    n = 300
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.02, -0.03, 0.01, 0.1, -0.05, 0.3], np.float32))))
    pts = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                    rng.uniform(4, 25, n)], -1).astype(np.float32)
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    u = 450.0 * pc[:, 0] / pc[:, 2] + 320.0
    v = 450.0 * pc[:, 1] / pc[:, 2] + 240.0
    uv = np.stack([u, v], -1) + rng.normal(0, 0.5, (n, 2))
    ur = np.where(rng.random(n) < 0.5, u - 150.0 / pc[:, 2]
                  + rng.normal(0, 0.5, n), -1.0)
    out = rng.random(n) < 0.1
    uv[out] += rng.uniform(15, 40, (out.sum(), 2))
    lvl = rng.integers(0, 8, n)
    obs = dict(pts_w=pts, uv=uv.astype(np.float32), ur=ur.astype(np.float32),
               inv_sigma2=(1.0 / 1.44 ** lvl).astype(np.float32),
               valid=rng.random(n) < 0.97)
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.01, 0.0, -0.01, 0.05, 0.05, -0.1], np.float32)))) @ T_true
    jT, jinl, jn = jax.jit(lambda T, o: jpo.pose_optimization(
        jcam.Camera.from_config(CAM), T, o))(
        jnp.asarray(T0), jpo.PoseObs(**{k: jnp.asarray(v)
                                        for k, v in obs.items()}))
    tT, tinl, tn = tpo.pose_optimization(
        tcam.Camera.from_config(_tcfg(CAM)), to_tensor(T0),
        tpo.PoseObs(**{k: to_tensor(v) for k, v in obs.items()}))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) and int(tn) > 0.8 * n
    assert np.abs(tT.numpy() - T_true).max() < 0.02


# ------------------------------------------------------------ map state ----

SMALL = SlamConfig(orb=OrbConfig(n_features=200),
                   capacity=CapacityConfig(max_keyframes=4, max_map_points=96))


def _small_tcfg():
    return tconfig.SlamConfig(
        orb=tconfig.OrbConfig(n_features=200),
        capacity=tconfig.CapacityConfig(max_keyframes=4, max_map_points=96))


def _kf_arrays(rng, N):
    return dict(
        xy=rng.uniform(0, 640, (N, 2)).astype(np.float32),
        level=rng.integers(0, 8, N).astype(np.int32),
        angle=rng.uniform(-3, 3, N).astype(np.float32),
        desc=rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32),
        kp_valid=rng.random(N) < 0.9,
        ur=np.where(rng.random(N) < 0.6, rng.uniform(0, 640, N),
                    -1.0).astype(np.float32),
        depth=rng.uniform(1, 20, N).astype(np.float32))


def _assert_map_equal(tms, jms):
    got = to_numpy(tms)
    for k, ref in jms._asdict().items():
        ref = np.asarray(ref)
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(got[k], ref, atol=1e-6, rtol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref, err_msg=k)


def test_map_state_scripted_sequence():
    rng = np.random.default_rng(3)
    N, P = SMALL.orb.n_features_padded, SMALL.capacity.max_map_points
    sf, nl = 1.2, 8
    jms, tms = jM.empty_map(SMALL), tM.empty_map(_small_tcfg())
    _assert_map_equal(tms, jms)

    # allocate more points than fit: the overflow requests are masked
    want = rng.random(N) < 0.5
    js_, jok = jM.alloc_mp_slots(jms, jnp.asarray(want))
    ts_, tok = tM.alloc_mp_slots(tms, to_tensor(want))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ts_.numpy()[tok.numpy()],
                                  np.asarray(js_)[np.asarray(jok)])
    pos = rng.normal(0, 5, (N, 3)).astype(np.float32)
    jms = jM.add_map_points(jms, js_, jnp.asarray(pos), jok,
                            ref_kf=jnp.zeros(N, jnp.int32))
    tms = tM.add_map_points(tms, ts_, to_tensor(pos), tok, ref_kf=0)
    _assert_map_equal(tms, jms)

    assoc = np.where(np.asarray(jok), np.asarray(js_), -1).astype(np.int32)
    for kf in (1, 2):
        a = _kf_arrays(rng, N)
        kp_mp = assoc.copy()
        if kf == 2:           # duplicate associations: two features, one point
            kp_mp[rng.permutation(N)[:40]] = kp_mp[rng.permutation(N)[:40]]
        T = np.asarray(jlie.se3_exp(jnp.asarray(_twists(rng, 1)[0] * 0.1)))
        jms = jM.add_keyframe(jms, jnp.int32(kf), jnp.asarray(T),
                              jnp.int32(10 * kf), jnp.float32(kf),
                              *(jnp.asarray(a[k]) for k in a),
                              jnp.asarray(kp_mp), jnp.int32(kf - 1))
        tms = tM.add_keyframe(tms, kf, to_tensor(T), 10 * kf, float(kf),
                              *(to_tensor(a[k]) for k in a),
                              to_tensor(kp_mp), kf - 1)
        ok = (kp_mp >= 0) & a["kp_valid"]
        fi = np.arange(N, dtype=np.int32)
        jms = jM.add_observations(jms, jnp.int32(kf), jnp.asarray(fi),
                                  jnp.asarray(kp_mp), jnp.asarray(ok), sf, nl)
        tms = tM.add_observations(tms, kf, to_tensor(fi), to_tensor(kp_mp),
                                  to_tensor(ok), sf, nl)
        _assert_map_equal(tms, jms)

    rm = rng.random(N) < 0.2
    fi = rng.permutation(N).astype(np.int32)
    jms = jM.remove_observations(jms, jnp.int32(1), jnp.asarray(fi),
                                 jnp.asarray(rm))
    tms = tM.remove_observations(tms, 1, to_tensor(fi), to_tensor(rm))
    _assert_map_equal(tms, jms)

    bad = rng.random(P) < 0.1
    jms = jM.invalidate_map_points(jms, jnp.asarray(bad))
    tms = tM.invalidate_map_points(tms, to_tensor(bad))
    _assert_map_equal(tms, jms)

    o2n = np.where(rng.random(P) < 0.1, rng.integers(0, P, P), -1
                   ).astype(np.int32)
    jms = jM.replace_map_points(jms, jnp.asarray(o2n))
    tms = tM.replace_map_points(tms, to_tensor(o2n))
    _assert_map_equal(tms, jms)

    kfs = np.array([1, 2, 1], np.int32)
    ok2d = rng.random((3, N)) < 0.15
    jms = jM.remove_observations_batch(jms, jnp.asarray(kfs),
                                       jnp.asarray(ok2d))
    tms = tM.remove_observations_batch(tms, to_tensor(kfs), to_tensor(ok2d))
    _assert_map_equal(tms, jms)

    # read-side helpers on the final state
    mask = rng.random(P) < 0.4
    np.testing.assert_array_equal(
        tM.kf_share_counts(tms, to_tensor(mask)).numpy(),
        np.asarray(jM.kf_share_counts(jms, jnp.asarray(mask))))
    for kf in (1, 2):
        np.testing.assert_array_equal(
            tM.covisibility_row(tms, kf).numpy(),
            np.asarray(jM.covisibility_row(jms, jnp.int32(kf))))
        np.testing.assert_array_equal(
            tM.points_of_kf(tms, kf).numpy(),
            np.asarray(jM.points_of_kf(jms, jnp.int32(kf))))
    kmask = np.array([False, True, True, False])
    np.testing.assert_array_equal(
        tM.points_of_kfs(tms, to_tensor(kmask)).numpy(),
        np.asarray(jM.points_of_kfs(jms, jnp.asarray(kmask))))
    for cap in (5, 40, 200):
        ji, jo = jM.compact_mask(jnp.asarray(mask), cap)
        ti, to = tM.compact_mask(to_tensor(mask), cap)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------- tracking on a JAX map ----

TRACK_CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                         width=640, height=480, fps=10.0, th_depth=60.0)
TRACK_CFG = SlamConfig(
    camera=TRACK_CAM, orb=OrbConfig(n_features=400),
    capacity=CapacityConfig(max_keyframes=8, max_map_points=2048,
                            local_ba_keyframes=4, local_ba_points=512,
                            track_candidates=1024, fuse_candidates=1024),
    sensor=STEREO)


def _tcfg_full(cfg):
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=tconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
        capacity=tconfig.CapacityConfig(**dataclasses.asdict(cfg.capacity)),
        sensor=cfg.sensor)


@pytest.fixture(scope="module")
def jax_map():
    """A JAX-built map (stereo init on frame 0) and the JAX frame 1."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(2, step=0.25)
    frames = [synthetic.render_world_stereo(world, TRACK_CAM, T, rng, 1.0)
              for T in poses]
    front = jframe.make_frontend_stereo(TRACK_CFG)
    fds = [front(jnp.asarray(l.astype(np.float32)),
                 jnp.asarray(r.astype(np.float32))) for l, r in frames]
    fns = jtr.make_tracking_fns(TRACK_CFG)
    ms, assoc, _ = fns.init_stereo(jM.empty_map(TRACK_CFG), fds[0],
                                   jnp.eye(4, dtype=jnp.float32),
                                   jnp.int32(0), jnp.float32(0.0))
    return fns, ms, assoc, fds[1], poses[1]


def _port_inputs(ms, fd):
    return (map_state_from_numpy({k: np.asarray(v)
                                  for k, v in ms._asdict().items()}),
            frame_data_from_numpy({k: np.asarray(v)
                                   for k, v in fd._asdict().items()}))


def _compare_track(tres, jres):
    np.testing.assert_allclose(tres.Tcw.numpy(), np.asarray(jres.Tcw),
                               atol=1e-4, rtol=0)
    ta, ja = tres.assoc.numpy(), np.asarray(jres.assoc)
    assert (ta == ja).mean() >= 0.99, (ta == ja).mean()
    assert (ja >= 0).sum() > 100
    ts_, js_ = ttr.Summary.of(tres), jtr.Summary(np.asarray(jres.summary))
    assert abs(ts_.n_inliers_map - js_.n_inliers_map) <= \
        max(2, 0.01 * js_.n_inliers_map)
    assert (ts_.ref_tracked2, ts_.ref_tracked3) == \
        (js_.ref_tracked2, js_.ref_tracked3)


def test_track_ref_kf_on_jax_map(jax_map):
    jfns, jms, _, jfd, _ = jax_map
    tms, tfd = _port_inputs(jms, jfd)
    eye = np.eye(4, dtype=np.float32)
    jres = jfns.track_ref_kf(jms, jfd, jnp.int32(0), jnp.asarray(eye))
    tfns = ttr.make_tracking_fns(_tcfg_full(TRACK_CFG))
    tres = tfns.track_ref_kf(tms, tfd, 0, to_tensor(eye))
    _compare_track(tres, jres)


def test_track_body_on_jax_map(jax_map):
    jfns, jms, jassoc, jfd, _ = jax_map
    tms, tfd = _port_inputs(jms, jfd)
    N = TRACK_CFG.orb.n_features_padded
    eye = np.eye(4, dtype=np.float32)
    jres = jfns.track(jms, jfd, jnp.asarray(eye), jassoc,
                      jnp.ones(N, bool), jnp.int32(0))
    tfns = ttr.make_tracking_fns(_tcfg_full(TRACK_CFG))
    tres = tfns.track(tms, tfd, to_tensor(eye), to_tensor(np.asarray(jassoc)),
                      torch.ones(N, dtype=torch.bool), 0)
    _compare_track(tres, jres)
    np.testing.assert_array_equal(tres.visible_mask.numpy(),
                                  np.asarray(jres.visible_mask))
