"""The port's stereo frontend against the JAX package's, on one synthetic
stereo pair.  Module tests feed the JAX pyramid level (or JAX features)
into the port so a one-ULP pyramid difference cannot flip a FAST or BRIEF
comparison; only the whole-frontend test compares end to end.

Tolerances: pyramid and blur 1e-4 (gray levels 0..255, float32 resize
sums in another order); FAST scores, NMS, keypoint selection, BRIEF bits
and the stereo match mask exact; angles: each package's within the
float32 summation bound of a float64 evaluation of the same 961 moment
terms (or 1e-4 rad where that bound is smaller; see ``_angle_tolerance``);
stereo u_right 1e-3 px and depth 1e-4 relative; whole-frontend keypoint
rows ≥ 99% identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraConfig, OrbConfig, SlamConfig
from orbslam2_tpu.models import frame as jframe
from orbslam2_tpu.ops import extractor as je
from orbslam2_tpu.ops import fast as jf
from orbslam2_tpu.ops import image as ji
from orbslam2_tpu.ops import stereo as js
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import to_tensor
from orbslam2_tpu_torch.models import frame as tframe
from orbslam2_tpu_torch.ops import extractor as te
from orbslam2_tpu_torch.ops import fast as tf
from orbslam2_tpu_torch.ops import image as ti
from orbslam2_tpu_torch.ops import stereo as ts

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)
ORB = OrbConfig(n_features=600)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    T = synthetic.straight_trajectory(3, step=0.25)[1]
    left, right = synthetic.render_world_stereo(world, CAM, T, rng, noise=1.0)
    return left.astype(np.float32), right.astype(np.float32)


@pytest.fixture(scope="module")
def jax_pyramid(pair):
    return [np.asarray(x) for x in ji.build_pyramid(
        jnp.asarray(pair[0]), ORB.n_levels, ORB.scale_factor)]


def test_level_plan_identical():
    assert te.level_plan(tconfig.OrbConfig(n_features=600)) == \
        tuple(je.level_plan(ORB))


def test_pyramid_within_tolerance(pair, jax_pyramid):
    tp = ti.build_pyramid(torch.from_numpy(pair[0]), ORB.n_levels,
                          ORB.scale_factor)
    assert [tuple(x.shape) for x in tp] == [x.shape for x in jax_pyramid]
    for a, b in zip(jax_pyramid, tp):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4, rtol=0)


@pytest.mark.parametrize("level", [0, 3])
def test_gaussian_blur_within_tolerance(jax_pyramid, level):
    img = jax_pyramid[level]
    np.testing.assert_allclose(
        ti.gaussian_blur(to_tensor(img), 7, 2.0).numpy(),
        np.asarray(ji.gaussian_blur(jnp.asarray(img), 7, 2.0)),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("level", [0, 1, 4, 7])
def test_fast_nms_select_exact_on_jax_level(jax_pyramid, level):
    img = jax_pyramid[level]
    js_ = np.asarray(jf.nms_3x3(jf.fast_score(jnp.asarray(img))))
    ts_ = tf.nms_3x3(tf.fast_score(to_tensor(img))).numpy()
    np.testing.assert_array_equal(ts_, js_)
    cap = je.level_plan(ORB).caps[level]
    jout = je._select_keypoints(jnp.asarray(js_), cap, 20.0, 7.0, 19)
    tout = te._select_keypoints(to_tensor(js_), cap, 20.0, 7.0, 19)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _angle_tolerance(img, xy):
    """(float64 IC angles, allowed float32 error) at the keypoints ``xy``.

    Both packages sum the 961 moment terms p·k (pixel times integer
    offset) in float32, in an order that depends on the library and the
    host CPU's vector path.  In any order the sum is off the exact one by
    at most γ₉₆₁·Σ|p·k| (γₙ = n·u / (1 − n·u), u = 2⁻²⁴: one rounding of
    the product and at most 960 of the additions on each term), so the
    moment vector m is off by at most δ = γ₉₆₁·|(Σ|p·kx|, Σ|p·ky|)| and its
    angle by asin(δ / |m|).  Where that bound is below 1e-4 rad the bar
    stays 1e-4 (atan2's own rounding is ~1e-7)."""
    r = 15
    h, w = img.shape
    cx = np.clip(xy[:, 0].astype(np.int64), r, w - 1 - r)
    cy = np.clip(xy[:, 1].astype(np.int64), r, h - 1 - r)
    off = np.arange(-r, r + 1)
    patches = img.astype(np.float64)[(cy[:, None] + off)[:, :, None],
                                     (cx[:, None] + off)[:, None, :]]
    k = je._moment_kernels().astype(np.float64)       # [961, 2], integers
    p = patches.reshape(len(xy), -1)
    m = p @ k
    s = np.abs(p) @ np.abs(k)
    n, u = 961, 2.0 ** -24
    gamma = n * u / (1 - n * u)
    rel = gamma * np.hypot(s[:, 0], s[:, 1]) / np.hypot(m[:, 0], m[:, 1])
    bound = np.arcsin(np.minimum(rel, 1.0))
    return np.arctan2(m[:, 1], m[:, 0]), np.maximum(bound, 1e-4)


@pytest.mark.parametrize("level", [0, 2, 5])
def test_angles_and_descriptors_on_jax_level(jax_pyramid, level):
    img = jax_pyramid[level]
    score = jf.nms_3x3(jf.fast_score(jnp.asarray(img)))
    xy, _, valid = je._select_keypoints(score, je.level_plan(ORB).caps[level],
                                        20.0, 7.0, 19)
    valid = np.asarray(valid)
    assert valid.sum() > 20
    ja = np.asarray(je.keypoint_angles(jnp.asarray(img), xy))
    ta = te.keypoint_angles(to_tensor(img),
                            to_tensor(np.asarray(xy))).numpy()
    exact, tol = _angle_tolerance(img, np.asarray(xy))
    for name, a in (("jax", ja), ("port", ta)):
        err = np.abs(np.angle(np.exp(1j * (a - exact))))
        bad = valid & ~(err <= tol)
        assert not bad.any(), (name, np.nonzero(bad)[0], err[bad], tol[bad])
    blurred = np.asarray(ji.gaussian_blur(jnp.asarray(img), 7, 2.0))
    jd = np.asarray(je._descriptors(jnp.asarray(blurred), xy,
                                    jnp.asarray(ja)))
    td = te._descriptors(to_tensor(blurred), to_tensor(np.asarray(xy)),
                         to_tensor(ja)).numpy().view(np.uint32)
    np.testing.assert_array_equal(td, jd)


def _to_port_features(f):
    return te.Features(*(to_tensor(np.asarray(x)) for x in f))


def test_match_stereo_on_jax_features(pair):
    L, R = (jnp.asarray(x) for x in pair)

    @jax.jit
    def jax_stereo(L, R):
        pl = ji.build_pyramid(L, ORB.n_levels, ORB.scale_factor)
        pr = ji.build_pyramid(R, ORB.n_levels, ORB.scale_factor)
        fl, fr = je.extract(L, ORB), je.extract(R, ORB)
        return pl, pr, fl, fr, js.match_stereo(fl, fr, pl, pr, CAM.bf,
                                               CAM.fx, ORB.scale_factor)

    pl, pr, fl, fr, jm = jax_stereo(L, R)
    tm = ts.match_stereo(_to_port_features(fl), _to_port_features(fr),
                         [to_tensor(np.asarray(x)) for x in pl],
                         [to_tensor(np.asarray(x)) for x in pr],
                         CAM.bf, CAM.fx, ORB.scale_factor)
    jdep, tdep = np.asarray(jm.depth), tm.depth.numpy()
    np.testing.assert_array_equal(tdep > 0, jdep > 0)
    assert (jdep > 0).sum() > 100
    np.testing.assert_allclose(tm.u_right.numpy(), np.asarray(jm.u_right),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(tdep, jdep, rtol=1e-4, atol=0)


def test_masked_median_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.random(101).astype(np.float32)
    for ok in (rng.random(101) < 0.5, np.zeros(101, bool)):
        assert ts.masked_median(to_tensor(x), to_tensor(ok)).item() == \
            float(js.masked_median(jnp.asarray(x), jnp.asarray(ok)))


def test_whole_stereo_frontend_agreement(pair):
    cfg = SlamConfig(camera=CAM, orb=ORB)
    tcfg = tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(CAM)),
        orb=tconfig.OrbConfig(**dataclasses.asdict(ORB)))
    jfd = jframe.make_frontend_stereo(cfg)(*(jnp.asarray(x) for x in pair))
    tfd = tframe.make_frontend_stereo(tcfg)(*(torch.from_numpy(x)
                                              for x in pair))
    same = ((np.asarray(jfd.xy) == tfd.xy.numpy()).all(1)
            & (np.asarray(jfd.valid) == tfd.valid.numpy())
            & (np.asarray(jfd.level) == tfd.level.numpy())
            & (np.asarray(jfd.desc) == tfd.desc.numpy().view(np.uint32)
               ).all(1))
    assert same.mean() >= 0.99, same.mean()
    both = (np.asarray(jfd.depth) > 0) & (tfd.depth.numpy() > 0)
    assert both.sum() >= 0.95 * (np.asarray(jfd.depth) > 0).sum()
