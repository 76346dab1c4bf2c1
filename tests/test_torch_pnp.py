"""EPnP RANSAC of the port against the JAX package (moved from
tests/test_torch_reloc.py, which holds the relocalization that calls it).

Tolerances: pnp_ransac with JAX's hypotheses injected: same winner
(inlier mask and count identical), Tcw 1e-4; the EPnP core on 12-point
sets 1e-3 (4×4 pose entries) on ≥ 90% of the sets (the best of the three
β cases is picked by reprojection error, and where two score alike the
pick may differ); near-planar and degenerate cases held to the truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu.config import SlamConfig
from orbslam2_tpu.ops import pnp as jpnp
from orbslam2_tpu.utils import camera as jcam
from orbslam2_tpu.utils import lie as jlie
from orbslam2_tpu_torch.ops import pnp as tpnp
from orbslam2_tpu_torch.utils import camera as tcam
from test_torch_reloc import A, CAM, T, _jax_hypotheses, port_cfg

torch.set_num_threads(2)


def _tcam():
    return tcam.Camera.from_config(port_cfg(SlamConfig(camera=CAM)).camera)


def _pnp_scene(rng, planar):
    n = 80
    x, y = rng.uniform(-5, 5, n), rng.uniform(-3, 3, n)
    z = (10.0 + 0.02 * x - 0.01 * y + rng.normal(0, 0.001, n)) if planar \
        else rng.uniform(4, 20, n)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    xi = np.array([0.1, -0.2, 0.05, 0.3, 0.1, -0.2], np.float32)
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([450 * pc[:, 0] / pc[:, 2] + 320,
                   450 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    uv[rng.choice(n, 16, replace=False)] += 40.0
    sig2 = (1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    return pts, uv, sig2, rng.random(n) < 0.9, T_true


def test_pnp_ransac_matches_jax():
    rng = np.random.default_rng(11)
    pts, uv, sig2, valid, T_true = _pnp_scene(rng, planar=False)
    key = jax.random.PRNGKey(3)
    j = jpnp.pnp_ransac(jcam.Camera.from_config(CAM), jnp.asarray(pts),
                        jnp.asarray(uv), jnp.asarray(sig2),
                        jnp.asarray(valid), key, n_hypotheses=128)
    idx = _jax_hypotheses(key, valid, 128, jpnp.MIN_SET)
    t = tpnp.pnp_ransac(_tcam(), T(pts), T(uv), T(sig2), T(valid), None,
                        n_hypotheses=128, idx=T(idx))
    np.testing.assert_array_equal(A(t.inliers), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)
    assert bool(t.ok) == bool(j.ok) is True
    np.testing.assert_allclose(A(t.Tcw), np.asarray(j.Tcw), atol=1e-4)
    assert np.linalg.norm((A(t.Tcw) @ np.linalg.inv(T_true))[:3, 3]) < 0.3


def test_pnp_ransac_near_planar_lands_in_the_basin():
    """tests/test_place_recognition.py's near-planar case on the port
    alone: the conditioning there (a 1 mm-thick wall) leaves 1e-3 between
    two FP32 eigen-solvers, so it is held to the truth, as JAX's test
    holds JAX's."""
    rng = np.random.default_rng(11)
    pts, uv, sig2, valid, T_true = _pnp_scene(rng, planar=True)
    t = tpnp.pnp_ransac(_tcam(), T(pts), T(uv), T(sig2), T(valid),
                        torch.Generator().manual_seed(1), n_hypotheses=128)
    assert bool(t.ok)
    assert np.linalg.norm((A(t.Tcw) @ np.linalg.inv(T_true))[:3, 3]) < 0.3
    assert A(t.inliers).mean() > 0.6


def test_epnp_batch_matches_jax():
    """The batched EPnP core on 64 random 12-point sets (each its own solve
    in JAX's vmap).  Not on 4-point minimal sets: their MᵀM null space is
    4-dimensional, its basis is arbitrary and differs between LAPACK and
    XLA, and the β cases built on it differ with it."""
    rng = np.random.default_rng(12)
    pts, uv, _, _, _ = _pnp_scene(rng, False)
    keep = np.ones(len(pts), bool)
    keep[np.argsort(np.abs(uv - uv.mean(0)).sum(1))[-16:]] = False
    pts, uv = pts[keep], uv[keep]        # drop the 16 shifted outliers
    xy = np.stack([(uv[:, 0] - 320) / 450, (uv[:, 1] - 240) / 450], -1)
    idx = np.stack([rng.choice(len(pts), 12, replace=False)
                    for _ in range(64)])
    w = (rng.random((64, 12)) < 0.9).astype(np.float32)
    jT = jax.vmap(jpnp._epnp_solve)(jnp.asarray(pts[idx]),
                                    jnp.asarray(xy[idx], jnp.float32),
                                    jnp.asarray(w))
    tT = tpnp._epnp_solve(T(pts[idx]), T(xy[idx].astype(np.float32)), T(w))
    # a set whose β cases reproject alike may pick another case
    err = np.abs(A(tT) - np.asarray(jT)).reshape(64, -1).max(1)
    assert (err < 1e-3).mean() >= 0.9, np.sort(err)[-8:]


def test_epnp_of_a_non_finite_set_is_nan_as_in_jax():
    """A point at infinity, even at weight 0, makes the weighted centroid
    NaN: JAX's eigh returns NaN there, and so does the port's, which
    would raise in ``torch.linalg.eigh`` otherwise."""
    rng = np.random.default_rng(13)
    pts, uv, _, _, _ = _pnp_scene(rng, False)
    pts[5] = np.inf
    xy = np.stack([(uv[:, 0] - 320) / 450, (uv[:, 1] - 240) / 450],
                  -1).astype(np.float32)
    w = np.ones(len(pts), np.float32)
    w[5] = 0.0
    jT = np.asarray(jpnp._epnp_solve(jnp.asarray(pts), jnp.asarray(xy),
                                     jnp.asarray(w)))
    tT = A(tpnp._epnp_solve(T(pts), T(xy), T(w)))
    assert not np.isfinite(jT).all() and not np.isfinite(tT).all()
    # zero weights everywhere: the refine of a RANSAC that found nothing
    tZ = A(tpnp._epnp_solve(T(np.where(np.isinf(pts), 0.0, pts)), T(xy),
                            T(np.zeros_like(w))))
    assert tZ.shape == (4, 4)


def test_pnp_ransac_with_a_point_at_infinity_matches_jax():
    """One valid match to a point at infinity: its hypotheses and the
    refine are NaN and lose, in JAX and in the port alike, and the rest
    of the RANSAC is unchanged.  The pose kept is then a 4-point minimal
    set's, whose null-space basis differs between LAPACK and XLA
    (``test_epnp_batch_matches_jax``): it is held to the truth."""
    rng = np.random.default_rng(11)
    pts, uv, sig2, valid, T_true = _pnp_scene(rng, planar=False)
    bad = int(np.flatnonzero(valid)[0])
    pts[bad] = np.inf
    key = jax.random.PRNGKey(3)
    j = jpnp.pnp_ransac(jcam.Camera.from_config(CAM), jnp.asarray(pts),
                        jnp.asarray(uv), jnp.asarray(sig2),
                        jnp.asarray(valid), key, n_hypotheses=128)
    idx = _jax_hypotheses(key, valid, 128, jpnp.MIN_SET)
    assert (idx == bad).any()
    t = tpnp.pnp_ransac(_tcam(), T(pts), T(uv), T(sig2), T(valid), None,
                        n_hypotheses=128, idx=T(idx))
    np.testing.assert_array_equal(A(t.inliers), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)
    assert bool(t.ok) == bool(j.ok) is True
    for Tcw in (A(t.Tcw), np.asarray(j.Tcw)):
        assert np.isfinite(Tcw).all()
        assert np.linalg.norm((Tcw @ np.linalg.inv(T_true))[:3, 3]) < 0.3


def test_pnp_ransac_without_valid_points_is_not_ok():
    g = torch.Generator().manual_seed(0)
    res = tpnp.pnp_ransac(
        _tcam(), torch.rand(30, 3) + 3.0, torch.rand(30, 2) * 100.0,
        torch.ones(30), torch.zeros(30, dtype=torch.bool), g)
    assert not bool(res.ok) and int(res.n_inliers) == 0
