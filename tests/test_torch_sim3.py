"""The Sim3 and pose-graph pieces of loop closing in the port against the
JAX package, on synthetic arrays made from a numpy seed (moved from
tests/test_torch_loop.py; that file holds the pieces that read the map).

Tolerances:
  * Sim3 Lie maps 1e-5; horn.align 1e-4 (s, R, t), minimal sets included;
  * sim3_ransac with JAX's hypotheses injected: same winner (inlier mask
    and count identical), s, R, t 1e-4;
  * search_by_sim3 exact; optimize_sim3 1e-4, inlier count ±1;
  * optimize_pose_graph 1e-3 on the tests/test_pose_graph.py drift case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import horn as jhorn
from orbslam2_tpu.ops import pose_graph as jpg
from orbslam2_tpu.ops import sim3opt as jsim3opt
from orbslam2_tpu.ops import sim3solver as jsim3
from orbslam2_tpu.utils import camera as jcam
from orbslam2_tpu.utils import lie as jlie
from orbslam2_tpu_torch.ops import horn as thorn
from orbslam2_tpu_torch.ops import pose_graph as tpg
from orbslam2_tpu_torch.ops import sim3opt as tsim3opt
from orbslam2_tpu_torch.ops import sim3solver as tsim3
from orbslam2_tpu_torch.utils import camera as tcam
from orbslam2_tpu_torch.utils import lie as tlie
from test_gba import _cfg as gba_cfg
from test_pose_graph import _chain_problem
from test_torch_loop import A, T, _assert_sim3_equal, _jax_hypotheses, \
    port_cfg

torch.set_num_threads(2)


def test_sim3_lie_matches_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.4, (64, 7)).astype(np.float32)
    xi[:8, 6] = 0.0                 # σ = 0 (stereo)
    xi[8:16, :3] = 0.0              # θ = 0
    xi[16:20] = 0.0                 # identity
    js, jR, jt = jlie.sim3_exp(jnp.asarray(xi))
    ts, tR, tt = tlie.sim3_exp(T(xi))
    for a, b in ((ts, js), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(A(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(A(tlie.sim3_log(ts, tR, tt)),
                               np.asarray(jlie.sim3_log(js, jR, jt)),
                               atol=1e-5)
    tinv = tlie.sim3_inv(ts, tR, tt)
    jinv = jlie.sim3_inv(js, jR, jt)
    tm = tlie.sim3_mul(ts, tR, tt, *tinv)
    jm = jlie.sim3_mul(js, jR, jt, *jinv)
    for a, b in zip(tinv + tm, jinv + jm):
        np.testing.assert_allclose(A(a), np.asarray(b), atol=1e-5)
    pts = rng.normal(0, 2, (64, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        A(tlie.sim3_apply(ts, tR, tt, T(pts))),
        np.asarray(jlie.sim3_apply(js, jR, jt, jnp.asarray(pts))), atol=1e-4)
    tmat = tlie.sim3_to_mat(ts, tR, tt)
    np.testing.assert_allclose(A(tmat), np.asarray(
        jlie.sim3_to_mat(js, jR, jt)), atol=1e-5)
    for a, b in zip(tlie.mat_to_sim3(tmat),
                    jlie.mat_to_sim3(jnp.asarray(A(tmat)))):
        np.testing.assert_allclose(A(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("case", ["minimal", "many", "weighted", "fixed"])
def test_horn_align_matches_jax(case):
    rng = np.random.default_rng(3)
    B, n = 64, (3 if case == "minimal" else 30)
    src = rng.normal(0, 3, (B, n, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.5, (B, 3)),
                                            jnp.float32)))
    dst = (1.3 * np.einsum("bij,bnj->bni", R, src)
           + rng.normal(0, 1, (B, 1, 3))
           + rng.normal(0, 0.02, (B, n, 3))).astype(np.float32)
    w = (rng.random((B, n)) < 0.7).astype(np.float32) \
        if case == "weighted" else None
    ws = case != "fixed"
    j = jhorn.align(jnp.asarray(src), jnp.asarray(dst),
                    None if w is None else jnp.asarray(w), with_scale=ws)
    t = thorn.align(T(src), T(dst), None if w is None else T(w),
                    with_scale=ws)
    for a, b in zip(t, j):
        np.testing.assert_allclose(A(a), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(
        A(thorn.apply(*t, T(src))),
        np.asarray(jhorn.apply(*j, jnp.asarray(src))), atol=1e-3)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_jax(fix_scale):
    rng = np.random.default_rng(4)
    jc = jcam.Camera.from_config(gba_cfg().camera)
    tc = tcam.Camera.from_config(port_cfg(gba_cfg()).camera)
    n = 60
    pts1 = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                     rng.uniform(5, 15, n)], -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, 0.3, -0.1])))
    s = 1.0 if fix_scale else 1.3
    pts2 = (((pts1 - np.array([0.4, -0.2, 0.6])) @ R) / s
            + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    pts2[rng.choice(n, 12, replace=False)] += 1.5
    valid = rng.random(n) < 0.9
    key = jax.random.PRNGKey(1)
    j = jsim3.sim3_ransac(jc, jnp.asarray(pts1), jnp.asarray(pts2),
                          jnp.asarray(valid), key, fix_scale=fix_scale)
    idx = _jax_hypotheses(key, valid, 128, 3)
    t = tsim3.sim3_ransac(tc, T(pts1), T(pts2), T(valid), None,
                          fix_scale=fix_scale, idx=T(idx))
    _assert_sim3_equal(t, j)
    assert bool(t.ok)


def test_sim3_ransac_without_valid_matches_is_not_ok():
    """No valid correspondence: JAX samples anyway and reports ok=False;
    the port's draws must not raise (all-zero multinomial weights)."""
    tc = tcam.Camera.from_config(port_cfg(gba_cfg()).camera)
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(40, 3) + 2.0
    res = tsim3.sim3_ransac(tc, pts, pts, torch.zeros(40, dtype=torch.bool),
                            g, fix_scale=True)
    assert not bool(res.ok) and int(res.n_inliers) == 0


def test_search_by_sim3_matches_jax():
    rng = np.random.default_rng(5)
    jc = jcam.Camera.from_config(gba_cfg().camera)
    tc = tcam.Camera.from_config(port_cfg(gba_cfg()).camera)
    n = 128
    p1c = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 12, n)], -1).astype(np.float32)
    R12 = jlie.so3_exp(jnp.asarray([0.02, 0.14, 0.0]))
    t12 = jnp.asarray([0.3, 0.1, 0.2], jnp.float32)
    s21, R21, t21 = jlie.sim3_inv(jnp.float32(1.0), R12, t12)
    perm = rng.permutation(n)
    p2c = np.asarray(s21 * (jnp.asarray(p1c) @ R21.T) + t21)[perm]
    desc1 = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    desc2 = desc1[perm].copy()
    desc2[::7, 0] ^= np.uint32(0xFF)         # some near-misses
    lvl1 = rng.integers(0, 3, n).astype(np.int32)
    lvl2 = lvl1[perm]
    uv1 = np.asarray(jsim3opt._project(jc, jnp.asarray(p1c)))
    uv2 = np.asarray(jsim3opt._project(jc, jnp.asarray(p2c)))
    valid = rng.random(n) < 0.9
    d1 = np.linalg.norm(p1c, axis=-1)
    d2 = np.linalg.norm(p2c, axis=-1)
    args = [uv1, lvl1, desc1, valid, p1c, valid, uv2, lvl2, desc2, valid,
            p2c, valid, 0.3 * d1, 1.5 * d1, 0.3 * d2, 1.5 * d2]
    jm, jn = jsim3opt.search_by_sim3(
        jc, *[jnp.asarray(a) for a in args], jnp.float32(1.0), R12, t12,
        1.2, 8)
    tm, tn = tsim3opt.search_by_sim3(
        tc, *[T(a) for a in args], torch.tensor(1.0), T(R12), T(t12),
        1.2, 8)
    np.testing.assert_array_equal(A(tm), np.asarray(jm))
    assert int(tn) == int(jn) >= 25


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    rng = np.random.default_rng(6)
    jc = jcam.Camera.from_config(gba_cfg().camera)
    tc = tcam.Camera.from_config(port_cfg(gba_cfg()).camera)
    n = 200
    p1c = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 12, n)], -1).astype(np.float32)
    R12 = jlie.so3_exp(jnp.asarray([0.05, 0.17, 0.03]))
    t12 = jnp.asarray([0.4, -0.2, 0.3], jnp.float32)
    s12 = jnp.float32(1.0 if fix_scale else 1.15)
    s21, R21, t21 = jlie.sim3_inv(s12, R12, t12)
    p2c = np.asarray(s21 * (jnp.asarray(p1c) @ R21.T) + t21)
    uv1 = np.asarray(jsim3opt._project(jc, jnp.asarray(p1c))) \
        + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv2 = np.asarray(jsim3opt._project(jc, jnp.asarray(p2c))) \
        + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv2[:15] += 30.0                         # outliers
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    R0 = jlie.so3_exp(jnp.asarray([0.03, -0.02, 0.01])) @ R12
    t0 = t12 + jnp.asarray([0.2, 0.1, -0.2], jnp.float32)
    s0 = s12 * (1.0 if fix_scale else 1.08)
    args = [p1c, p2c, uv1.astype(np.float32), uv2.astype(np.float32),
            inv_s2, inv_s2, valid]
    j = jsim3opt.optimize_sim3(jc, *[jnp.asarray(a) for a in args],
                               s0, R0, t0, fix_scale=fix_scale)
    t = tsim3opt.optimize_sim3(tc, *[T(a) for a in args], T(s0), T(R0),
                               T(t0), fix_scale=fix_scale)
    for a, b in ((t.s12, j.s12), (t.R12, j.R12), (t.t12, j.t12)):
        np.testing.assert_allclose(A(a), np.asarray(b), atol=1e-4)
    assert abs(int(t.n_inliers) - int(j.n_inliers)) <= 1
    assert (A(t.inlier) != np.asarray(j.inlier)).sum() <= 1


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_pose_graph_matches_jax(fix_scale):
    prob, poses_true, _ = _chain_problem(np.random.default_rng(0))
    if not fix_scale:
        K = prob.s.shape[0]
        prob = prob._replace(s=jnp.asarray(
            (1.01 ** np.arange(K)).astype(np.float32)))
    js, jR, jt = jpg.optimize_pose_graph(prob, n_iters=15, cg_iters=48,
                                         fix_scale=fix_scale)
    tprob = tpg.PoseGraphProblem(*[T(np.asarray(x)) for x in prob])
    ts, tR, tt = tpg.optimize_pose_graph(tprob, n_iters=15, cg_iters=48,
                                         fix_scale=fix_scale)
    for a, c in ((ts, js), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(A(a), np.asarray(c), atol=1e-3)
    np.testing.assert_allclose(
        A(tpg.se3_from_sim3(ts, tR, tt)),
        np.asarray(jpg.se3_from_sim3(js, jR, jt)), atol=1e-3)
