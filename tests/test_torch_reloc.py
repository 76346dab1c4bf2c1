"""Relocalization of the port against the JAX package: the frame BoW
query of the keyframe DB and one relocalization attempt (direct match,
and the projection rescue of tests/test_reloc_rescue.py).  EPnP RANSAC:
tests/test_torch_pnp.py; the engine recovering from LOST:
tests/test_torch_reloc_engine.py.

Tolerances: frame BoW vectors 1e-6; candidate ids exact; reloc_attempt
with JAX's hypotheses injected: same winner (inlier mask and count
identical), Tcw 1e-4, associations exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.models import keyframe_db as jdb
from orbslam2_tpu.models import map_state as JM
from orbslam2_tpu.models import vocabulary as jvoc
from orbslam2_tpu.runtime import loop_closing as jlc
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import map_state_from_numpy
from orbslam2_tpu_torch.models import keyframe_db as tdb
from orbslam2_tpu_torch.models import vocabulary as tvoc
from orbslam2_tpu_torch.ops import matching as tmatch
from orbslam2_tpu_torch.runtime import loop_closing as tlc
from test_reloc_rescue import _cfg as rescue_cfg, _flip_bits

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                   width=640, height=480, fps=10.0, th_depth=60.0)


def T(a):
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True))


def A(t):
    return t.detach().cpu().numpy()


def port_cfg(cfg: SlamConfig) -> tconfig.SlamConfig:
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=tconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
        capacity=tconfig.CapacityConfig(**dataclasses.asdict(cfg.capacity)),
        sensor=cfg.sensor)


def port_ms(ms):
    return map_state_from_numpy({k: np.asarray(v)
                                 for k, v in ms._asdict().items()})


def port_voc(voc):
    return tvoc.from_numpy(voc.centroids, voc.idf, voc.k, voc.levels)


def _jax_hypotheses(key, valid, n_hyp, size):
    """JAX's RANSAC draws, exactly as pnp.py:165-168 makes them."""
    p = jnp.asarray(valid).astype(jnp.float32)
    p = p / jnp.clip(jnp.sum(p), 1.0, None)
    return np.asarray(jax.random.choice(key, valid.shape[0],
                                        shape=(n_hyp, size), replace=True,
                                        p=p))


# ------------------------------------------------- DB query, attempt ------

def _cfg():
    return SlamConfig(camera=CAM, orb=OrbConfig(n_features=400),
                      capacity=CapacityConfig(max_keyframes=16,
                                              max_map_points=4096,
                                              local_ba_keyframes=8,
                                              local_ba_points=1024),
                      sensor=STEREO)


@pytest.fixture(scope="module")
def kidnapped():
    """The JAX engine (loop closing off) maps 10 corridor frames; the DB
    holds its live keyframes; the kidnap frame re-renders frame 2."""
    cfg = _cfg()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(10, step=0.25)
    eng = JaxEngine(cfg, enable_loop_closing=False)
    for i, Tcw in enumerate(poses):
        eng.track_stereo(*synthetic.render_world_stereo(
            world, CAM, Tcw, rng, 1.0), 0.1 * i)
    left, right = synthetic.render_world_stereo(world, CAM, poses[2], rng,
                                                1.0)
    fd = eng.frontend(jnp.asarray(left, jnp.float32),
                      jnp.asarray(right, jnp.float32))
    voc = jvoc.default_vocabulary()
    jf = jlc.make_loop_fns(cfg, voc)
    ms = eng.ms
    db = jdb.KeyFrameDB.empty(cfg.capacity.max_keyframes, voc.n_words)
    for k in np.where(np.asarray(ms.kf_valid))[0]:
        db = db.add(jnp.int32(k), jf[0](ms, jnp.int32(k)))
    tcfg = port_cfg(cfg)
    return dict(cfg=cfg, tcfg=tcfg, ms=ms, tms=port_ms(ms), fd=fd, jf=jf,
                tf=tlc.make_loop_fns(tcfg, port_voc(voc)), db=db,
                tdb=tdb.KeyFrameDB(bow=T(db.bow), valid=T(db.valid)),
                T_true=poses[2])


def _fd_args(fd):
    return [fd.desc, fd.valid, fd.xy, fd.level, fd.ur, fd.angle]


def _reloc_valid(tms, fd_t, kf, nn_ratio):
    """The attempt's matched-point mask, as reloc_attempt builds it (the
    port's matches equal JAX's)."""
    kmp = tms.kf_mp[kf].long()
    kvalid = tms.kf_kp_valid[kf] & (kmp >= 0)
    m, _ = tmatch.match_descriptors(
        fd_t[0], fd_t[1], tms.kf_desc[kf], kvalid, nn_ratio=nn_ratio,
        th=tmatch.TH_LOW, angle_a=fd_t[5], angle_b=tms.kf_angle[kf])
    ok = m >= 0
    mp = kmp[torch.where(ok, m, 0)]
    return A(ok & (mp >= 0) & tms.mp_valid[torch.where(mp >= 0, mp, 0)])


def _assert_attempt_equal(j, t):
    np.testing.assert_allclose(A(t[0]), np.asarray(j[0]), atol=1e-4)
    assert int(t[1]) == int(j[1])
    np.testing.assert_array_equal(A(t[2]), np.asarray(j[2]))


def test_reloc_query_and_attempt_match_jax(kidnapped):
    b = kidnapped
    fd = b["fd"]
    fd_t = [T(x) for x in _fd_args(fd)]
    jvec = b["jf"][7](fd.desc, fd.valid)
    tvec = b["tf"].frame_bow_vector(fd_t[0], fd_t[1])
    np.testing.assert_allclose(A(tvec), np.asarray(jvec), atol=1e-6)
    jc, _ = b["jf"][2](b["ms"], b["db"], jnp.int32(-1), jvec,
                       jnp.float32(0.0))
    tc, _ = b["tf"].detect(b["tms"], b["tdb"], -1, tvec, 0.0)
    np.testing.assert_array_equal(A(tc), np.asarray(jc))
    cands = [int(c) for c in np.asarray(jc) if c >= 0]
    assert cands
    nn = b["cfg"].tracking.relocalization_nn_ratio
    best = 0
    for i, c in enumerate(cands[:2]):
        key = jax.random.PRNGKey(20 + i)
        j = b["jf"][8](b["ms"], *_fd_args(fd), jnp.int32(c), key)
        idx = _jax_hypotheses(key, _reloc_valid(b["tms"], fd_t, c, nn),
                              128, 4)
        t = b["tf"].reloc_attempt(b["tms"], *fd_t, c, None, idx=T(idx))
        _assert_attempt_equal(j, t)
        best = max(best, int(t[1]))
    assert best >= 50


def test_reloc_rescue_matches_jax():
    """tests/test_reloc_rescue.py's thin direct match: only the 10 px
    SearchByProjection rescue reaches 50 inliers, in both packages."""
    rng = np.random.default_rng(0)
    cfg = rescue_cfg()
    N = cfg.orb.n_features_padded
    cam = cfg.camera
    pts_c = np.stack([rng.uniform(-4, 4, 180), rng.uniform(-3, 3, 180),
                      rng.uniform(6, 25, 180)], -1)
    u = cam.fx * pts_c[:, 0] / pts_c[:, 2] + cam.cx
    v = cam.fy * pts_c[:, 1] / pts_c[:, 2] + cam.cy
    inb = (u > 20) & (u < cam.width - 20) & (v > 20) & (v < cam.height - 20)
    pts_c, u, v = pts_c[inb], u[inb], v[inb]
    n_feat = len(u)
    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    xy = np.zeros((N, 2), np.float32)
    xy[:n_feat, 0], xy[:n_feat, 1] = u, v
    valid = np.zeros((N,), bool)
    valid[:n_feat] = True
    assoc = np.full((N,), JM.NO_MP, np.int32)
    assoc[:n_feat] = np.arange(n_feat)
    ms = JM.empty_map(cfg)
    ms = JM.add_map_points(
        ms, jnp.asarray(assoc.clip(0)),
        jnp.asarray(np.pad(pts_c, ((0, N - n_feat), (0, 0))), jnp.float32),
        jnp.asarray(valid), ref_kf=jnp.zeros((N,), jnp.int32))
    ms = JM.add_keyframe(
        ms, jnp.int32(0), jnp.eye(4, dtype=jnp.float32), jnp.int32(0),
        jnp.float32(0.0), jnp.asarray(xy), jnp.zeros((N,), jnp.int32),
        jnp.zeros((N,), jnp.float32), jnp.asarray(desc), jnp.asarray(valid),
        jnp.full((N,), -1.0, jnp.float32), jnp.full((N,), -1.0, jnp.float32),
        jnp.asarray(assoc), parent=jnp.int32(-1))
    ms = JM.add_observations(ms, jnp.int32(0), jnp.arange(N, dtype=jnp.int32),
                             jnp.asarray(assoc.clip(0)), jnp.asarray(valid),
                             cfg.orb.scale_factor, cfg.orb.n_levels)
    fdesc = desc.copy()
    for i in range(n_feat):
        nb = int(rng.integers(4, 20)) if i < 25 else int(rng.integers(60, 76))
        fdesc[i] = _flip_bits(desc[i], nb, rng)
    fd = [fdesc, valid, xy, np.zeros((N,), np.int32),
          np.full((N,), -1.0, np.float32), np.zeros((N,), np.float32)]
    voc = jvoc.default_vocabulary()
    key = jax.random.PRNGKey(0)
    j = jlc.make_loop_fns(cfg, voc)[8](ms, *[jnp.asarray(a) for a in fd],
                                       jnp.int32(0), key)
    tcfg = port_cfg(cfg)
    tms = port_ms(ms)
    fd_t = [T(a) for a in fd]
    idx = _jax_hypotheses(key, _reloc_valid(
        tms, fd_t, 0, cfg.tracking.relocalization_nn_ratio), 128, 4)
    t = tlc.make_loop_fns(tcfg, port_voc(voc)).reloc_attempt(
        tms, *fd_t, 0, None, idx=T(idx))
    _assert_attempt_equal(j, t)
    assert int(t[1]) >= 50
