"""Loop closing of the port against the JAX package, module by module, on
the same inputs: synthetic arrays made from a numpy seed, and the map the
JAX engine builds in tests/test_gba.py (14 frames of the corridor world).

Tolerances:
  * vocabulary arrays identical; BoW words exact, BoW vectors 1e-6;
  * covisibility counts, candidate ids and cand_info exact (on the map
    as built, and with a staged revisit that yields loop candidates); DB
    scores 1e-6;
  * Sim3 Lie maps 1e-5; horn.align 1e-4 (s, R, t), minimal sets included;
  * sim3_ransac / match_for_sim3 with JAX's hypotheses injected: same
    winner (inlier mask and count identical), s, R, t 1e-4;
  * search_by_sim3 exact; optimize_sim3 1e-4, inlier count ±1;
  * recount_matches exact, also with the map laid into 1024 keyframe
    slots and 131,072 point slots, where its whole-map search takes
    [PROJECTION_BLOCK, 1024] Hamming blocks, never a [131072, 1024] one;
  * optimize_pose_graph 1e-3 on the tests/test_pose_graph.py drift case;
  * correct_loop poses 1e-3, points 1e-2; fuse_after_loop merge count
    exact, integer map fields identical on ≥ 99% of rows;
  * gba_chunk and merge poses 1e-3, points 1e-2 m — beyond 33 m from the
    first camera 3e-4 of that distance (float32 LM, other summation
    order: the depth of a far stereo point is the worst-conditioned
    unknown; observation inlier masks identical on ≥ 99%);
  * the engines (loop closing on): keyframe counts ±1, ATE within 0.03 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import MONOCULAR, STEREO, SlamConfig
from orbslam2_tpu.models import keyframe_db as jdb
from orbslam2_tpu.models import map_state as JM
from orbslam2_tpu.models import vocabulary as jvoc
from orbslam2_tpu.ops import bow as jbow
from orbslam2_tpu.ops import horn as jhorn
from orbslam2_tpu.ops import pose_graph as jpg
from orbslam2_tpu.ops import sim3opt as jsim3opt
from orbslam2_tpu.ops import sim3solver as jsim3
from orbslam2_tpu.runtime import gba as jgba
from orbslam2_tpu.runtime import loop_closing as jlc
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu.utils import camera as jcam
from orbslam2_tpu.utils import lie as jlie
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import map_state_from_numpy, to_numpy
from orbslam2_tpu_torch.models import keyframe_db as tdb
from orbslam2_tpu_torch.models import map_state as TM
from orbslam2_tpu_torch.models import vocabulary as tvoc
from orbslam2_tpu_torch.ops import bow as tbow
from orbslam2_tpu_torch.ops import horn as thorn
from orbslam2_tpu_torch.ops import matching as tmatching
from orbslam2_tpu_torch.ops import pose_graph as tpg
from orbslam2_tpu_torch.ops import sim3opt as tsim3opt
from orbslam2_tpu_torch.ops import sim3solver as tsim3
from orbslam2_tpu_torch.runtime import gba as tgba
from orbslam2_tpu_torch.runtime import loop_closing as tlc
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchEngine
from orbslam2_tpu_torch.utils import camera as tcam
from orbslam2_tpu_torch.utils import lie as tlie
from test_gba import _cfg as gba_cfg, _perturb
from test_pose_graph import _chain_problem

torch.set_num_threads(2)


def T(a, dtype=None):
    """numpy/JAX array → CPU tensor (uint32 descriptor words as int32)."""
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    t = torch.from_numpy(np.array(arr, copy=True))
    return t if dtype is None else t.to(dtype)


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


@pytest.fixture(scope="module")
def built():
    """tests/test_gba.py's map (the JAX engine, loop closing off), the
    default vocabulary, both packages' loop functions, and a keyframe DB
    holding every live keyframe."""
    cfg = gba_cfg()
    rng = np.random.default_rng(3)
    world = synthetic.make_world(rng)
    eng = JaxEngine(cfg, enable_loop_closing=False)
    for i, Tcw in enumerate(synthetic.straight_trajectory(14, step=0.35)):
        eng.track_stereo(*synthetic.render_world_stereo(
            world, cfg.camera, Tcw, rng, 1.0), 0.1 * i)
    assert eng.n_kfs >= 4
    voc = jvoc.default_vocabulary()
    jf = jlc.make_loop_fns(cfg, voc)
    tcfg = port_cfg(cfg)
    tv = port_voc(voc)
    tf = tlc.make_loop_fns(tcfg, tv)
    ms = eng.ms
    live = [int(k) for k in np.where(np.asarray(ms.kf_valid))[0]]
    db = jdb.KeyFrameDB.empty(cfg.capacity.max_keyframes, voc.n_words)
    for k in live:
        db = db.add(jnp.int32(k), jf[0](ms, jnp.int32(k)))
    return dict(cfg=cfg, tcfg=tcfg, ms=ms, tms=port_ms(ms), voc=voc, tv=tv,
                jf=jf, tf=tf, db=db,
                tdb=tdb.KeyFrameDB(bow=T(db.bow), valid=T(db.valid)),
                live=live, fd=eng.last_fd)


def _covisible_pair(b):
    """(newest live KF, its most covisible older KF)."""
    W = np.asarray(JM.covisibility(b["ms"]))
    k1 = b["live"][-1]
    return k1, int(np.argmax(W[k1]))


# --------------------------------------------------------------- lie ------

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


# ----------------------------------------------------- vocabulary, BoW ----

def test_vocabulary_loader_matches_jax():
    jv = jvoc.default_vocabulary()
    tv = tvoc.default_vocabulary()
    assert (tv.k, tv.levels, tv.n_words) == (jv.k, jv.levels, jv.n_words)
    for a, b in zip(tv.centroids, jv.centroids):
        np.testing.assert_array_equal(A(a).view(np.uint32), np.asarray(b))
    np.testing.assert_array_equal(A(tv.idf), np.asarray(jv.idf))


def test_vocabulary_loader_never_rebuilds(monkeypatch):
    """A shipped tree is loaded, never rebuilt, and rebuilding it in place
    (force_rebuild without a path) raises.  A missing tree is built:
    tests/test_torch_vocabulary.py."""
    monkeypatch.setattr(tvoc, "harvest_training_descriptors", None)
    monkeypatch.setattr(tvoc, "build_vocabulary", None)
    assert tvoc.default_vocabulary().n_words == 10 ** 4
    with pytest.raises(ValueError, match="vocab_k10_l4.npz"):
        tvoc.default_vocabulary(force_rebuild=True)


def test_bow_words_and_vectors_match_jax(built):
    rng = np.random.default_rng(1)
    voc, tv = built["voc"], built["tv"]
    kf = built["live"][-1]
    cases = [(rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32),
              rng.random(300) < 0.8),
             (np.asarray(built["ms"].kf_desc[kf]),
              np.asarray(built["ms"].kf_kp_valid[kf])),
             (np.zeros((16, 8), np.uint32), np.zeros(16, bool))]
    for desc, valid in cases:
        jw = np.asarray(jbow.descriptors_to_words(voc, jnp.asarray(desc),
                                                  jnp.asarray(valid)))
        tw = A(tbow.descriptors_to_words(tv, T(desc), T(valid)))
        np.testing.assert_array_equal(tw, jw)
        jv = np.asarray(jbow.bow_vector(voc, jnp.asarray(desc),
                                        jnp.asarray(valid)))
        tvv = A(tbow.bow_vector(tv, T(desc), T(valid)))
        np.testing.assert_allclose(tvv, jv, atol=1e-6)
        np.testing.assert_allclose(
            float(tbow.score(T(tvv), T(tvv))),
            float(jbow.score(jnp.asarray(jv), jnp.asarray(jv))), atol=1e-6)


# ------------------------------------------------- covisibility, DB -------

def test_covisibility_matches_jax(built):
    ms, tms = built["ms"], built["tms"]
    np.testing.assert_array_equal(A(TM.obs_incidence(tms)),
                                  np.asarray(JM.obs_incidence(ms)))
    np.testing.assert_array_equal(A(TM.covisibility(tms)),
                                  np.asarray(JM.covisibility(ms)))
    ids = np.array(built["live"] + [0, 0], np.int32)
    np.testing.assert_array_equal(
        A(TM.covisibility_rows(tms, T(ids))),
        np.asarray(JM.covisibility_rows(ms, jnp.asarray(ids))))
    tq, jq = TM.mp_projection_query(tms), JM.mp_projection_query(ms)
    for a, b in zip(tq, jq):
        got, ref = A(a), np.asarray(b)
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_detect_step_matches_jax(built):
    """The loop prologue for every live keyframe on an empty-then-filled
    DB, and the relocalization-style frame query."""
    jf, tf = built["jf"], built["tf"]
    ms, tms = built["ms"], built["tms"]
    K, W = built["cfg"].capacity.max_keyframes, built["voc"].n_words
    jd = jdb.KeyFrameDB.empty(K, W)
    td = tdb.KeyFrameDB.empty(K, W)
    for kf in built["live"]:
        jd, jv, jinfo = jf[11](ms, jd, jnp.int32(kf))
        td, tv, tinfo = tf.detect_step(tms, td, kf)
        np.testing.assert_allclose(A(tv), np.asarray(jv), atol=1e-6)
        np.testing.assert_array_equal(A(tinfo), np.asarray(jinfo))
        np.testing.assert_array_equal(A(td.valid), np.asarray(jd.valid))
        np.testing.assert_allclose(
            float(tf.min_neighbor_score(tms, td, kf, tv)),
            float(jf[1](ms, jd, jnp.int32(kf), jv)), rtol=1e-6)
    # erase, and the frame query (query_kf −1, min score 0)
    jd = jd.erase(jnp.int32(built["live"][0]))
    td = td.erase(built["live"][0])
    fd = built["fd"]
    jvec = jf[7](fd.desc, fd.valid)
    tvec = tf.frame_bow_vector(T(fd.desc), T(fd.valid))
    jc, js = jf[2](ms, jd, jnp.int32(-1), jvec, jnp.float32(0.0))
    tc, ts = tf.detect(tms, td, -1, tvec, 0.0)
    np.testing.assert_array_equal(A(tc), np.asarray(jc))
    np.testing.assert_allclose(A(ts), np.asarray(js), atol=1e-6)
    assert (A(tc) >= 0).sum() >= 1


def _revisit_map(b):
    """The test map with a staged revisit: keyframes live[0] and live[1]
    take the descriptors of the two newest keyframes, observed through
    copies of their map points in fresh slots — the same place seen
    again, with its own points (covisible with each other, not with the
    newest keyframe)."""
    d = {k: np.asarray(v).copy() for k, v in b["ms"]._asdict().items()}
    live = b["live"]
    pairs = ((live[0], live[-1]), (live[1], live[-2]))
    seen = np.unique(np.concatenate([d["kf_mp"][src] for _, src in pairs]))
    seen = seen[seen >= 0]
    fresh = np.where(~d["mp_valid"])[0][:len(seen)]
    assert len(fresh) == len(seen)
    remap = np.full(d["mp_valid"].shape[0], -1, np.int64)
    remap[seen] = fresh
    for k in [k for k in d if k.startswith("mp_")]:
        d[k][fresh] = d[k][seen]
    for dst, src in pairs:
        for k in ("kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_kp_valid",
                  "kf_ur", "kf_depth"):
            d[k][dst] = d[k][src]
        m = d["kf_mp"][src]
        d["kf_mp"][dst] = np.where(m >= 0, remap[np.maximum(m, 0)], -1)
    return JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()}), d


def test_detect_step_finds_a_staged_revisit_like_jax(built):
    jf, tf = built["jf"], built["tf"]
    ms, d = _revisit_map(built)
    tms = map_state_from_numpy(d)
    K, W = built["cfg"].capacity.max_keyframes, built["voc"].n_words
    jd, td = jdb.KeyFrameDB.empty(K, W), tdb.KeyFrameDB.empty(K, W)
    for kf in built["live"][:-1]:
        jd = jd.add(jnp.int32(kf), jf[0](ms, jnp.int32(kf)))
        td = td.add(kf, tf.kf_bow_vector(tms, kf))
    q = built["live"][-1]
    jd, jv, jinfo = jf[11](ms, jd, jnp.int32(q))
    td, tv, tinfo = tf.detect_step(tms, td, q)
    np.testing.assert_array_equal(A(tinfo), np.asarray(jinfo))
    cands = set(int(c) for c in A(tinfo)[:, 0] if c >= 0)
    assert built["live"][0] in cands, A(tinfo)[:, 0]


def test_consistency_groups_match_jax(built):
    """DetectLoop's covisibility-consistency bookkeeping on the host: the
    same candidate sequence gives the same groups and the same candidates
    reaching Sim3 in both closers (Sim3 stubbed to fail)."""
    K = built["cfg"].capacity.max_keyframes
    jlc_ = jlc.LoopCloser(built["cfg"], built["voc"])
    tlc_ = tlc.LoopCloser(built["tcfg"], built["tv"], device="cpu")
    tried = {"jax": [], "port": []}

    class NotOk:
        ok = False

    jlc_.f_sim3 = lambda ms, kf, c, key: tried["jax"].append(int(c)) or NotOk
    tlc_.fns = tlc_.fns._replace(
        match_for_sim3=lambda ms, kf, c, g: tried["port"].append(c)
        or (NotOk, None))
    rng = np.random.default_rng(4)
    for step in range(12):
        cands = sorted(rng.choice(K, int(rng.integers(1, 4)),
                                  replace=False).tolist())
        rows = {c: np.where(rng.random(K) < 0.3, 20, 3) for c in cands}
        for c in cands:                  # a neighbourhood that drifts
            rows[c][(c + step) % K] = 30
        _, jc = jlc_._evaluate_candidates(None, 0, 20 + step, cands, rows)
        _, tc = tlc_._evaluate_candidates(None, 0, 20 + step, cands, rows)
        assert jc == tc is False
        assert tlc_.consistent_groups == jlc_.consistent_groups
    assert tried["port"] == tried["jax"] and tried["port"]


def test_group_accumulated_scores_ties_match_jax():
    rng = np.random.default_rng(2)
    C = 32
    cscore = rng.random(C).astype(np.float32)
    w = rng.integers(0, 4, (C, C)).astype(np.int32)     # many ties
    cok = rng.random(C) < 0.8
    np.testing.assert_allclose(
        A(tdb.group_accumulated_scores(T(cscore), T(w), T(cok))),
        np.asarray(jdb.group_accumulated_scores(
            jnp.asarray(cscore), jnp.asarray(w), jnp.asarray(cok))),
        atol=1e-6)


# ---------------------------------------------------------- horn, Sim3 ----

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


def _jax_hypotheses(key, valid, n_hyp, size):
    """JAX's RANSAC draws, exactly as sim3solver.py:45-48 / pnp.py:165-168
    make them."""
    p = jnp.asarray(valid).astype(jnp.float32)
    p = p / jnp.clip(jnp.sum(p), 1.0, None)
    return np.asarray(jax.random.choice(key, valid.shape[0],
                                        shape=(n_hyp, size), replace=True,
                                        p=p))


def _assert_sim3_equal(t, j):
    np.testing.assert_array_equal(A(t.inliers), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)
    assert bool(t.ok) == bool(j.ok)
    for a, b in ((t.s12, j.s12), (t.R12, j.R12), (t.t12, j.t12)):
        np.testing.assert_allclose(A(a), np.asarray(b), atol=1e-4)


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


def _sim3_inputs(b, kf1, kf2):
    """The pair's matched camera-frame points and validity, as
    match_for_sim3 builds them (the port's matches equal JAX's)."""
    tms = b["tms"]
    from orbslam2_tpu_torch.ops import matching as tmatch
    lcfg = b["tcfg"].loop
    v1 = tms.kf_kp_valid[kf1] & (tms.kf_mp[kf1] >= 0)
    v2 = tms.kf_kp_valid[kf2] & (tms.kf_mp[kf2] >= 0)
    m, _ = tmatch.match_descriptors(
        tms.kf_desc[kf1], v1, tms.kf_desc[kf2], v2,
        nn_ratio=lcfg.sim3_nn_ratio, th=tmatch.TH_LOW,
        angle_a=tms.kf_angle[kf1], angle_b=tms.kf_angle[kf2])
    ok = m >= 0
    mp1 = tms.kf_mp[kf1].long()
    mp2 = tms.kf_mp[kf2][torch.where(ok, m, 0)].long()
    return A(ok & (mp1 >= 0) & (mp2 >= 0)
             & tms.mp_valid[torch.where(mp1 >= 0, mp1, 0)]
             & tms.mp_valid[torch.where(mp2 >= 0, mp2, 0)])


def test_match_for_sim3_matches_jax(built):
    b = built
    kf1, kf2 = _covisible_pair(b)
    key = jax.random.PRNGKey(7)
    j = b["jf"][3](b["ms"], jnp.int32(kf1), jnp.int32(kf2), key)
    idx = _jax_hypotheses(key, _sim3_inputs(b, kf1, kf2), 128, 3)
    t, m = b["tf"].match_for_sim3(b["tms"], kf1, kf2, None, idx=T(idx))
    _assert_sim3_equal(t, j)
    assert int((m >= 0).sum()) >= 20


# -------------------------------------------------- sim3opt, recount ------

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


def test_refine_and_recount_match_jax(built):
    b = built
    kf1, kf2 = _covisible_pair(b)
    T12 = np.asarray(b["ms"].kf_pose[kf1]) @ np.linalg.inv(
        np.asarray(b["ms"].kf_pose[kf2]))
    s12, R12, t12 = (jnp.float32(1.0), jnp.asarray(T12[:3, :3]),
                     jnp.asarray(T12[:3, 3]))
    j = b["jf"][10](b["ms"], jnp.int32(kf1), jnp.int32(kf2), s12, R12, t12)
    t = b["tf"].refine_sim3(b["tms"], kf1, kf2, T(s12), T(R12), T(t12))
    for a, c in zip(t[:3], j[:3]):
        np.testing.assert_allclose(A(a), np.asarray(c), atol=1e-4)
    assert abs(int(t[3]) - int(j[3])) <= 1 and int(j[3]) >= 20
    jn = b["jf"][4](b["ms"], jnp.int32(kf1), jnp.int32(kf2), *j[:3])
    tn = b["tf"].recount_matches(b["tms"], kf1, kf2, *t[:3])
    assert int(tn) == int(jn) >= 40


def _scale_cfg(K, P):
    """tests/test_gba.py's configuration at K keyframe slots, P point
    slots and 1000 features (1024 keypoint columns)."""
    cfg = gba_cfg()
    return dataclasses.replace(
        cfg, orb=dataclasses.replace(cfg.orb, n_features=1000),
        capacity=dataclasses.replace(cfg.capacity, max_keyframes=K,
                                     max_map_points=P))


def _at_scale(ms, cfg, rng):
    """``ms`` laid into an empty map of ``cfg``'s capacity: the keyframes
    keep their slots, the points move to slots spread over the whole
    range (``kf_mp`` follows), and every added slot and keypoint column
    is empty."""
    big = {k: np.array(v) for k, v in JM.empty_map(cfg)._asdict().items()}
    src = {k: np.asarray(v) for k, v in ms._asdict().items()}
    k0, n0 = src["kf_xy"].shape[:2]
    slots = np.sort(rng.choice(cfg.capacity.max_map_points,
                               src["mp_pos"].shape[0], replace=False))
    for k, v in src.items():
        if k.startswith("kf_"):
            big[k][(slice(0, k0), slice(0, n0))[:v.ndim]] = v
        else:
            big[k][slots] = v
    kmp = big["kf_mp"][:k0, :n0]
    big["kf_mp"][:k0, :n0] = np.where(kmp >= 0, slots[np.maximum(kmp, 0)],
                                      kmp)
    return JM.MapState(**{k: jnp.asarray(v) for k, v in big.items()})


def test_recount_matches_at_1024_slots_blocks_and_matches_jax(
        built, monkeypatch):
    """``recount_matches`` on the map laid into 1024 keyframe slots, 1024
    keypoint columns and 131,072 point slots: the whole-map search runs in
    blocks (no [P, N] tensor: the Hamming matrices are
    [PROJECTION_BLOCK, 1024]), and the count equals the JAX function's on
    the same map and the count on the map as built."""
    b = built
    K, N, P = 1024, 1024, 1 << 17
    cfg = _scale_cfg(K, P)
    ms_big = _at_scale(b["ms"], cfg, np.random.default_rng(5))
    kf1, kf2 = _covisible_pair(b)
    T12 = np.asarray(b["ms"].kf_pose[kf1]) @ np.linalg.inv(
        np.asarray(b["ms"].kf_pose[kf2]))
    s12, R12, t12 = (jnp.float32(1.0), jnp.asarray(T12[:3, :3]),
                     jnp.asarray(T12[:3, 3]))
    j_small = b["jf"][4](b["ms"], jnp.int32(kf1), jnp.int32(kf2), s12, R12,
                         t12)
    jf = jlc.make_loop_fns(cfg, b["voc"])
    j_big = jf[4](ms_big, jnp.int32(kf1), jnp.int32(kf2), s12, R12, t12)
    tf = tlc.make_loop_fns(port_cfg(cfg), b["tv"])
    shapes = []
    hm = tmatching.hamming.hamming_matrix

    def spy(a, c):
        shapes.append((a.shape[0], c.shape[0]))
        return hm(a, c)

    monkeypatch.setattr(tmatching.hamming, "hamming_matrix", spy)
    t_big = tf.recount_matches(port_ms(ms_big), kf1, kf2, T(s12), T(R12),
                               T(t12))
    B = tmatching.PROJECTION_BLOCK
    assert shapes == [(B, N)] * (P // B)
    assert int(t_big) == int(j_big) == int(j_small) >= 40


# ---------------------------------------------------- pose graph ----------

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


@pytest.mark.parametrize("s12", [1.0, 1.1], ids=["s12=1.0", "s12=1.1"])
def test_correct_loop_and_fuse_match_jax(built, s12):
    """A loop edge between the newest keyframe and keyframe 0 carrying a
    2 cm / 0.5° correction: essential graph, point correction, then
    SearchAndFuse on the corrected map.  With a scale (s12 = 1.1) both
    packages' loop functions are made for mono, whose pose graph frees the
    scale (fix_scale=False), as mono's loops need."""
    b = dict(built)
    if s12 != 1.0:
        b["jf"] = jlc.make_loop_fns(
            dataclasses.replace(b["cfg"], sensor=MONOCULAR), b["voc"])
        b["tf"] = tlc.make_loop_fns(
            dataclasses.replace(b["tcfg"], sensor=tconfig.MONOCULAR), b["tv"])
    ms, tms = b["ms"], b["tms"]
    kf_cur, kf_loop = b["live"][-1], b["live"][0]
    T12 = np.asarray(ms.kf_pose[kf_cur]) @ np.linalg.inv(
        np.asarray(ms.kf_pose[kf_loop]))
    dT = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.0, 0.009, 0.0, 0.02, 0.0, 0.01], jnp.float32)))
    T12 = (dT @ T12).astype(np.float32)
    s12, R12, t12 = np.float32(s12), T12[:3, :3], T12[:3, 3]
    pl_i = np.array([kf_cur] + [0] * 7, np.int32)
    pl_j = np.array([b["live"][1]] + [0] * 7, np.int32)
    pl_ok = np.array([True] + [False] * 7)
    jms = b["jf"][5](ms, jnp.int32(kf_cur), jnp.int32(kf_loop),
                     jnp.float32(s12), jnp.asarray(R12), jnp.asarray(t12),
                     jnp.asarray(pl_i), jnp.asarray(pl_j),
                     jnp.asarray(pl_ok))
    t_ms = b["tf"].correct_loop(tms, kf_cur, kf_loop, torch.tensor(s12),
                                T(R12), T(t12), T(pl_i), T(pl_j), T(pl_ok))
    np.testing.assert_allclose(A(t_ms.kf_pose), np.asarray(jms.kf_pose),
                               atol=1e-3)
    np.testing.assert_allclose(A(t_ms.mp_pos), np.asarray(jms.mp_pos),
                               atol=1e-2)
    moved = np.abs(np.asarray(jms.kf_pose) - np.asarray(ms.kf_pose)).max()
    assert moved > 1e-3, moved

    jms2, jn = b["jf"][9](jms, jnp.int32(kf_cur), jnp.int32(kf_loop))
    t_ms2, tn = b["tf"].fuse_after_loop(port_ms(jms), kf_cur, kf_loop)
    assert int(tn) == int(jn)
    got = to_numpy(t_ms2)
    for k in ("kf_mp", "mp_valid", "mp_n_obs", "mp_desc"):
        ref = np.asarray(getattr(jms2, k))
        same = (got[k] == ref).reshape(ref.shape[0], -1).all(1).mean()
        assert same >= 0.99, (k, same)


# ----------------------------------------------------------------- GBA ----

def _assert_points_close(got, ref):
    """1e-2 m, or 3e-4 of the distance beyond 33 m (the module docstring)."""
    tol = np.maximum(1e-2, 3e-4 * np.linalg.norm(ref, axis=-1))
    err = np.linalg.norm(got - ref, axis=-1)
    assert np.all(err <= tol), (err.max(), np.argmax(err - tol))


def test_gba_chunk_and_merge_match_jax(built):
    b = built
    cfg, tcfg = b["cfg"], b["tcfg"]
    ms_pert = _perturb(b["ms"], np.random.default_rng(8))
    j_chunk, j_merge = jgba.make_gba_fns(cfg)
    t_chunk, t_merge = tgba.make_gba_fns(tcfg)
    K, N = ms_pert.K, ms_pert.N
    jms, jw = ms_pert, jnp.ones((K * N,), bool)
    tms, tw = port_ms(ms_pert), torch.ones(K * N, dtype=torch.bool)
    for chunk in range(2):
        jms, jw = j_chunk(jms, jw, use_huber=(chunk == 0))
        tms, tw = t_chunk(tms, tw, use_huber=(chunk == 0))
        np.testing.assert_allclose(A(tms.kf_pose), np.asarray(jms.kf_pose),
                                   atol=1e-3)
        _assert_points_close(A(tms.mp_pos), np.asarray(jms.mp_pos))
        assert (A(tw) == np.asarray(jw)).mean() >= 0.99
    # merge into a live map that gained a keyframe (child of the newest)
    parent, free = b["live"][-1], int(np.where(
        ~np.asarray(ms_pert.kf_valid))[0][0])
    T_rel = np.eye(4, dtype=np.float32)
    T_rel[2, 3] = 0.5
    live = ms_pert._replace(
        kf_valid=ms_pert.kf_valid.at[free].set(True),
        kf_pose=ms_pert.kf_pose.at[free].set(
            jnp.asarray(T_rel) @ ms_pert.kf_pose[parent]),
        kf_parent=ms_pert.kf_parent.at[free].set(parent),
        kf_frame_id=ms_pert.kf_frame_id.at[free].set(999))
    jres = jgba.GbaResult(
        snap_kf_frame_id=ms_pert.kf_frame_id, snap_kf_valid=ms_pert.kf_valid,
        old_poses=ms_pert.kf_pose, new_poses=jms.kf_pose,
        snap_mp_first=ms_pert.mp_first_kf, snap_mp_valid=ms_pert.mp_valid,
        new_points=jms.mp_pos)
    tres = tgba.GbaResult(*[T(np.asarray(x)) for x in jres])
    jm = j_merge(live, jres)
    tm = t_merge(port_ms(live), tres)
    np.testing.assert_allclose(A(tm.kf_pose), np.asarray(jm.kf_pose),
                               atol=1e-3)
    _assert_points_close(A(tm.mp_pos), np.asarray(jm.mp_pos))


def test_gba_manager_launch_wait_merge_abort(built):
    b = built
    tms = port_ms(_perturb(b["ms"], np.random.default_rng(9)))
    mgr = tgba.GbaManager(b["tcfg"], n_chunks=2)
    mgr.launch(tms)
    mgr.abort()                           # supersede at once
    assert not mgr.running
    assert not mgr.poll_and_merge(tms)[1]
    assert mgr.stats["aborted"] + mgr.stats["finished"] == 1
    mgr.launch(tms)
    mgr.wait(timeout=600)
    assert not mgr.running and mgr.stats["finished"] >= 1
    merged, applied = mgr.poll_and_merge(tms)
    assert applied and mgr.stats["merged"] == 1
    assert not mgr.poll_and_merge(merged)[1]          # second poll: no-op
    assert float(torch.abs(merged.kf_pose - tms.kf_pose).max()) > 1e-4


def test_gba_manager_hands_a_thread_failure_to_the_map_owner(built):
    mgr = tgba.GbaManager(built["tcfg"])

    def broken(*args, **kwargs):
        raise ValueError("broken chunk")

    mgr.f_chunk = broken
    mgr.launch(built["tms"])
    with pytest.raises(RuntimeError, match="global BA failed"):
        mgr.wait(timeout=60)
    assert not mgr.running and mgr.stats["finished"] == 0
    assert not mgr.poll_and_merge(built["tms"])[1]   # raised once only


def test_gba_snapshot_unchanged_by_later_map_updates(built):
    """The thread's snapshot stays as it was handed over while the map
    owner goes on updating the map (every update returns new tensors)."""
    b = built
    from orbslam2_tpu_torch.runtime import local_mapping as tlm
    snap = port_ms(b["ms"])
    before = {k: v.clone() for k, v in snap._asdict().items()}
    mgr = tgba.GbaManager(b["tcfg"], n_chunks=1)
    mgr.launch(snap)
    ms = snap
    mfns = tlm.MappingFns(b["tcfg"])
    kf = b["live"][-1]
    ms, _ = mfns.local_ba(ms, kf)
    ms, _ = mfns.fuse_into_kf(ms, kf)
    ms, _ = mfns.cull_map_points(ms, 20)
    ms = TM.add_keyframe(ms, 15, ms.kf_pose[kf], 77, 7.7, ms.kf_xy[kf],
                         ms.kf_level[kf], ms.kf_angle[kf], ms.kf_desc[kf],
                         ms.kf_kp_valid[kf], ms.kf_ur[kf], ms.kf_depth[kf],
                         ms.kf_mp[kf], kf)
    ms = b["tf"].correct_loop(
        ms, kf, b["live"][0], torch.tensor(1.0), torch.eye(3),
        torch.zeros(3), torch.zeros(8, dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.bool))
    mgr.wait(timeout=600)
    assert not mgr.running
    for k, v in snap._asdict().items():
        assert torch.equal(v, before[k]), k
    assert mgr.poll_and_merge(ms)[1]


# ---------------------------------------------------------- the engines ---

CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0, width=640,
              height=480, fps=10.0, th_depth=60.0)


def _ate(poses_est, poses_gt, rebase=None):
    errs = []
    for Te, Tg in zip(poses_est, poses_gt):
        if Te is None:
            continue
        if rebase is not None:
            Te = Te @ rebase
        errs.append(np.sum((-Te[:3, :3].T @ Te[:3, 3]
                            + Tg[:3, :3].T @ Tg[:3, 3]) ** 2))
    return float(np.sqrt(np.mean(errs))), len(errs)


def _engines(cap, n_features, voc):
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig,
                                     OrbConfig)
    cfg = SlamConfig(camera=CameraConfig(**CAM_KW),
                     orb=OrbConfig(n_features=n_features),
                     capacity=CapacityConfig(**cap), sensor=STEREO)
    return (JaxEngine(cfg, vocabulary=voc),
            TorchEngine(port_cfg(cfg), device="cpu",
                        vocabulary=port_voc(voc)))


def test_port_engine_with_loop_closing_tracks_like_jax():
    """Both engines with loop closing on, over the 10-frame corridor of
    tests/test_torch_slice.py."""
    voc = jvoc.default_vocabulary()
    jeng, teng = _engines(dict(max_keyframes=16, max_map_points=4096,
                               local_ba_keyframes=8, local_ba_points=1024),
                          400, voc)
    assert teng.loop_closer is not None
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(10, step=0.25)
    for i, Tcw in enumerate(poses):
        left, right = synthetic.render_world_stereo(
            world, jeng.cfg.camera, Tcw, rng, noise=1.0)
        assert jeng.track_stereo(left, right, 0.1 * i) is not None, i
        assert teng.track_stereo(left, right, 0.1 * i) is not None, i
    assert jeng.finish_gba() is False and teng.finish_gba() is False
    j_ate, jn = _ate(jeng.frame_poses(), poses)
    t_ate, tn = _ate(teng.frame_poses(), poses)
    assert jn == tn == len(poses)
    assert abs(teng.stats["kf_inserted"] - jeng.stats["kf_inserted"]) <= 1
    assert abs(t_ate - j_ate) < 0.03, (t_ate, j_ate)
    # every live keyframe but the stereo-initialization one is in the DB
    live = set(np.where(A(teng.ms.kf_valid))[0].tolist())
    in_db = set(np.where(A(teng.loop_closer.db.valid))[0].tolist())
    assert in_db == live - {0}, (in_db, live)


@pytest.mark.slow
def test_port_engine_closes_the_orbit_loop_like_jax():
    """tests/test_loop_closing.py's outward orbit (1.25 turns, 72 frames):
    both engines close at least one loop and end below 0.5 m ATE."""
    from test_loop_closing import orbit_scene, outward_orbit
    voc = jvoc.default_vocabulary()
    jeng, teng = _engines(dict(max_keyframes=64, max_map_points=1 << 14,
                               local_ba_keyframes=8, local_ba_points=2048),
                          600, voc)
    rng = np.random.default_rng(0)
    scene = orbit_scene(rng)
    poses = outward_orbit(72, radius=4.0, z_center=10.0, turns=1.25)
    for i, Tcw in enumerate(poses):
        left, right = synthetic.render_stereo(scene, jeng.cfg.camera, Tcw,
                                              rng, 1.0)
        jeng.track_stereo(left, right, 0.1 * i)
        teng.track_stereo(left, right, 0.1 * i)
    for eng in (jeng, teng):
        assert eng.stats["loops_closed"] >= 1, eng.stats
        eng.finish_gba()
        ate, n = _ate(eng.frame_poses(), poses, rebase=poses[0])
        assert n > 0.85 * len(poses) and ate < 0.5, (ate, n, eng.stats)
