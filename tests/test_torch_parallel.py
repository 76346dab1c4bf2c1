"""The port's ``parallel/*`` (mesh, point-sharded bundle adjustment, row-
sharded keyframe DB) and its routing through ``GbaManager``,
``LoopCloser`` and ``System.load_map``, against the JAX package on the 8
virtual CPU devices that tests/conftest.py forces, with the port's mesh
of 8 CPU shards (``make_mesh(["cpu"] * 8)``).

Tolerances:

  * ``_partition_by_point`` and ``collectives_accounting``: bit-equal to
    JAX's, at 8 and at 3 shards;
  * ``distributed_bundle_adjust`` on tests/test_bundle.py's problem,
    8 shards against JAX's 8-device mesh: poses within 5e-4 (JAX's own
    sharded-against-single bar, tests/test_dist_ba.py:33), inlier masks
    equal on > 99%; the shards' poses bit-equal to each other; a 1-shard
    mesh against plain ``bundle_adjust(solver="cg")`` within 1e-5;
  * the sharded DB: candidates equal to JAX's ``detect_candidates_sharded``
    (and to the dense query where K does not divide by the shards),
    scores within 1e-6; ``detect_step`` through an 8-shard ``LoopCloser``:
    BoW vectors within 1e-6 of the dense closer's, candidates and
    covisibility rows equal;
  * ``GbaManager`` with a 4-shard mesh against the unsharded manager on a
    perturbed port-built map: poses within 1e-4, points nearer than 20 m
    within 1e-3 m, all within 2e-2 of their range (chip_smoke.py phase
    16's bars; the unsharded manager solves densely at 16 slots, the
    sharded one by CG).
"""

import dataclasses
import threading
import time

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
from orbslam2_tpu.parallel import db_shard as jshard
from orbslam2_tpu.parallel import dist_ba as jdist
from orbslam2_tpu.parallel import mesh as jmesh
from orbslam2_tpu.runtime import loop_closing as jlc
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import (keyframe_db_from_numpy,
                                        map_state_from_numpy, to_numpy)
from orbslam2_tpu_torch.models import keyframe_db as tdb
from orbslam2_tpu_torch.models import map_state as TM
from orbslam2_tpu_torch.models import vocabulary as tvoc
from orbslam2_tpu_torch.ops import bundle as tb
from orbslam2_tpu_torch.parallel import db_shard, dist_ba
from orbslam2_tpu_torch.parallel import mesh as mesh_mod
from orbslam2_tpu_torch.runtime import gba as tgba
from orbslam2_tpu_torch.runtime import loop_closing as tlc
from orbslam2_tpu_torch.runtime import serialization
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.utils import camera as tcam
from orbslam2_tpu_torch.utils import lie as tlie
from orbslam2_tpu_torch.utils import synthetic
from test_bundle import CAM_CFG, _make_ba_problem
from test_torch_mapping import _port_problem

torch.set_num_threads(2)

TCAM = tcam.Camera.from_config(
    tconfig.CameraConfig(**dataclasses.asdict(CAM_CFG)))


def cpu_mesh(n, **kw):
    return mesh_mod.make_mesh(["cpu"] * n, **kw)


# ------------------------------------------------ partition, accounting --

@pytest.mark.parametrize("n_dev", [8, 3])
def test_partition_and_accounting_equal_jax(n_dev):
    rng = np.random.default_rng(0)
    _, prob, *_ = _make_ba_problem(rng, n_pts=100)
    # an out-of-range point index and an invalid row: JAX's clip routes
    # them, and the copy must route them the same way
    prob = prob._replace(pt_i=prob.pt_i.at[3].set(150),
                         valid=prob.valid.at[5].set(False))
    tobs, tsrc, tP, tO = dist_ba._partition_by_point(_port_problem(prob),
                                                     n_dev)
    jobs, jsrc, jP, jO = jdist._partition_by_point(prob, n_dev)
    assert (tP, tO) == (jP, jO)
    np.testing.assert_array_equal(tsrc, jsrc)
    assert tobs.keys() == jobs.keys()
    for k in jobs:
        assert tobs[k].dtype == jobs[k].dtype, k
        np.testing.assert_array_equal(tobs[k], jobs[k], err_msg=k)
    for args in ((5, 48, 6), (15, 48, 512), (1, 8, n_dev)):
        assert (dist_ba.collectives_accounting(*args)
                == jdist.collectives_accounting(*args))


# ---------------------------------------------------- distributed BA ----

@pytest.fixture(scope="module")
def ba_problem():
    rng = np.random.default_rng(0)
    cam, prob, poses_true, _, _ = _make_ba_problem(rng)
    return cam, prob, _port_problem(prob)


def test_distributed_ba_8_shards_matches_jax_mesh(ba_problem):
    cam, prob, tprob = ba_problem
    outs = dist_ba.shard_bundle_adjust(cpu_mesh(8), TCAM, tprob, n_free=6)
    poses, points, inlier = outs[0]
    # every shard ends with the same bits (the LM branches agree)
    for p, x, m in outs[1:]:
        assert torch.equal(p, poses)
        assert torch.equal(x, points) and torch.equal(m, inlier)
    jp, jx, ji = jdist.distributed_bundle_adjust(jmesh.make_mesh(), cam,
                                                 prob, n_free=6)
    assert len(jax.devices()) == 8
    np.testing.assert_allclose(poses.numpy(), np.asarray(jp), atol=5e-4)
    assert (inlier.numpy() == np.asarray(ji)).mean() > 0.99
    assert tuple(points.shape) == tuple(tprob.points.shape)


def test_one_shard_mesh_matches_plain_cg(ba_problem):
    _, _, tprob = ba_problem
    p1, x1, i1 = dist_ba.distributed_bundle_adjust(cpu_mesh(1), TCAM,
                                                   tprob, n_free=6)
    sp, sx, si = tb.bundle_adjust(TCAM, tprob, n_free=6, solver="cg")
    np.testing.assert_allclose(p1.numpy(), sp.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x1.numpy(), sx.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(i1, si)


def test_dense_solver_with_a_mesh_raises(ba_problem):
    _, _, tprob = ba_problem
    with pytest.raises(ValueError, match="CG-Schur only"):
        dist_ba.distributed_bundle_adjust(cpu_mesh(2), TCAM, tprob,
                                          n_free=6, solver="dense")
    with pytest.raises(ValueError, match="requires solver='cg'"):
        tb.bundle_adjust(TCAM, tprob, n_free=6, solver="dense",
                         allsum=lambda x: x)


# ------------------------------------------------------------- mesh -----

def _raises_at_shard_2(x):
    x = MESH4.allsum(x)
    if int(x[0]) == 4 and threading.current_thread().name.endswith("-2"):
        raise ValueError("shard 2 failed")
    return MESH4.allsum(x)


def _returns_early(x):
    if threading.current_thread().name.endswith("-1"):
        return x
    return MESH4.allsum(x)


def _stalls(x):
    if threading.current_thread().name.endswith("-3"):
        time.sleep(3.0)
    return MESH4.allsum(x)


MESH4 = cpu_mesh(4, timeout=1.0)


@pytest.mark.parametrize("fn,err", [
    (_raises_at_shard_2, ValueError),
    (_returns_early, mesh_mod.MeshAborted),
    (_stalls, mesh_mod.MeshAborted)])
def test_a_failing_shard_raises_and_does_not_hang(fn, err):
    t0 = time.perf_counter()
    with pytest.raises(err):
        MESH4.run(fn, [torch.ones(3)] * 4)
    assert time.perf_counter() - t0 < 10.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesh-shard")]
    # the mesh still works afterwards, and allsum hands every shard the
    # same sum
    outs = MESH4.run(lambda x: MESH4.allsum(x), [torch.full((3,), float(i))
                                                 for i in range(4)])
    assert all(torch.equal(o, torch.full((3,), 6.0)) for o in outs)


def test_allsum_under_stress_hands_every_shard_every_sum():
    """16 shards (more than this host's cores) and a switch interval of
    1 µs: each of 200 rounds sums distinct per-shard values, and every
    shard must see every round's exact sum (a lost or stale slot breaks
    it)."""
    import sys
    n, rounds = 16, 200
    mesh = cpu_mesh(n, timeout=60.0)

    def fn(i):
        seen = []
        for r in range(rounds):
            seen.append(int(mesh.allsum(torch.tensor([i * 1000 + r]))[0]))
        return seen

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = mesh.run(fn, list(range(n)))
    finally:
        sys.setswitchinterval(old)
    want = [1000 * n * (n - 1) // 2 + n * r for r in range(rounds)]
    assert all(o == want for o in outs)


def test_allsum_outside_run_raises():
    with pytest.raises(RuntimeError, match="outside Mesh.run"):
        MESH4.allsum(torch.ones(2))


def test_auto_rule_makes_no_mesh_on_the_cpu_or_one_card(monkeypatch):
    assert mesh_mod.auto_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_mod.auto_mesh("cuda:0") is None
    assert mesh_mod.auto_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = mesh_mod.auto_mesh("cuda:0")
    assert m.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh_mod.auto_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh()


def test_auto_mesh_puts_the_components_device_first(monkeypatch):
    """On a host of several cards the auto mesh starts at the component's
    own card, so that the sharded DB and GBA hand their results back
    there (a closer on cuda:1 reads them against its map on cuda:1)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert mesh_mod.auto_mesh("cuda:1").devices == (cuda[1], cuda[0],
                                                    cuda[2])
    assert mesh_mod.auto_mesh("cuda:0").devices == tuple(cuda)
    assert mesh_mod.auto_mesh("cuda").devices == (cuda[2], cuda[0],
                                                  cuda[1])


def test_sharded_db_gathers_onto_the_dense_dbs_device():
    """Scores of ~16 are held at JAX's bar for the same comparison
    (tests/test_db_shard_engine.py: rtol 1e-5, atol 1e-7): the two
    products' shapes may round a row an ULP (1.9e-6 there) apart."""
    K, W = 20, 64
    rng = np.random.default_rng(0)
    db = tdb.KeyFrameDB(
        bow=torch.from_numpy(rng.random((K, W), dtype=np.float32)),
        valid=torch.ones(K, dtype=bool))
    sdb = db_shard.shard_db(cpu_mesh(4), db)
    assert sdb.home == db.bow.device
    q = torch.from_numpy(rng.random(W, dtype=np.float32))
    assert sdb.scores(q).device == sdb.valid.device == sdb.home
    assert sdb.gathered().bow.device == sdb.home
    np.testing.assert_allclose(sdb.scores(q).numpy(), (db.bow @ q).numpy(),
                               rtol=1e-5, atol=1e-7)


# -------------------------------------------------------- sharded DB ----

def _db_case(K, W=1024, seed=0):
    rng = np.random.default_rng(seed)
    cfg = SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480),
        orb=OrbConfig(n_features=64),
        capacity=CapacityConfig(max_keyframes=K, max_map_points=256),
        sensor=STEREO)
    ms = JM.empty_map(cfg)
    ms = ms._replace(kf_valid=jnp.asarray(rng.random(K) < 0.9))
    bow = rng.random((K, W)).astype(np.float32)
    bow /= np.linalg.norm(bow, axis=1, keepdims=True)
    valid = rng.random(K) < 0.8
    q = rng.random(W).astype(np.float32)
    q /= np.linalg.norm(q)
    return ms, bow, valid, q


@pytest.mark.parametrize("K", [16, 20])
def test_sharded_db_matches_jax(K):
    ms, bow, valid, q = _db_case(K)
    jd = jdb.KeyFrameDB(bow=jnp.asarray(bow), valid=jnp.asarray(valid))
    tms = map_state_from_numpy({k: np.asarray(v)
                                for k, v in ms._asdict().items()})
    td = keyframe_db_from_numpy({"bow": bow, "valid": valid})
    mesh = cpu_mesh(8)
    sh = db_shard.shard_db(mesh, td)
    assert len(sh.blocks) == 8 and sh.blocks[0].bow.shape[0] == -(-K // 8)
    tq = torch.from_numpy(q)
    tc, ts = db_shard.detect_candidates_sharded(mesh, sh, tms, tq, -1, 0.0,
                                                8)
    if K % 8 == 0:           # JAX shards evenly only
        jc, js = jshard.detect_candidates_sharded(
            jmesh.make_mesh(), jshard.shard_db(jmesh.make_mesh(), jd), ms,
            jnp.asarray(q), jnp.int32(-1), jnp.float32(0.0), 8)
    else:
        jc, js = jdb.detect_candidates(jd, ms, jnp.asarray(q),
                                       jnp.int32(-1), jnp.float32(0.0), 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(sh.scores(tq).numpy(), bow @ q, atol=1e-6)
    np.testing.assert_array_equal(sh.valid.numpy(), valid)
    g = sh.gathered()
    assert torch.equal(g.bow, td.bow) and torch.equal(g.valid, td.valid)
    # add / erase reach the owning block only
    sh2 = sh.add(K - 1, torch.ones(1024)).erase(0)
    assert torch.equal(sh2.gathered().bow[K - 1], torch.ones(1024))
    assert not bool(sh2.valid[0]) and bool(sh2.valid[K - 1])
    assert torch.equal(sh.gathered().bow, td.bow)        # sh is unchanged


def _lc_cfg(K=16):
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                                    bf=150.0, width=640, height=480,
                                    fps=10.0, th_depth=60.0),
        orb=tconfig.OrbConfig(n_features=64),
        capacity=tconfig.CapacityConfig(max_keyframes=K,
                                        max_map_points=1 << 10,
                                        local_ba_keyframes=4,
                                        local_ba_points=256),
        sensor=tconfig.STEREO)


def _random_map(cfg, rng, n_kfs=8):
    """tests/test_db_shard_engine.py's map: random descriptors and
    validity on the first n_kfs keyframes, and covisibility among them."""
    d = to_numpy(TM.empty_map(cfg))
    K, N = cfg.capacity.max_keyframes, cfg.orb.n_features_padded
    d["kf_desc"] = rng.integers(0, 2 ** 32, size=(K, N, 8), dtype=np.uint32)
    d["kf_kp_valid"][:n_kfs] = rng.random((n_kfs, N)) < 0.9
    d["kf_valid"][:n_kfs] = True
    # keyframes 0-3 share points, so the covisibility rows are not empty
    d["kf_mp"][:4, :40] = np.arange(40)
    d["mp_valid"][:40] = True
    return d


@pytest.fixture(scope="module")
def voc():
    return tvoc.default_vocabulary(k=10, levels=4, device="cpu")


def test_loop_closer_on_a_mesh_matches_the_dense_db(voc):
    cfg = _lc_cfg()
    rng = np.random.default_rng(0)
    d = _random_map(cfg, rng)
    ms = map_state_from_numpy(d)
    mesh = cpu_mesh(8)
    lc = tlc.LoopCloser(cfg, voc, device="cpu", mesh=mesh)
    dense = tlc.LoopCloser(cfg, voc, device="cpu")
    assert lc.mesh is mesh and lc.gba.mesh is mesh and dense.mesh is None
    assert isinstance(lc.db, db_shard.ShardedKeyFrameDB)
    assert isinstance(dense.db, tdb.KeyFrameDB)
    # JAX's sharded closer on its 8 devices (tests/test_db_shard_engine.py)
    jcfg = SlamConfig(
        camera=CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=OrbConfig(n_features=64),
        capacity=CapacityConfig(**dataclasses.asdict(cfg.capacity)),
        sensor=STEREO)
    jl = jlc.LoopCloser(jcfg, jvoc.default_vocabulary())
    assert jl.mesh is not None
    jms = JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    for k in range(6):
        lc.db, vec, info = lc.fns.detect_step(ms, lc.db, k)
        dense.db, dvec, dinfo = dense.fns.detect_step(ms, dense.db, k)
        jl.db, jvec, jinfo = jl.f_detect_step(jms, jl.db, jnp.int32(k))
        np.testing.assert_allclose(vec.numpy(), dvec.numpy(), atol=1e-6)
        np.testing.assert_allclose(vec.numpy(), np.asarray(jvec), atol=1e-6)
        assert torch.equal(info, dinfo)
        np.testing.assert_array_equal(info[:, 0].numpy(),
                                      np.asarray(jinfo)[:, 0])
        np.testing.assert_allclose(lc.db.scores(vec).numpy(),
                                   dense.db.scores(vec).numpy(), atol=1e-6)
        assert isinstance(lc.db, db_shard.ShardedKeyFrameDB)
    np.testing.assert_allclose(lc.db.gathered().bow.numpy(),
                               dense.db.bow.numpy(), atol=1e-7)
    # the relocalization query reads the sharded DB as the dense one
    fd_vec = dense.fns.kf_bow_vector(ms, 2)
    c1, s1 = lc.fns.detect(ms, lc.db, -1, fd_vec, 0.0)
    c2, s2 = dense.fns.detect(ms, dense.db, -1, fd_vec, 0.0)
    assert torch.equal(c1, c2)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-6)
    # the sharding survives erase and reset
    lc.db = lc.db.erase(0)
    assert isinstance(lc.db, db_shard.ShardedKeyFrameDB)
    assert not bool(lc.db.valid[0]) and bool(lc.db.valid[1])
    lc.reset()
    assert isinstance(lc.db, db_shard.ShardedKeyFrameDB)
    assert lc.db.mesh is mesh and not bool(lc.db.valid.any())


# --------------------------------- GbaManager, save_map, System.load_map --

GCAM = tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                            bf=75.0, width=320, height=240, fps=10.0,
                            th_depth=60.0)
GCFG = tconfig.SlamConfig(
    camera=GCAM, orb=tconfig.OrbConfig(n_features=200),
    capacity=tconfig.CapacityConfig(max_keyframes=16, max_map_points=2048,
                                    local_ba_keyframes=4,
                                    local_ba_points=512),
    sensor=tconfig.STEREO)


@pytest.fixture(scope="module")
def small_map():
    """A stereo map of 6 frames built by the port on the CPU with loop
    closing on (its DB holds the keyframes), and a perturbed copy of it
    (keyframes but the first, every point) for the GBA."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(6, step=0.3)
    eng = SlamEngine(GCFG, device="cpu")
    assert eng.loop_closer.mesh is None          # the CPU: no mesh
    for i, T in enumerate(poses):
        assert eng.track_stereo(*synthetic.render_world_stereo(
            world, GCAM, T, rng, 1.0), 0.1 * i) is not None, i
    eng.finish_gba()
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
    return {"eng": eng, "perturbed": d, "world": world, "poses": poses}


def _merged(mgr, ms):
    mgr.launch(ms)
    mgr.wait()
    out, merged = mgr.poll_and_merge(ms)
    assert merged
    return out


def test_gba_manager_on_a_mesh_matches_the_unsharded_manager(small_map):
    d = small_map["perturbed"]
    ms = map_state_from_numpy(d)
    mesh = cpu_mesh(4)
    mgr = tgba.GbaManager(GCFG, mesh=mesh)
    plain = tgba.GbaManager(GCFG)
    got = _merged(mgr, ms)
    want = _merged(plain, ms)
    assert mgr.stats["distributed"] == 1 and mgr.stats["merged"] == 1
    assert plain.mesh is None and plain.stats["distributed"] == 0
    kv, pv = d["kf_valid"], d["mp_valid"]
    gp, wp = got.kf_pose.numpy()[kv], want.kf_pose.numpy()[kv]
    assert np.abs(gp - d["kf_pose"][kv]).max() > 1e-3      # the BA moved
    np.testing.assert_allclose(gp, wp, atol=1e-4, rtol=0)
    c0 = np.linalg.inv(d["kf_pose"][0])[:3, 3]       # the gauge keyframe
    xg, xw = got.mp_pos.numpy()[pv], want.mp_pos.numpy()[pv]
    gap = np.linalg.norm(xg - xw, axis=1)
    rng_m = np.linalg.norm(xw - c0, axis=1)
    near = rng_m < GCAM.th_depth * GCAM.baseline
    assert near.sum() > 100 and gap[near].max() < 1e-3, gap[near].max()
    assert (gap / rng_m).max() < 2e-2


def test_sharded_db_saves_and_system_load_map_shards(small_map, voc,
                                                     tmp_path):
    eng = small_map["eng"]
    dense = eng.loop_closer.db
    assert bool(dense.valid.any())
    mesh = cpu_mesh(8)
    path = str(tmp_path / "map.npz")
    counters = {"n_kfs": eng.n_kfs, "kf_ordinal": eng.kf_ordinal,
                "frame_id": eng.frame_id}
    serialization.save_map(path, eng.ms, db_shard.shard_db(mesh, dense),
                           counters)
    _, db, got = serialization.load_map(path, "cpu")
    assert torch.equal(db.bow, dense.bow) and torch.equal(db.valid,
                                                          dense.valid)
    assert got == counters
    # a System whose loop closer has the mesh: load_map shards the DB
    sys_ = System(None, None, tconfig.STEREO, config=GCFG, device="cpu")
    assert sys_.engine.loop_closer.mesh is None
    sys_.engine.loop_closer = tlc.LoopCloser(GCFG, voc, device="cpu",
                                             mesh=mesh)
    sys_.load_map(path)
    lc = sys_.engine.loop_closer
    assert isinstance(lc.db, db_shard.ShardedKeyFrameDB)
    assert lc.db.mesh is mesh
    assert torch.equal(lc.db.gathered().bow, dense.bow)
    # ... and saving it again writes the same file contents
    path2 = str(tmp_path / "map2.npz")
    sys_.save_map(path2)
    _, db2, _ = serialization.load_map(path2, "cpu")
    assert torch.equal(db2.bow, dense.bow)
    assert torch.equal(db2.valid, dense.valid)


# ------------------------------------------------------ tools/scaling ---

def test_scaling_problem_and_keys_match_the_jax_script():
    from orbslam2_tpu_torch.tools import scaling
    from tools.benchmarks import scaling as jscaling
    cam = tconfig.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                               bf=150.0)
    tp = scaling._problem(cam, 6, 40, 128)
    jp = jscaling._problem(CameraConfig(**dataclasses.asdict(cam)), 6, 40,
                           128)
    for k, t, j in zip(tb.BAProblem._fields, tp, jp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=k)
    out = scaling.measure_scaling(["cpu"] * 4, C=6, pts_per_cam=40,
                                  n_pts=128, repeats=1)
    assert set(out) == {"scaling_devices", "scaling_mode",
                        "scaling_unsharded_ms", "scaling_sharded_ms",
                        "scaling_efficiency_pct", "scaling_shapes"}
    assert out["scaling_devices"] == 4
    assert out["scaling_mode"].startswith("sharding-overhead proxy")
    assert out["scaling_shapes"] == {"cameras": 6, "observations": 240,
                                     "points": 128}
