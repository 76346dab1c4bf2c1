"""The hand-written Hopper kernel against its plain PyTorch version, on
the card.  Skipped where torch has no CUDA device; ``python3
chip_smoke.py`` runs the same comparisons at the main path's shapes.

Tolerance: bit-exact (integer outputs)."""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.ops import hamming_top2 as tk
from orbslam2_tpu_torch.ops import matching

import hamming_checks as hc

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    # decided per test, not at import: every xdist worker collects alike
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU interpret "
                    "mode)")


def _inputs(A, B, seed=0):
    rng = np.random.default_rng(seed)

    def words(n):
        return torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8),
                                             dtype=np.uint32).view(np.int32)
                                ).cuda()

    return (words(A), torch.from_numpy(rng.random(A) < 0.9).cuda(),
            words(B), torch.from_numpy(rng.random(B) < 0.9).cuda())


@pytest.mark.parametrize("A,B", [(1024, 1024), (600, 512), (256, 300),
                                 (1024, 16384), (64, 16384), (7, 1), (1, 1),
                                 (1024, 1), (33, 1025), (0, 16)])
def test_kernel_matches_plain(A, B):
    """The main path's shapes, long banks (64 and 1024 rows against 16384
    columns, 32 chunks), ragged edges (one row, one column, 33 × 1025)
    and no query rows (no launch, empty outputs)."""
    args = _inputs(A, B)
    before = tk.hamming_top2.launches
    got = tk.hamming_top2(*args)
    ref = tk.hamming_top2_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)
    assert tk.hamming_top2.launches == before + (A > 0)


@pytest.mark.parametrize("B", [120, 3 * 4096])
def test_kernel_ties_match_plain(B):
    """Duplicated descriptors: every bank row three times and queries that
    are bank rows, so best and second tie at 0 and the first column must
    win, in one chunk of the bank (120) and across chunks (12288)."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 2 ** 32, (B // 3, 8), dtype=np.uint32)
    bank = np.concatenate([base, base, base]).view(np.int32)
    q = bank[rng.permutation(B)[:64]]
    args = (torch.from_numpy(q).cuda(), torch.ones(64, dtype=torch.bool,
                                                   device="cuda"),
            torch.from_numpy(bank).cuda(), torch.ones(B, dtype=torch.bool,
                                                      device="cuda"))
    got = tk.hamming_top2(*args)
    ref = tk.hamming_top2_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (got[0] == 0).all() and (got[2] == 0).all()


def test_match_descriptors_launches_the_kernel():
    a, av, b, bv = _inputs(512, 512, seed=1)
    before = tk.hamming_top2.launches
    m, d = matching.match_descriptors(a, av, b, bv)
    torch.cuda.synchronize()
    assert tk.hamming_top2.launches == before + 1
    assert m.is_cuda and d.is_cuda


def test_wrapper_rejects_bad_inputs():
    a, av, b, bv = _inputs(64, 64)
    with pytest.raises(TypeError):
        tk.hamming_top2(a.long(), av, b, bv)
    with pytest.raises(ValueError):
        tk.hamming_top2(a.t().contiguous().t(), av, b, bv)  # non-contiguous
    with pytest.raises(ValueError):
        tk.hamming_top2(a[:, :4].contiguous(), av, b, bv)
    with pytest.raises(ValueError):
        tk.hamming_top2(a, av, b.cpu(), bv)
    shifted = torch.zeros(64 * 8 + 1, dtype=torch.int32,
                          device="cuda")[1:].view(64, 8)   # 4-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        tk.hamming_top2(shifted, av, b, bv)


def test_match_for_sim3_launches_the_kernel_and_equals_plain():
    """Loop closing's KF↔KF matching on a map the port's engine built on
    the card: one kernel launch attributed to match_for_sim3, and the same
    matches, inlier mask and Sim3 as the plain version with the same
    generator state."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, STEREO, SlamConfig)
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                       width=640, height=480, fps=10.0, th_depth=60.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=600),
                     capacity=CapacityConfig(max_keyframes=16,
                                             max_map_points=4096,
                                             local_ba_keyframes=8,
                                             local_ba_points=1024),
                     sensor=STEREO)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    eng = SlamEngine(cfg)                 # no device: the card by default
    assert eng.device.type == "cuda"
    for i, T in enumerate(synthetic.straight_trajectory(10, step=0.25)):
        eng.track_stereo(*synthetic.render_world_stereo(world, cam, T, rng,
                                                        1.0), 0.1 * i)
    live = torch.nonzero(eng.ms.kf_valid).flatten().tolist()
    assert len(live) >= 2
    lc = eng.loop_closer
    kf1, kf2 = live[-1], live[-2]
    state = lc.generator.get_state()
    before = dict(tk.hamming_top2.launches_by_site)
    res, m = lc.fns.match_for_sim3(eng.ms, kf1, kf2, lc.generator)
    torch.cuda.synchronize()
    after = tk.hamming_top2.launches_by_site
    assert after.get("match_for_sim3", 0) == \
        before.get("match_for_sim3", 0) + 1
    g = torch.Generator(device="cuda")
    g.set_state(state)
    matching.hamming_top2 = tk.hamming_top2_reference
    try:
        res_p, m_p = lc.fns.match_for_sim3(eng.ms, kf1, kf2, g)
    finally:
        matching.hamming_top2 = tk.hamming_top2
    assert torch.equal(m, m_p) and int((m >= 0).sum()) >= 20
    assert torch.equal(res.inliers, res_p.inliers)
    assert torch.equal(res.R12, res_p.R12) and torch.equal(res.t12,
                                                           res_p.t12)


def test_windowed_fallback_launches_the_kernel_and_equals_plain():
    """The windowed engine on the card over a corridor walk with a yaw
    jolt inside a window: the in-window TrackReferenceKeyFrame fallback
    launches the kernel (site ``window/track_ref_kf``), and each of its
    matching calls, replayed on the live input with the plain version,
    gives the same matches and distances."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, STEREO, SlamConfig)
    from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                       width=640, height=480, fps=10.0, th_depth=60.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=600),
                     capacity=CapacityConfig(max_keyframes=16,
                                             max_map_points=4096,
                                             local_ba_keyframes=8,
                                             local_ba_points=1024),
                     sensor=STEREO)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(20, step=0.25)
    c, s = np.cos(0.12), np.sin(0.12)
    poses[13] = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                          [0, 0, 0, 1]], poses[13].dtype) @ poses[13]
    eng = WindowedSlamEngine(cfg, enable_loop_closing=False)
    assert eng.device.type == "cuda"
    match = matching.match_descriptors
    recorded = []

    def recording(*args, **kwargs):
        out = match(*args, **kwargs)
        if tk._site.name == "window/track_ref_kf":
            recorded.append((args, kwargs, out))
        return out

    tk.reset_launch_counts()
    matching.match_descriptors = recording
    try:
        for i, T in enumerate(poses):
            eng.track_stereo(*synthetic.render_world_stereo(
                world, cam, T, rng, 1.0), 0.1 * i)
        eng.flush()
        torch.cuda.synchronize()
    finally:
        matching.match_descriptors = match
    assert tk.hamming_top2.launches_by_site.get("window/track_ref_kf", 0) \
        >= 1, tk.hamming_top2.launches_by_site
    assert recorded
    matching.hamming_top2 = tk.hamming_top2_reference
    try:
        for args, kwargs, (m, d) in recorded:
            m_p, d_p = match(*args, **kwargs)
            assert torch.equal(m, m_p) and torch.equal(d, d_p)
    finally:
        matching.hamming_top2 = tk.hamming_top2
    assert all(p is not None for p in eng.frame_poses())


def _rgbd_engine(n_frames=10, **kw):
    """A port RGB-D engine on the card over the corridor at 0.4 m a frame
    (600 features, 16 keyframes); returns (engine, world, poses, cam)."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, RGBD, SlamConfig)
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                       width=640, height=480, fps=10.0, th_depth=60.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=600),
                     capacity=CapacityConfig(max_keyframes=16,
                                             max_map_points=4096,
                                             local_ba_keyframes=8,
                                             local_ba_points=1024),
                     sensor=RGBD)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(n_frames, step=0.4)
    eng = SlamEngine(cfg, **kw)           # no device: the card by default
    assert eng.device.type == "cuda"
    for i, T in enumerate(poses):
        g, d = synthetic.render_world(world, cam, T, rng, 1.0,
                                      with_depth=True)
        assert eng.track_rgbd(np.clip(g, 0, 255).astype(np.uint8), d,
                              0.1 * i) is not None, i
    return eng, world, poses, cam


def test_rgbd_track_ref_kf_launches_the_kernel_and_equals_plain():
    """TrackReferenceKeyFrame on an RGB-D map built on the card: one
    launch attributed to track_ref_kf, and the same associations and
    pose as the plain version."""
    eng, _, _, _ = _rgbd_engine(enable_loop_closing=False)
    Tcw = torch.as_tensor(eng.last_Tcw, device="cuda")
    before = tk.hamming_top2.launches_by_site.get("track_ref_kf", 0)
    res = eng.fns.track_ref_kf(eng.ms, eng.last_fd, eng.ref_kf, Tcw)
    torch.cuda.synchronize()
    assert tk.hamming_top2.launches_by_site.get("track_ref_kf", 0) == \
        before + 1
    matching.hamming_top2 = tk.hamming_top2_reference
    try:
        res_p = eng.fns.track_ref_kf(eng.ms, eng.last_fd, eng.ref_kf, Tcw)
    finally:
        matching.hamming_top2 = tk.hamming_top2
    assert torch.equal(res.assoc, res_p.assoc)
    assert torch.equal(res.Tcw, res_p.Tcw)
    assert int((res.assoc >= 0).sum()) >= 50


def test_localization_reloc_attempt_equals_plain():
    """In localization mode a LOST RGB-D engine on the card relocalizes
    from a re-rendered early frame (launches attributed to
    reloc_attempt, the map unchanged); the attempt that succeeded, run
    again with the kernel and with the plain version from its generator
    state, gives the same pose, inliers and associations."""
    from orbslam2_tpu_torch.utils import synthetic

    eng, world, poses, cam = _rgbd_engine()
    eng.localization_only = True
    lc = eng.loop_closer
    attempt, calls = lc.fns.reloc_attempt, []

    def recorded(*args):
        calls.append((args, args[-1].get_state()))
        return attempt(*args)

    lc.fns = lc.fns._replace(reloc_attempt=recorded)
    g, d = synthetic.render_world(world, cam, poses[2],
                                  np.random.default_rng(7), 1.0,
                                  with_depth=True)
    eng.state = 3                                        # LOST
    kfs = eng.n_kfs
    before = tk.hamming_top2.launches_by_site.get("reloc_attempt", 0)
    Tcw = eng.track_rgbd(np.clip(g, 0, 255).astype(np.uint8), d, 9.0)
    torch.cuda.synchronize()
    lc.fns = lc.fns._replace(reloc_attempt=attempt)
    assert Tcw is not None and eng.n_kfs == kfs
    assert tk.hamming_top2.launches_by_site.get("reloc_attempt", 0) > before
    args, state = calls[-1]
    outs = []
    for top2 in (tk.hamming_top2, tk.hamming_top2_reference):
        gen = torch.Generator(device="cuda")
        gen.set_state(state)
        matching.hamming_top2 = top2
        try:
            outs.append(attempt(*args[:-1], gen))
            torch.cuda.synchronize()
        finally:
            matching.hamming_top2 = tk.hamming_top2
    (T1, n1, a1), (T2, n2, a2) = outs
    assert torch.equal(T1, T2) and int(n1) == int(n2) >= 50
    assert torch.equal(a1, a2)


def test_cg_on_the_card_matches_dense_on_the_card():
    """One robust GBA chunk's LM (5 iterations) on a perturbed map of 264
    keyframe slots, built on the card, through both solvers there: poses
    within 1e-4, points nearer than 20 m within 1e-3 m, all within 2e-2
    of their range (far stereo depth is barely observed)."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, STEREO, SlamConfig)
    from orbslam2_tpu_torch.models import map_state as M
    from orbslam2_tpu_torch.ops import bundle
    from orbslam2_tpu_torch.runtime import gba
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import camera as cam_mod
    from orbslam2_tpu_torch.utils import lie, synthetic

    cam = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                       width=320, height=240, fps=10.0, th_depth=60.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=200),
                     capacity=CapacityConfig(max_keyframes=264,
                                             max_map_points=2048,
                                             local_ba_keyframes=4,
                                             local_ba_points=512),
                     sensor=STEREO)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    eng = SlamEngine(cfg, enable_loop_closing=False)
    for i, T in enumerate(synthetic.straight_trajectory(8, step=0.3)):
        eng.track_stereo(*synthetic.render_world_stereo(world, cam, T, rng,
                                                        1.0), 0.1 * i)
    ms = eng.ms
    g = torch.Generator(device="cuda").manual_seed(1)
    live = ms.kf_valid.clone()
    live[0] = False
    xi = torch.randn(ms.K, 6, device="cuda", generator=g) * torch.tensor(
        [0.01] * 3 + [0.05] * 3, device="cuda")
    pose = torch.where(live[:, None, None], lie.se3_exp(xi) @ ms.kf_pose,
                       ms.kf_pose)
    pts = ms.mp_pos + 0.05 * torch.randn(ms.mp_pos.shape, device="cuda",
                                         generator=g) * ms.mp_valid[:, None]
    ms = ms._replace(kf_pose=pose, mp_pos=pts)
    prob = gba.full_map_problem(cfg, ms, M.kf_obs_ok(ms))
    c = cam_mod.Camera.from_config(cam)
    out = {s: bundle.bundle_adjust(c, prob, n_free=ms.K, iters_a=5,
                                   iters_b=0, fix_first_free=True, solver=s)
           for s in ("dense", "cg")}
    torch.cuda.synchronize()
    kv, pv = ms.kf_valid, ms.mp_valid
    assert torch.allclose(out["cg"][0][kv], out["dense"][0][kv], atol=1e-4,
                          rtol=0)
    xc, xd = out["cg"][1][pv], out["dense"][1][pv]
    gap = torch.linalg.norm(xc - xd, dim=1)
    rng_ = torch.linalg.norm(xd, dim=1)
    near = rng_ < 20.0
    assert int(near.sum()) > 100 and float(gap[near].max()) < 1e-3
    assert float((gap / rng_).max()) < 2e-2


def test_segment_sums_do_not_change_from_run_to_run():
    """``index.scatter_add`` on the card: float sums over duplicated
    indices give the same bits on every call (``index_add_`` adds by
    atomics in arrival order), with half the rows masked (as the invalid
    observations of a full-map BA), in float32 against a float64 sum and
    exact in int32."""
    from orbslam2_tpu_torch.utils.index import scatter_add

    g = torch.Generator(device="cuda").manual_seed(0)
    n, m = 1 << 18, 512
    idx = torch.randint(0, m, (n,), device="cuda", generator=g)
    ok = torch.rand(n, device="cuda", generator=g) < 0.5
    vals = torch.randn(n, 6, 3, device="cuda", generator=g)
    zeros = torch.zeros(m, 6, 3, device="cuda")
    runs = [scatter_add(zeros, idx, vals, ok) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    ref = torch.zeros(m, 6, 3, dtype=torch.float64, device="cuda")
    ref.index_add_(0, idx[ok], vals[ok].double())
    assert torch.allclose(runs[0].double(), ref, atol=1e-3, rtol=1e-5)
    ints = torch.randint(-3, 4, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    got = scatter_add(torch.zeros(m, dtype=torch.int32, device="cuda"), idx,
                      ints, ok)
    want = torch.zeros(m, dtype=torch.int32, device="cuda").index_add_(
        0, idx[ok], ints[ok])
    assert torch.equal(got, want)


def _two_view_f_scene(seed=0):
    """Two views of a general 3D scene (tests/test_mono.py's F scene, made
    with numpy): matched pixels with 0.4 px noise and the in-image mask."""
    from orbslam2_tpu_torch.utils import lie

    rng = np.random.default_rng(seed)
    n = 300
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(5, 25, n)], -1)
    R = lie.so3_exp(torch.tensor([0.02, -0.05, 0.01])).numpy()
    t = np.array([0.6, 0.05, 0.1])
    uv1 = pts[:, :2] / pts[:, 2:] * 450 + [320, 240]
    pc2 = pts @ R.T + t
    uv2 = pc2[:, :2] / pc2[:, 2:] * 450 + [320, 240]
    uv1 = uv1 + rng.normal(0, 0.4, uv1.shape)
    uv2 = uv2 + rng.normal(0, 0.4, uv2.shape)
    inb = ((uv2[:, 0] > 0) & (uv2[:, 0] < 640)
           & (uv2[:, 1] > 0) & (uv2[:, 1] < 480))
    idx = rng.choice(np.flatnonzero(inb), (200, 8))
    return (torch.from_numpy(uv1.astype(np.float32)),
            torch.from_numpy(uv2.astype(np.float32)),
            torch.from_numpy(inb), torch.from_numpy(idx))


def test_initialize_mono_on_the_card_matches_the_cpu():
    """The H/F initializer on the card (cuSOLVER's batched SVD and eigh)
    against the port on the CPU (LAPACK) with the same draws: the same
    decision and model, Tcw2 within 5e-4, the good mask ≥ 99% equal."""
    from orbslam2_tpu_torch.config import CameraConfig
    from orbslam2_tpu_torch.ops import initializer
    from orbslam2_tpu_torch.utils import camera as cam_mod

    cam = cam_mod.Camera.from_config(CameraConfig(
        fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480))
    p1, p2, valid, idx = _two_view_f_scene()
    cpu = initializer.initialize_mono(cam, p1, p2, valid, idx=idx)
    gpu = initializer.initialize_mono(cam, p1.cuda(), p2.cuda(),
                                      valid.cuda(), idx=idx.cuda())
    torch.cuda.synchronize()
    assert bool(cpu.ok) and bool(gpu.ok)
    assert bool(cpu.used_h) == bool(gpu.used_h) is False
    assert torch.allclose(gpu.Tcw2.cpu(), cpu.Tcw2, atol=5e-4, rtol=0)
    assert (gpu.good.cpu() == cpu.good).float().mean() >= 0.99


def test_mono_track_ref_kf_launches_the_kernel_and_equals_plain():
    """TrackReferenceKeyFrame on a mono map bootstrapped on the card
    (bench.py's mono walk, 1000 features): one launch attributed to
    track_ref_kf, and the same associations and pose as the plain
    version."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           MONOCULAR, OrbConfig, SlamConfig)
    from orbslam2_tpu_torch.runtime.slam import SlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                       height=480, fps=10.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000),
                     capacity=CapacityConfig(max_keyframes=16,
                                             max_map_points=4096,
                                             local_ba_keyframes=8,
                                             local_ba_points=1024),
                     sensor=MONOCULAR)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    eng = SlamEngine(cfg, enable_loop_closing=False)
    for i in range(5):
        T = synthetic.look_ahead_pose(np.array([0.18 * i, 0.0, 0.04 * i]))
        g = synthetic.render_world(world, cam, T, rng, noise=1.0)
        eng.track_monocular(np.clip(g, 0, 255).astype(np.uint8), 0.1 * i)
    assert eng.state == 2 and eng.last_fd is not None, eng.stats
    Tcw = torch.as_tensor(eng.last_Tcw, device="cuda")
    before = tk.hamming_top2.launches_by_site.get("track_ref_kf", 0)
    res = eng.fns.track_ref_kf(eng.ms, eng.last_fd, eng.ref_kf, Tcw)
    torch.cuda.synchronize()
    assert tk.hamming_top2.launches_by_site.get("track_ref_kf", 0) == \
        before + 1
    matching.hamming_top2 = tk.hamming_top2_reference
    try:
        res_p = eng.fns.track_ref_kf(eng.ms, eng.last_fd, eng.ref_kf, Tcw)
    finally:
        matching.hamming_top2 = tk.hamming_top2
    assert torch.equal(res.assoc, res_p.assoc)
    assert torch.equal(res.Tcw, res_p.Tcw)
    assert int((res.assoc >= 0).sum()) >= 50


def test_system_load_map_relocalizes_with_the_kernel_and_equals_plain(
        tmp_path):
    """A stereo System on the card (no device given) saves its map; a
    fresh System with ``map_file`` set starts LOST in localization mode,
    and its first frame relocalizes within 0.1 m, launching hamming_top2
    from reloc_attempt.  That attempt, run again with the kernel and with
    the plain version from its generator state, gives the same pose,
    inliers and associations."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, STEREO, SlamConfig)
    from orbslam2_tpu_torch.runtime.system import System
    from orbslam2_tpu_torch.utils import synthetic

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                       width=640, height=480, fps=10.0, th_depth=60.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=400),
                     capacity=CapacityConfig(max_keyframes=16,
                                             max_map_points=4096,
                                             local_ba_keyframes=4,
                                             local_ba_points=1024),
                     sensor=STEREO)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(8, step=0.3)
    sys1 = System(None, None, STEREO, config=cfg)
    assert sys1.device.type == "cuda"
    for i, T in enumerate(poses):
        sys1.track_stereo(*synthetic.render_world_stereo(world, cam, T, rng,
                                                         1.0), 0.1 * i)
    path = str(tmp_path / "map.npz")
    sys1.save_map(path)
    sys2 = System(None, None, STEREO, config=cfg.replace(map_file=path))
    eng = sys2.engine
    assert eng.localization_only and sys2.get_tracking_state() == 3
    assert eng.ms.kf_desc.is_cuda and eng.loop_closer.db.bow.is_cuda
    lc = eng.loop_closer
    attempt, calls = lc.fns.reloc_attempt, []

    def recorded(*args):
        calls.append((args, args[-1].get_state()))
        return attempt(*args)

    lc.fns = lc.fns._replace(reloc_attempt=recorded)
    T_back = poses[3]
    before = tk.hamming_top2.launches_by_site.get("reloc_attempt", 0)
    try:
        Tcw = sys2.track_stereo(*synthetic.render_world_stereo(
            world, cam, T_back, np.random.default_rng(7), 1.0), 50.0)
        torch.cuda.synchronize()
    finally:
        lc.fns = lc.fns._replace(reloc_attempt=attempt)
    assert Tcw is not None
    assert np.linalg.norm(-Tcw[:3, :3].T @ Tcw[:3, 3]
                          + T_back[:3, :3].T @ T_back[:3, 3]) < 0.1
    assert tk.hamming_top2.launches_by_site.get("reloc_attempt", 0) > before
    args, state = calls[-1]
    outs = []
    for top2 in (tk.hamming_top2, tk.hamming_top2_reference):
        gen = torch.Generator(device="cuda")
        gen.set_state(state)
        matching.hamming_top2 = top2
        try:
            outs.append(attempt(*args[:-1], gen))
            torch.cuda.synchronize()
        finally:
            matching.hamming_top2 = tk.hamming_top2
    (T1, n1, a1), (T2, n2, a2) = outs
    assert torch.equal(T1, T2) and int(n1) == int(n2) >= 50
    assert torch.equal(a1, a2)


def _drain(eng, timeout=120.0):
    import time
    t_end = time.monotonic() + timeout
    while eng._jobs or eng._worker_busy:
        assert time.monotonic() < t_end, "the worker did not drain"
        time.sleep(0.002)


def test_async_engine_on_the_card_matches_the_cpu():
    """AsyncSlamEngine drained after every frame, on the card (the worker
    on its own stream, with a yaw jolt that sends tracking through
    ``track_ref_kf``) and on the CPU: the same keyframes, camera centres
    within 0.01 m (tests/test_torch_pipeline.py's tolerance against
    JAX)."""
    from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                           OrbConfig, STEREO, SlamConfig)
    from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine
    from orbslam2_tpu_torch.utils import synthetic

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                       width=640, height=480, fps=10.0, th_depth=60.0)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=600),
                     capacity=CapacityConfig(max_keyframes=16,
                                             max_map_points=4096,
                                             local_ba_keyframes=8,
                                             local_ba_points=1024),
                     sensor=STEREO)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(16, step=0.25)
    c, s = np.cos(0.12), np.sin(0.12)
    poses[10] = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                          [0, 0, 0, 1]], poses[10].dtype) @ poses[10]
    frames = [synthetic.render_world_stereo(world, cam, T, rng, 1.0)
              for T in poses]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = AsyncSlamEngine(cfg, enable_loop_closing=False,
                              device=None if dev == "cuda" else "cpu")
        assert eng.device.type == dev and (eng._stream is not None) == (
            dev == "cuda")
        eng.start()
        for i, (left, right) in enumerate(frames):
            assert eng.track_stereo(left, right, 0.1 * i) is not None, i
            _drain(eng)
        eng.shutdown()
        out[dev] = (eng.stats["kf_inserted"], eng.ms.kf_valid.cpu(),
                    eng.frame_poses())
    (nk_g, kv_g, p_g), (nk_c, kv_c, p_c) = out["cuda"], out["cpu"]
    assert nk_g == nk_c >= 3 and torch.equal(kv_g, kv_c)
    for Tg, Tc in zip(p_g, p_c):
        cg = -Tg[:3, :3].T @ Tg[:3, 3]
        cc = -Tc[:3, :3].T @ Tc[:3, 3]
        assert np.linalg.norm(cg - cc) < 0.01


def test_launch_counts_from_two_threads_on_two_streams():
    """Two threads launch the kernel at once, each on its own stream and
    under its own site: every launch is counted (the counters' lock), and
    every result equals the plain version."""
    import sys
    import threading

    args = _inputs(1024, 1024, seed=5)
    ref = tk.hamming_top2_reference(*args)
    torch.cuda.synchronize()        # the inputs, before two streams read
    n = 400
    results = {}

    def run(name):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream), tk.launch_site(name):
            outs = [tk.hamming_top2(*args) for _ in range(n)]
        stream.synchronize()
        results[name] = all(torch.equal(g, r) for o in outs
                            for g, r in zip(o, ref))

    tk.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(name,))
                   for name in ("tracking", "mapping")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == {"tracking": True, "mapping": True}
    assert tk.hamming_top2.launches == 2 * n
    assert tk.hamming_top2.launches_by_site == {"tracking": n, "mapping": n}


def test_kitti_driver_launches_the_kernel_on_the_card(tmp_path):
    """tools.replay.run_kitti_stereo with no device, over 12 corridor
    frames written as a KITTI layout with a yaw jolt at frame 8: the
    System is on the card, every frame tracked, and TrackReferenceKeyFrame
    launched hamming_top2."""
    from orbslam2_tpu_torch.config import CameraConfig
    from orbslam2_tpu_torch.tools import replay
    from orbslam2_tpu_torch.utils import png, synthetic

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
                       width=640, height=480, fps=10.0, th_depth=60.0)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(12, step=0.25)
    c, s = np.cos(0.12), np.sin(0.12)
    poses[8] = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                         [0, 0, 0, 1]], poses[0].dtype) @ poses[8]
    for sub in ("image_0", "image_1"):
        (tmp_path / sub).mkdir()
    for i, T in enumerate(poses):
        for sub, img in zip(("image_0", "image_1"),
                            synthetic.render_world_stereo(world, cam, T, rng,
                                                          1.0)):
            png.write_png(str(tmp_path / sub / f"{i:06d}.png"),
                          np.clip(img, 0, 255).astype(np.uint8))
    (tmp_path / "times.txt").write_text("".join(f"{0.1 * i:e}\n"
                                                for i in range(12)))
    (tmp_path / "s.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 450.0\nCamera.fy: 450.0\nCamera.cx: 320.0\n"
        "Camera.cy: 240.0\nCamera.bf: 150.0\nCamera.fps: 10.0\n"
        "Camera.width: 640\nCamera.height: 480\nThDepth: 60.0\n"
        "ORBextractor.nFeatures: 1000\n")
    tk.reset_launch_counts()
    rep = replay.run_kitti_stereo(str(tmp_path), str(tmp_path / "s.yaml"),
                                  str(tmp_path / "t.txt"))
    assert rep.n_tracked == rep.n_frames == 12
    assert tk.hamming_top2.launches_by_site.get("track_ref_kf", 0) >= 1


def test_detect_plane_on_the_card_matches_the_cpu():
    """The AR RANSAC on the card against the CPU, on the same hypotheses:
    the normal equal up to sign, d and the origin within 1e-4."""
    from orbslam2_tpu_torch.utils import ar

    rng = np.random.default_rng(0)
    on = np.stack([rng.uniform(-5, 5, 200),
                   np.full(200, 2.0) + rng.normal(0, 0.005, 200),
                   rng.uniform(5, 25, 200)], -1)
    off = np.stack([rng.uniform(-5, 5, 60), rng.uniform(-3, 1.5, 60),
                    rng.uniform(5, 25, 60)], -1)
    pts = torch.from_numpy(np.concatenate([on, off]).astype(np.float32))
    valid = torch.ones(260, dtype=torch.bool)
    n_obs = torch.full((260,), 8, dtype=torch.int32)
    idx = ar.draw_hypotheses(valid, 64, torch.Generator().manual_seed(3))
    f_cpu = ar.detect_plane(pts, valid, n_obs, idx=idx)
    f_gpu = ar.detect_plane(pts.cuda(), valid.cuda(), n_obs.cuda(),
                            idx=idx.cuda())
    assert bool(f_gpu.ok) and bool(f_cpu.ok)
    sign = float(torch.sign(torch.dot(f_gpu.n.cpu(), f_cpu.n)))
    assert torch.allclose(sign * f_gpu.n.cpu(), f_cpu.n, atol=1e-4)
    assert abs(sign * float(f_gpu.d) - float(f_cpu.d)) < 1e-4
    assert torch.allclose(f_gpu.origin.cpu(), f_cpu.origin, atol=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    assert bool(ar.detect_plane(pts.cuda(), valid.cuda(), n_obs.cuda(),
                                gen).ok)


def test_vocabulary_build_on_the_card_matches_the_cpu(monkeypatch):
    """build_vocabulary on the card (every assignment a kernel launch,
    site vocab_build) against the CPU build (the plain version), bit for
    bit: centroids of every level and idf.  Clustered rows (40 prototypes,
    repeated) leave clusters empty, so the re-seed's extra assignments run
    on the card too."""
    from orbslam2_tpu_torch.models import vocabulary as voc

    rng = np.random.default_rng(5)
    protos = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    desc = np.concatenate([protos[rng.integers(0, 40, 4000)],
                           rng.integers(0, 2 ** 32, (2000, 8),
                                        dtype=np.uint32)])
    words = torch.from_numpy(desc.view(np.int32))
    nodes = []
    kmajority = voc._kmajority
    monkeypatch.setattr(voc, "_kmajority", lambda bits, k, rng: (
        nodes.append(bits.shape[0]) or kmajority(bits, k, rng)))
    tk.reset_launch_counts()
    card = voc.build_vocabulary(words, k=5, levels=3, seed=1, device="cuda")
    torch.cuda.synchronize()
    launched = dict(tk.hamming_top2.launches_by_site)
    cpu = voc.build_vocabulary(words, k=5, levels=3, seed=1, device="cpu")
    for a, b in zip(card.centroids, cpu.centroids):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    assert torch.equal(card.idf.cpu(), cpu.idf)
    # 7 assignments a node with rows, and more where a cluster fell empty
    assert set(launched) == {"vocab_build"}
    assert launched["vocab_build"] > 7 * sum(m > 0 for m in nodes[:31])


def test_mesh_of_four_shards_on_the_card_matches_the_cpu():
    """parallel/*: the scaling problem through distributed_bundle_adjust
    on 4 shards of cuda:0 (each on its own stream) and on 4 CPU shards:
    poses within 5e-4 (tests/test_dist_ba.py's sharded-against-single
    bar), the card's shards bit-equal to each other; a sharded DB's
    scores on the card within 1e-6 of the dense product."""
    from orbslam2_tpu_torch.config import CameraConfig
    from orbslam2_tpu_torch.models.keyframe_db import KeyFrameDB
    from orbslam2_tpu_torch.parallel import db_shard, dist_ba
    from orbslam2_tpu_torch.parallel import mesh as mesh_mod
    from orbslam2_tpu_torch.tools import scaling
    from orbslam2_tpu_torch.utils import camera as cam_mod

    cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0)
    cam = cam_mod.Camera.from_config(cfg)
    card = mesh_mod.make_mesh(["cuda:0"] * 4)
    outs = dist_ba.shard_bundle_adjust(
        card, cam, scaling._problem(cfg, 16, 128, 1024, device="cuda"),
        n_free=16, fix_first_free=True)
    cpu = dist_ba.distributed_bundle_adjust(
        mesh_mod.make_mesh(["cpu"] * 4), cam,
        scaling._problem(cfg, 16, 128, 1024), n_free=16,
        fix_first_free=True)[0]
    assert all(torch.equal(o[0], outs[0][0]) for o in outs[1:])
    assert float((outs[0][0].cpu() - cpu).abs().max()) < 5e-4
    rng = np.random.default_rng(0)
    bow = rng.random((20, 256)).astype(np.float32)
    bow /= np.linalg.norm(bow, axis=1, keepdims=True)
    q = torch.from_numpy(bow[3]).cuda()
    db = db_shard.shard_db(card, KeyFrameDB(
        bow=torch.from_numpy(bow).cuda(),
        valid=torch.ones(20, dtype=torch.bool, device="cuda")))
    np.testing.assert_allclose(db.scores(q).cpu().numpy(), bow @ bow[3],
                               atol=1e-6)


def test_loop_closer_on_the_card_reads_a_db_sharded_elsewhere():
    """A loop closer on cuda:0 whose mesh lies on other devices (4 CPU
    shards): the sharded DB's scores and validity come back to the
    closer's card, and detect_step and the relocalization query equal
    the dense closer's on the card (vectors and scores within 1e-6)."""
    from orbslam2_tpu_torch import config as tconfig
    from orbslam2_tpu_torch.convert import map_state_from_numpy, to_numpy
    from orbslam2_tpu_torch.models import map_state as TM
    from orbslam2_tpu_torch.models import vocabulary as tvoc
    from orbslam2_tpu_torch.parallel import mesh as mesh_mod
    from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser

    cfg = tconfig.SlamConfig(
        camera=tconfig.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                                    bf=150.0, width=640, height=480,
                                    fps=10.0, th_depth=60.0),
        orb=tconfig.OrbConfig(n_features=64),
        capacity=tconfig.CapacityConfig(max_keyframes=16,
                                        max_map_points=1 << 10,
                                        local_ba_keyframes=4,
                                        local_ba_points=256),
        sensor=tconfig.STEREO)
    rng = np.random.default_rng(0)
    d = to_numpy(TM.empty_map(cfg))
    K, N = cfg.capacity.max_keyframes, cfg.orb.n_features_padded
    d["kf_desc"] = rng.integers(0, 2 ** 32, size=(K, N, 8), dtype=np.uint32)
    d["kf_kp_valid"][:8] = rng.random((8, N)) < 0.9
    d["kf_valid"][:8] = True
    d["kf_mp"][:4, :40] = np.arange(40)
    d["mp_valid"][:40] = True
    ms = map_state_from_numpy(d, device="cuda:0")
    voc = tvoc.default_vocabulary(k=10, levels=4, device="cuda:0")
    lc = LoopCloser(cfg, voc, device="cuda:0",
                    mesh=mesh_mod.make_mesh(["cpu"] * 4))
    dense = LoopCloser(cfg, voc, device="cuda:0")
    for k in range(6):
        lc.db, vec, info = lc.fns.detect_step(ms, lc.db, k)
        dense.db, dvec, dinfo = dense.fns.detect_step(ms, dense.db, k)
        assert torch.equal(info, dinfo)
        assert float((vec - dvec).abs().max()) <= 1e-6
    assert lc.db.valid.device == lc.db.scores(vec).device == ms.kf_pose.device
    q = dense.fns.kf_bow_vector(ms, 2)
    c1, s1 = lc.fns.detect(ms, lc.db, -1, q, 0.0)
    c2, s2 = dense.fns.detect(ms, dense.db, -1, q, 0.0)
    assert torch.equal(c1, c2)
    assert float((s1 - s2).abs().max()) <= 1e-6


def test_int32_hamming_on_the_card_matches_python_and_int64():
    """tests/test_torch_hamming.py's checks of the int32 popcount and the
    distance functions, on the card: Python's bit count on the edge words
    and a random sample; the former int64 formula on random rows and rows
    of every edge word, past JAX's matrix-unit threshold too."""
    rng = np.random.default_rng(6)
    hc.check_popcount(hc.EDGE_WORDS, "cuda")
    hc.check_popcount([hc.as_int32(int(w)) for w in
                       rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)],
                      "cuda")
    for N, M in [(0, 5), (37, 53), (1000, 1100), (8192, 1024)]:
        a, b = hc.descriptor_rows(rng, N), hc.descriptor_rows(rng, M)
        av, bv = rng.random(len(a)) < 0.9, rng.random(len(b)) < 0.9
        hc.check_hamming(a, av, b, bv, "cuda")


def test_hamming_matrices_make_no_host_sync_on_the_card():
    """The distance matrices run on the card with no host sync: under
    ``set_sync_debug_mode("error")`` a sync raises, as the blocking copy
    of a Python scalar to the card shows first."""
    from orbslam2_tpu_torch.ops import hamming

    rng = np.random.default_rng(7)
    a = torch.from_numpy(hc.descriptor_rows(rng, 1000)).cuda()
    b = torch.from_numpy(hc.descriptor_rows(rng, 1024)).cuda()
    av = torch.ones(len(a), dtype=torch.bool, device="cuda")
    bv = torch.ones(len(b), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchronizing"):
            torch.tensor(128.0, device="cuda")
        hamming.hamming_matrix(a, b)
        hamming.masked_hamming_matrix(a, av, b, bv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
