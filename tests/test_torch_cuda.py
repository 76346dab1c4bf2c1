"""The hand-written Hopper kernel against its plain PyTorch version, on
the card.  Skipped where torch has no CUDA device; ``python3
chip_smoke.py`` runs the same comparisons at the main path's shapes.

Tolerance: bit-exact (integer outputs)."""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.ops import hamming_top2 as tk
from orbslam2_tpu_torch.ops import matching

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
