"""The bench's mono leg (``orbslam2_tpu_torch/tools/bench.py``'s
``mono_leg``) against the same loop on the JAX ``WindowedSlamEngine``, on
bench.py's own mono frames (drawn after its 172 stereo frames), on the
CPU at tests/test_torch_bench.py's 320×240 camera and capacity (32
keyframes, 4096 points; 8 warm-up frames, two passes of 4) with 1000
features: at 300 the bootstrap finds under 100 matches a frame pair.

The port takes JAX's frontend (tests/jax_angles.py) and JAX's mono
bootstrap draws (tests/test_torch_mono.py's ``JaxDraws``); JAX's
``_mapper_idle`` is patched to True (the port's is on the CPU).  Both
engines initialize on the same frame, track and lose the same frames
(trajectory entries and their lost flags), make the same keyframe
decisions frame by frame, and neither ends LOST.

At the bench's 640×480 the walk is marginal in both packages: which
frame loses track, between frames 70 and 123, follows the RANSAC draws
and float rounding (PERF.md §6; tests/mono_walk_witness.py), so the bench reports the leg's rates null where
its engine ends LOST, and this test holds the leg where the two engines
can be compared frame by frame.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxWindowed
from orbslam2_tpu_torch.config import MONOCULAR, OrbConfig
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.tools import bench

from jax_angles import hand_over_frontend
from test_torch_bench import CFG, DEPTHS, _jcfg, _recording
from test_torch_mono import JaxDraws

torch.set_num_threads(2)

MCFG = CFG.replace(orb=OrbConfig(n_features=1000), sensor=MONOCULAR)


@pytest.fixture(scope="module")
def frames():
    n = DEPTHS.lengths()[1]
    return bench.bench_frames(MCFG, DEPTHS, counts=(0, n, 0))


@pytest.fixture(scope="module")
def jax_mono(frames):
    """bench.py's mono loop (bench.py:211-222, no prewarm) on the JAX
    windowed engine at DEPTHS, with its keyframe decisions."""
    eng = JaxWindowed(_jcfg(MCFG), enable_loop_closing=True, window=4)
    eng._mapper_idle = lambda: True
    decisions = []
    need = _recording(type(eng)._need_new_keyframe, decisions)
    eng._need_new_keyframe = lambda sm, ref_override=None: need(
        eng, sm, ref_override)
    u8 = [f.astype(np.uint8) for f in frames.mono]
    for i in range(DEPTHS.warmup):
        eng.track_monocular(u8[i], timestamp=0.1 * i)
    start = DEPTHS.warmup
    for _ in range(DEPTHS.mono_passes):
        for i in range(start, start + DEPTHS.measure):
            eng.track_monocular(u8[i], timestamp=0.1 * i)
        eng.flush()
        start += DEPTHS.measure
    return eng, decisions


def test_mono_leg_tracks_the_frames_jax_tracks(frames, jax_mono):
    jeng, j_dec = jax_mono
    t_dec = []
    draws = []

    def make_fns(eng):
        draws.append(JaxDraws(eng.fns.mono_build))
        eng.fns = eng.fns._replace(mono_build=draws[-1])

    with pytest.MonkeyPatch.context() as mp:
        hand_over_frontend(mp, jax_engine=jeng)
        mp.setattr(WindowedSlamEngine, "_need_new_keyframe", _recording(
            WindowedSlamEngine._need_new_keyframe, t_dec))
        init = WindowedSlamEngine.__init__

        def init_with_jax_draws(self, *a, **kw):
            init(self, *a, **kw)
            make_fns(self)

        mp.setattr(WindowedSlamEngine, "__init__", init_with_jax_draws)
        res = bench.mono_leg(MCFG, frames.mono, frames.mono_gt, DEPTHS,
                             device="cpu", log=lambda s: None)
    teng = res["engine"]
    assert len(draws) == 1
    j_lost = [e.lost for e in jeng.trajectory]
    t_lost = [e.lost for e in teng.trajectory]
    assert len(t_lost) == len(j_lost) >= DEPTHS.lengths()[1] - 3
    assert t_lost == j_lost, (t_lost, j_lost)
    assert t_dec == j_dec, (t_dec, j_dec)
    assert teng.stats["kf_inserted"] == jeng.stats["kf_inserted"]
    assert teng.state == jeng.state == ttracking.OK
    assert res["state"] == ttracking.OK and res["n_tracked"] == sum(
        not lost for lost in t_lost)
    assert len(res["pass_fps"]) == DEPTHS.mono_passes
    assert res["kf_per_frame"] == (teng.stats["kf_inserted"]
                                   / DEPTHS.lengths()[1])
