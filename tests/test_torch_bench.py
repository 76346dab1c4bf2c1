"""The bench legs of the port (``orbslam2_tpu_torch/tools/bench.py``)
against ``bench.py`` and the JAX package, on the CPU.

  * Frames: ``bench_frames`` gives bench.py's sequence bit for bit (one
    ``default_rng(0)``: the world, 172 stereo, 124 mono, then 60 RGB-D
    frames, drawn with ``orbslam2_tpu.utils.synthetic``), in full and as
    prefixes of each walk (``chip_smoke.py``'s 80 stereo, no mono, 40
    RGB-D), at a 64×48 camera (the draws do not depend on the image
    content).
  * The stereo SLAM leg at 320×240, 300 features, 32 keyframes, 4096
    points (8 warm-up frames, 3 passes of 4) against the same loop on the
    JAX ``WindowedSlamEngine`` (warm-up, passes, ``flush()``), the port
    handed JAX's frontend (tests/jax_angles.py) and JAX's ``_mapper_idle``
    patched to True (the port's is on the CPU): the same keyframe
    decisions frame by frame through the warm-up and two passes, at most
    one frame otherwise over the leg (keyframes within ±1, as
    tests/test_torch_windowed.py's engines; the test says where the float
    maps part); neither loses a frame, and the port's ATE over the leg's
    oracle span is within 0.01 m of JAX's.
  * The LOC leg on that engine: ≥ 30 map inliers every frame.

The JSON line, the oracle, scaling and reference-YAML keys are in
tests/test_torch_bench_line.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxWindowed
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.tools import bench

from jax_angles import hand_over_frontend

torch.set_num_threads(2)

CFG = SlamConfig(
    camera=CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                        width=320, height=240, fps=10.0, th_depth=60.0),
    orb=OrbConfig(n_features=300),
    capacity=CapacityConfig(max_keyframes=32, max_map_points=4096,
                            local_ba_keyframes=8, local_ba_points=1024),
    sensor=STEREO)
DEPTHS = bench.Depths(warmup=8, measure=4, slam_passes=3, loc_windows=1,
                      loc_passes=3, mono_passes=2, rgbd_frames=8,
                      rgbd_warmup=4)


def _jcfg(cfg):
    return jconfig.SlamConfig(
        camera=jconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=jconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
        capacity=jconfig.CapacityConfig(**dataclasses.asdict(cfg.capacity)),
        sensor=cfg.sensor)


# ----------------------------------------------------------------- frames --

def _bench_py_draws(cam):
    """bench.py's draws, sequentially, with the JAX package's renderer:
    the world, 172 stereo, 124 mono and 60 RGB-D frames (the reference
    YAML's leg on ``cam``)."""
    rng = np.random.default_rng(0)
    world = jsyn.make_world(rng)
    stereo = [jsyn.render_world_stereo(world, cam, T, rng, noise=1.0)
              for T in jsyn.straight_trajectory(172, step=0.25)]
    mono = [jsyn.render_world(world, cam, jsyn.look_ahead_pose(
        np.array([0.18 * i, 0.0, 0.04 * i])), rng, noise=1.0)
        for i in range(124)]
    rgbd = [jsyn.render_world(world, cam, T, rng, 1.0, with_depth=True)
            for T in jsyn.straight_trajectory(60, step=0.12)]
    return stereo, mono, rgbd


TINY = CameraConfig(fx=45.0, fy=45.0, cx=32.0, cy=24.0, bf=15.0, width=64,
                    height=48, fps=10.0, th_depth=60.0)


@pytest.mark.parametrize("counts", [None, (80, 0, 40), (3, 5, 60)],
                         ids=["bench.py", "chip_smoke", "prefixes"])
def test_bench_frames_are_bench_py_draws(counts):
    fr = bench.bench_frames(SlamConfig(camera=TINY, sensor=STEREO),
                            counts=counts)
    stereo, mono, rgbd = _bench_py_draws(
        jconfig.CameraConfig(**dataclasses.asdict(TINY)))
    n_s, n_m, n_r = counts or (172, 124, 60)
    assert (len(fr.stereo), len(fr.mono), len(fr.rgbd)) == (n_s, n_m, n_r)
    for got, want in ((fr.stereo, stereo[:n_s]), (fr.mono, mono[:n_m]),
                      (fr.rgbd, rgbd[:n_r])):
        for g, w in zip(got, want):
            for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (g, w))):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.asarray(fr.mono_gt).reshape(-1, 4, 4), np.asarray(
            [jsyn.look_ahead_pose(np.array([0.18 * i, 0.0, 0.04 * i]))
             for i in range(n_m)]).reshape(-1, 4, 4))
    np.testing.assert_array_equal(np.stack(fr.stereo_gt), np.stack(
        jsyn.straight_trajectory(n_s, step=0.25)))


def test_bench_frames_refuse_counts_past_bench_pys_walks():
    with pytest.raises(ValueError, match="past bench.py's walks"):
        bench.bench_frames(SlamConfig(camera=TINY, sensor=STEREO),
                           counts=(173, 0, 0))


# ------------------------------------------------------- the stereo legs --

@pytest.fixture(scope="module")
def frames():
    n = DEPTHS.lengths()[0]
    return bench.bench_frames(CFG, DEPTHS, counts=(n, 0, 0))


def _recording(decide, log):
    """``_need_new_keyframe`` that appends (frame id, decision) to
    ``log``."""
    def need(eng, sm, ref_override=None):
        out = decide(eng, sm, ref_override)
        log.append((eng.frame_id, bool(out)))
        return out
    return need


@pytest.fixture(scope="module")
def jax_slam(frames):
    """bench.py's SLAM loop (bench.py:102-121, no prewarm) on the JAX
    windowed engine at DEPTHS, with its keyframe decisions."""
    eng = JaxWindowed(_jcfg(CFG), enable_loop_closing=True, window=4)
    eng._mapper_idle = lambda: True
    decisions = []
    need = _recording(type(eng)._need_new_keyframe, decisions)
    eng._need_new_keyframe = lambda sm, ref_override=None: need(
        eng, sm, ref_override)
    u8 = [(left.astype(np.uint8), right.astype(np.uint8))
          for left, right in frames.stereo]
    for i in range(DEPTHS.warmup):
        eng.track_stereo(*u8[i], timestamp=0.1 * i)
    kf_counts, start = [], DEPTHS.warmup
    for _ in range(DEPTHS.slam_passes):
        kf0 = eng.stats["kf_inserted"]
        for i in range(start, start + DEPTHS.measure):
            eng.track_stereo(*u8[i], timestamp=0.1 * i)
        eng.flush()
        kf_counts.append(eng.stats["kf_inserted"] - kf0)
        start += DEPTHS.measure
    return eng, kf_counts, decisions


@pytest.fixture(scope="module")
def port_slam(frames, jax_slam):
    decisions = []
    with pytest.MonkeyPatch.context() as mp:
        hand_over_frontend(mp, jax_engine=jax_slam[0])
        mp.setattr(WindowedSlamEngine, "_need_new_keyframe", _recording(
            WindowedSlamEngine._need_new_keyframe, decisions))
        res = bench.slam_leg(CFG, frames.stereo, frames.stereo_gt, DEPTHS,
                             device="cpu", log=lambda s: None)
    return res, decisions


def test_slam_leg_inserts_the_keyframes_of_jax_engine(frames, jax_slam,
                                                      port_slam):
    """The same keyframe decisions frame by frame through the warm-up and
    the first two passes (frames 0-15); over the whole leg at most one
    frame decides otherwise.  From frame 9, after the warm-up's six
    mapping steps, the two maps' float sums (triangulation, local BA;
    ROADMAP Queue 3) part by one map inlier a frame, and on frame 19 the
    0.75 reference ratio sits between them: 156 inliers against 208
    reference points in JAX (156.0: no keyframe), 209 in the port
    (156.75: a keyframe)."""
    jeng, j_counts, j_dec = jax_slam
    port, t_dec = port_slam
    n = DEPTHS.lengths()[0]
    n_o = DEPTHS.oracle_frames()
    j_est = jeng.frame_poses()
    assert port["frames"] == len(j_est) == n
    assert port["n_lost"] == 0
    assert all(T is not None for T in j_est)
    last_equal = DEPTHS.warmup + 2 * DEPTHS.measure
    assert ([d for d in t_dec if d[0] < last_equal]
            == [d for d in j_dec if d[0] < last_equal])
    assert len(set(t_dec) ^ set(j_dec)) <= 2, (t_dec, j_dec)
    assert port["kf_counts"][:2] == j_counts[:2], (port["kf_counts"],
                                                   j_counts)
    assert abs(port["engine"].stats["kf_inserted"]
               - jeng.stats["kf_inserted"]) <= 1
    j_ate = bench.ate(j_est[:n_o], frames.stereo_gt[:n_o])
    assert abs(port["ate_m"] - j_ate) < 0.01, (port["ate_m"], j_ate)
    assert port["ate_m"] < bench.CV2_PROXY_ATE
    assert len(port["pass_fps"]) == DEPTHS.slam_passes
    assert port["kf_per_frame"] == pytest.approx(
        float(np.median(port["kf_counts"])) / DEPTHS.measure)


def test_loc_leg_tracks_30_map_inliers_a_frame(frames, port_slam):
    loc = bench.loc_leg(port_slam[0]["engine"], frames.stereo,
                        frames.stereo_gt, DEPTHS, log=lambda s: None)
    assert len(loc["inliers"]) == bench.WINDOW
    assert min(loc["inliers"]) >= 30, loc["inliers"]
    assert loc["fewest_inliers"] >= 30
    assert len(loc["pass_fps"]) == DEPTHS.loc_passes
    assert loc["ate_m"] < bench.CV2_PROXY_ATE


def test_stereo_steps_leave_the_engine_as_it_was(frames, port_slam):
    """The device-time payload (``WindowedSlamEngine.stereo_steps``): a
    window, a mapping step into a free slot and a detection step, each
    from the live state, none adopted: the map, the DB and the slots are
    the same objects with the same values after all three."""
    eng = port_slam[0]["engine"]
    ms, db = eng.ms, eng.loop_closer.db
    before = [t.clone() for t in (*ms, *db)]
    free = set(eng._free_kf_slots)
    window, mapping, detect = eng.stereo_steps(*frames.stereo[10])
    out = window()
    assert out.Tcws.shape == (eng.window, 4, 4)
    ms2, stats = mapping()
    assert bool(ms2.kf_valid[min(free)]) and not bool(ms.kf_valid[min(free)])
    db2, _, cand_info = detect()
    assert cand_info.shape[0] > 0 and bool(db2.valid[eng.ref_kf])
    assert eng.ms is ms and eng.loop_closer.db is db
    assert eng._free_kf_slots == free
    for a, b in zip(before, (*ms, *db)):
        assert torch.equal(a, b)
