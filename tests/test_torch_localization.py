"""Localization mode on the port: ``track_loc_body`` against the JAX
package, and the engines' localization gates.

``track_loc_body`` runs on a map the JAX ``SlamEngine`` built over the
first 10 frames of test_torch_rgbd.py's RGB-D sequence (carried across
with ``convert.py``), tracking frame 10 from the engine's last frame
(its VO points come from that frame's depth).  Integer outputs exact
(associations, inlier mask, visible/found masks, summary counts with
the mbVO datum in slot 39), poses within 1e-4 (float32 pose
optimisation, other summation order).  Three cases: the map as built
(stage 2 kept); the previous frame's depths all tied at 25 m, beyond the
20 m close cutoff, so that which features spawn VO points rests on the
ranking of ties (``jnp.argsort`` is stable; the port's sort must be
too); and the map with 97% of its points invalidated, so that fewer
than 10 real map points match and the frame is in VO mode (the stage-1
pose over VO points kept).

The gates, on port engines over the same sequence with loop closing on:
in localization mode no keyframe is inserted and no map point is made,
by either engine; a LOST engine with ≤ 5 keyframes is not reset;
relocalization from LOST works; and a VO-mode frame tries a
relocalization whose pose replaces the VO pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.runtime import tracking as jtr
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu_torch.convert import (frame_data_from_numpy,
                                        map_state_from_numpy, to_tensor)
from orbslam2_tpu_torch.runtime import tracking as ttr
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchEngine
from orbslam2_tpu_torch.runtime.windowed import \
    WindowedSlamEngine as TorchWindowed
from orbslam2_tpu_torch.utils import synthetic
from test_torch_rgbd import CAM, JCFG, TCFG, sequence  # noqa: F401

torch.set_num_threads(2)

N_MAP = 10          # frames that build the map; the rest are tracked


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def jax_loc_inputs(sequence):  # noqa: F811
    """(JAX map, current frame, previous frame, prev Tcw, predicted Tcw,
    last assoc, last inlier, ref KF) as the JAX engine holds them."""
    _, frames = sequence
    eng = JaxEngine(JCFG, enable_loop_closing=False)
    for i, (g, d) in enumerate(frames[:N_MAP]):
        assert eng.track_rgbd(g, d, 0.1 * i) is not None, i
    g, d = frames[N_MAP]
    fd = eng._decode((g.reshape(-1), d.reshape(-1)))
    return (eng.ms, fd, eng.last_fd, eng.last_Tcw.astype(np.float32),
            eng._predict_pose(), eng.last_assoc, eng.last_inlier,
            int(eng.ref_kf))


@pytest.mark.parametrize("case", ["map", "tied-depths", "vo-mode"])
def test_track_loc_body_matches_jax(jax_loc_inputs, case):
    ms, fd, prev_fd, prev_T, pred_T, assoc, inlier, ref = jax_loc_inputs
    if case == "tied-depths":
        prev_fd = prev_fd._replace(depth=jnp.where(prev_fd.depth > 0, 25.0,
                                                   prev_fd.depth))
    if case == "vo-mode":
        keep = np.random.default_rng(0).random(ms.P) < 0.03
        ms = ms._replace(mp_valid=ms.mp_valid & jnp.asarray(keep))
    jfn = jax.jit(jtr.make_tracking_fns(JCFG).track_loc_body)
    jres = jfn(ms, fd, prev_fd, jnp.asarray(prev_T), jnp.asarray(pred_T),
               assoc, inlier, jnp.int32(ref))
    tfn = ttr.make_tracking_fns(TCFG).track_loc_body
    tres = tfn(map_state_from_numpy(_np(ms)), frame_data_from_numpy(_np(fd)),
               frame_data_from_numpy(_np(prev_fd)), to_tensor(prev_T),
               to_tensor(pred_T), to_tensor(np.asarray(assoc)),
               to_tensor(np.asarray(inlier)), ref)
    jsm, tsm = np.asarray(jres.summary), tres.summary.numpy()
    np.testing.assert_array_equal(tsm[32:40], jsm[32:40])
    vo_mode = jsm[39] < 10
    assert vo_mode == (case == "vo-mode"), jsm[32:40]
    assert jsm[32] > 50, jsm[32:40]            # the union search matched
    for f in ("assoc", "inlier", "visible_mask", "found_mask"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tres.Tcw.numpy(), np.asarray(jres.Tcw),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tsm[:32], jsm[:32], atol=1e-4, rtol=0)


# ----------------------------------------------------------- the gates --

def _map_size(eng):
    return (eng.n_kfs, eng.stats["kf_inserted"],
            int(eng.ms.kf_valid.sum()), int(eng.ms.mp_valid.sum()))


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


@pytest.fixture(scope="module")
def built(sequence):  # noqa: F811
    """A port RGB-D engine (loop closing on) after the map frames."""
    _, frames = sequence
    eng = TorchEngine(TCFG, device="cpu")
    for i, (g, d) in enumerate(frames[:N_MAP]):
        assert eng.track_rgbd(g, d, 0.1 * i) is not None, i
    assert 2 <= eng.n_kfs <= 5, eng.n_kfs
    return eng


def _snapshot(eng):
    """A fresh engine with ``eng``'s tracking state (the fixture's engine
    is shared between tests)."""
    cp = TorchEngine(TCFG, device="cpu")
    keep = ("ms", "state", "n_kfs", "kf_ordinal", "n_live_points",
            "frame_id", "last_kf_frame_id", "ref_kf", "velocity",
            "last_Tcw", "last_assoc", "last_inlier", "last_fd")
    for k in keep:
        setattr(cp, k, getattr(eng, k))
    cp.trajectory = list(eng.trajectory)
    cp.stats = dict(eng.stats)
    cp._free_kf_slots = set(eng._free_kf_slots)
    for kf in np.flatnonzero(eng.ms.kf_valid.numpy()):
        cp.loop_closer.add_keyframe(cp.ms, int(kf))
    return cp


@pytest.mark.parametrize("start", ["vo-path", "no-previous-frame"])
def test_localization_mode_does_not_grow_the_map(built, sequence,  # noqa
                                                 start):
    """Every frame through the VO path; or, with no previous frame (as
    after initialisation), the first through ``track_body`` with a
    keyframe decision that would insert if asked."""
    poses, frames = sequence
    eng = _snapshot(built)
    eng.localization_only = True
    if start == "no-previous-frame":
        eng.last_fd = None
        eng._need_new_keyframe = lambda *a, **k: True
    calls = []
    body = eng.fns.track_loc_body
    eng.fns = eng.fns._replace(
        track_loc_body=lambda *a: calls.append(1) or body(*a))
    before = _map_size(eng)
    for i in range(N_MAP, len(frames)):
        Tcw = eng.track_rgbd(*frames[i], 0.1 * i)
        assert Tcw is not None and eng.state == 2, i
        assert np.linalg.norm(_centre(Tcw) - _centre(poses[i])) < 0.05, i
    n_vo = len(frames) - N_MAP - (start == "no-previous-frame")
    assert len(calls) == n_vo                  # the VO path ran
    assert _map_size(eng) == before


def test_no_auto_reset_while_lost_in_localization_mode(built):
    blank = (np.zeros((CAM.height, CAM.width), np.uint8),
             np.zeros((CAM.height, CAM.width), np.float32))
    for loc in (True, False):
        eng = _snapshot(built)
        eng.localization_only = loc
        eng.state = 3                                  # LOST, ≤ 5 KFs
        before = _map_size(eng)
        assert eng.track_rgbd(*blank, 9.0) is None
        if loc:
            assert eng.state == 3 and "resets" not in eng.stats
            assert _map_size(eng) == before
        else:                                  # SLAM mode resets the map
            assert eng.stats.get("resets") == 1 and eng.n_kfs == 0


def test_relocalization_in_localization_mode(built, sequence):  # noqa
    poses, _ = sequence
    eng = _snapshot(built)
    eng.localization_only = True
    rng = np.random.default_rng(7)
    world = synthetic.make_world(np.random.default_rng(0))
    g, d = synthetic.render_world(world, CAM, poses[2], rng, 1.0,
                                  with_depth=True)
    eng.state = 3
    before = _map_size(eng)
    Tcw = eng.track_rgbd(np.clip(g, 0, 255).astype(np.uint8), d, 9.0)
    assert Tcw is not None and eng.stats["reloc"] == 1
    assert np.linalg.norm(_centre(Tcw) - _centre(poses[2])) < 0.1
    assert _map_size(eng) == before


def test_vo_mode_frame_prefers_relocalization(built, sequence):  # noqa
    """A frame whose summary says VO mode (slot 39 < 10) tries a
    relocalization, and its pose replaces the VO pose."""
    _, frames = sequence
    eng = _snapshot(built)
    eng.localization_only = True
    body = eng.fns.track_loc_body

    def vo_mode(*a):
        res = body(*a)
        s = res.summary.clone()
        s[39] = 3
        return res._replace(summary=s)

    T_reloc = np.eye(4, dtype=np.float32)
    T_reloc[2, 3] = -1.0
    asked = []

    def relocalize(ms, fd):
        asked.append(fd)
        return T_reloc, torch.full((fd.n,), -1, dtype=torch.int32)

    eng.fns = eng.fns._replace(track_loc_body=vo_mode)
    eng.loop_closer.relocalize = relocalize
    Tcw = eng.track_rgbd(*frames[N_MAP], 1.0)
    assert len(asked) == 1 and eng.stats["reloc"] == 1
    np.testing.assert_array_equal(Tcw, T_reloc)
    assert eng.last_fd is asked[0] and eng.velocity is None


def test_windowed_engine_inserts_nothing_in_localization_mode(sequence):  # noqa
    poses, frames = sequence
    eng = TorchWindowed(TCFG, enable_loop_closing=False, device="cpu",
                        window=4)
    for i in range(8):
        eng.track_rgbd(*frames[i], 0.1 * i)
    eng.flush()
    eng.localization_only = True
    windows = []
    track = eng.f_track_window
    eng.f_track_window = lambda *a: windows.append(1) or track(*a)
    before = _map_size(eng)
    for i in range(8, len(frames)):
        eng.track_rgbd(*frames[i], 0.1 * i)
    est = eng.frame_poses()                     # flushes
    assert windows and eng.state == 2
    assert _map_size(eng) == before
    err = [np.linalg.norm(_centre(Te) - _centre(Tg))
           for Te, Tg in zip(est, poses)]
    assert len(err) == len(frames) and max(err) < 0.05, err
