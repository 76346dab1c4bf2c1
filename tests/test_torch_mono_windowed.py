"""Mono on the port's ``WindowedSlamEngine(window=4)``: against the JAX
package's on test_torch_mono.py's sequence and bars (12 frames of
bench.py's mono walk at 1000 features, loop closing off, ``_mapper_idle``
patched to True on both, JAX's PRNGKey(7) draws replayed into the port:
both initialize on the same frame, neither LOST, keyframe counts within
±1, the port's similarity-aligned ATE below 0.03 × path length and
within 0.01 m of the JAX engine's), then scripted checks of the mono
rules with test_torch_windowed.py's stand-in tracker and mapping step:

  * no cross-window pipeline: a window is retired before the next one is
    dispatched, so the next one tracks on the map with its keyframes;
  * an insert inside a window re-runs the window's later frames one by
    one through the per-frame path, from the new keyframe's points, all
    of them inliers, with no window counters carried;
  * that branch releases the window's reference keyframe first, so that a
    keyframe culled during the re-runs frees its slot.
"""

import dataclasses

import numpy as np
import torch

from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxWindowed
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchSlamEngine
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from test_torch_mono import (JCFG, TCFG, engines_track_alike,  # noqa: F401
                             sequence)
from test_torch_windowed_rules import TINY, W, Script

torch.set_num_threads(2)

MONO = dataclasses.replace(TINY, sensor=tconfig.MONOCULAR)
IMG = np.zeros((240, 320), np.uint8)


def test_windowed_mono_engine_tracks_like_jax(sequence):  # noqa: F811
    engines_track_alike(
        JaxWindowed(JCFG, enable_loop_closing=False, window=4),
        WindowedSlamEngine(TCFG, enable_loop_closing=False, device="cpu",
                           window=4),
        sequence, windowed=True)


def _mono_engine(decide):
    """A mono windowed engine past initialization (keyframe 0 at frame 0),
    its window tracker and mapping step scripted; ``decide(frame_id)``
    stands in for NeedNewKeyFrame."""
    eng = WindowedSlamEngine(MONO, enable_loop_closing=False, device="cpu",
                             window=W)
    N = MONO.orb.n_features_padded
    eng.state = ttracking.OK
    eng.n_kfs = eng.kf_ordinal = 1
    eng._free_kf_slots.discard(0)
    eng.frame_id = eng.last_kf_frame_id = 1
    eng.last_Tcw = np.eye(4, dtype=np.float32)
    eng.last_assoc = torch.zeros(N, dtype=torch.int32)
    eng.last_inlier = torch.zeros(N, dtype=torch.bool)
    eng._need_new_keyframe = lambda sm, ref_override=None: decide(
        eng.frame_id)
    return eng


def _push(eng, first, stop):
    for f in range(first, stop):
        eng.track_monocular(IMG, 0.1 * f)


def test_mono_window_retires_before_the_next_dispatch():
    """Window A (frames 1-4) inserts at its last frame; window B is
    dispatched only after that retire, on the map holding the insert (a
    stereo window B would track on map version 0)."""
    eng = _mono_engine(decide=lambda f: f == 4)
    s = Script(eng)
    _push(eng, 1, 3 * W + 1)
    assert s.log == [("track", 0, 0), ("insert", 4, 1), ("track", 1, 1),
                     ("track", 2, 1)], s.log
    assert eng._pending is None and not eng._window_refs
    assert len(eng.trajectory) == 3 * W


def _rerun_recorder(monkeypatch, on_rerun=None):
    reruns = []

    def per_frame(self, pair, ts):
        reruns.append({"frame": round(ts * 10), "frame_id": self.frame_id,
                       "assoc": self.last_assoc.clone(),
                       "inliers": bool(self.last_inlier.all()),
                       "counters": self._pending_counters,
                       "window_refs": list(self._window_refs)})
        if on_rerun is not None:
            on_rerun(self)
        self.frame_id += 1

    monkeypatch.setattr(TorchSlamEngine, "_track_common", per_frame)
    return reruns


def test_in_window_insert_reruns_the_later_frames(monkeypatch):
    """An insert at frame 2 (row 1 of window A): frames 3 and 4 are tracked
    again one by one from the new keyframe's points (slot 1), with every
    association an inlier and no window counters; nothing of window A is
    appended after frame 2."""
    reruns = _rerun_recorder(monkeypatch)
    eng = _mono_engine(decide=lambda f: f == 2)
    N = MONO.orb.n_features_padded
    kf_mp = eng.ms.kf_mp.clone()
    kf_mp[1] = torch.arange(N, dtype=torch.int32)
    eng.ms = eng.ms._replace(kf_mp=kf_mp)
    s = Script(eng)
    _push(eng, 1, W + 1)
    assert [r["frame"] for r in reruns] == [3, 4]
    first = reruns[0]
    assert first["frame_id"] == 3 and eng.ref_kf == 1
    assert torch.equal(first["assoc"], kf_mp[1])
    assert first["inliers"] and first["counters"] is None
    assert len(eng.trajectory) == 2 and len(s.inserts) == 1
    assert s.log == [("track", 0, 0), ("insert", 2, 1)], s.log


def test_in_window_insert_releases_the_window_reference(monkeypatch):
    """Keyframe 0, window A's reference, is culled during the re-runs: its
    slot is free at once, because the window was released before them (a
    slot still listed under an unretired window would be held forever:
    the branch never reaches the retire's end)."""
    reruns = _rerun_recorder(
        monkeypatch, on_rerun=lambda e: e._on_kfs_culled(e.ms, [0])
        if e.frame_id == 3 else None)
    eng = _mono_engine(decide=lambda f: f == 2)
    Script(eng)
    _push(eng, 1, W + 1)
    assert [r["window_refs"] for r in reruns] == [[], []]
    assert 0 in eng._free_kf_slots and not eng._held_slots
    assert not eng._window_refs
