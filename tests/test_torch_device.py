"""The port's stateful entry points run on the CUDA card by default.

``System(None, None, sensor, config=cfg)``, ``SlamEngine(cfg)``,
``WindowedSlamEngine(cfg)`` (stereo, RGB-D and mono),
``AsyncSlamEngine(cfg)``, ``LoopCloser(cfg, voc)``,
``StereoRectifier(maps)`` and ``streaming.make_window_tracker(cfg, window)``
with no ``device`` take the card, and raise where torch has no CUDA
device (forced here with ``monkeypatch``, so the tests mean the same on a
host with a card); an explicit ``device="cpu"`` builds them on the CPU.
``track_rgbd`` and ``track_monocular`` upload their frame to the engine's
device.  Vocabulary building (``harvest_training_descriptors``,
``build_vocabulary``, ``default_vocabulary`` of a missing tree) runs on
the card by default too.  No engine, ``LoopCloser``, ``GbaManager`` or
``System`` makes a mesh (``parallel/mesh.auto_mesh``) on the CPU or with
one CUDA device."""

import pytest
import torch

import dataclasses

import numpy as np

from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       MONOCULAR, OrbConfig, RGBD, STEREO,
                                       SlamConfig)
from orbslam2_tpu_torch.models import vocabulary as voc_mod
from orbslam2_tpu_torch.ops import rectify
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.runtime import streaming
from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser
from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine

torch.set_num_threads(2)

CFG = SlamConfig(
    camera=CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                        width=320, height=240, fps=10.0, th_depth=60.0),
    orb=OrbConfig(n_features=200),
    capacity=CapacityConfig(max_keyframes=4, max_map_points=1024,
                            local_ba_keyframes=2, local_ba_points=256),
    sensor=STEREO)


RGBD_CFG = dataclasses.replace(CFG, sensor=RGBD)
MONO_CFG = dataclasses.replace(CFG, sensor=MONOCULAR)


def _build(entry, **kw):
    if entry == "SlamEngine":
        return SlamEngine(CFG, **kw)
    if entry == "WindowedSlamEngine":
        return WindowedSlamEngine(CFG, **kw)
    if entry == "SlamEngine(RGBD)":
        return SlamEngine(RGBD_CFG, **kw)
    if entry == "WindowedSlamEngine(RGBD)":
        return WindowedSlamEngine(RGBD_CFG, **kw)
    if entry == "SlamEngine(MONO)":
        return SlamEngine(MONO_CFG, **kw)
    if entry == "WindowedSlamEngine(MONO)":
        return WindowedSlamEngine(MONO_CFG, **kw)
    if entry == "System":
        return System(None, None, STEREO, config=CFG, **kw)
    if entry == "make_window_tracker":
        return streaming.make_window_tracker(CFG, 2, **kw)
    if entry == "AsyncSlamEngine":
        return AsyncSlamEngine(CFG, **kw)
    if entry == "StereoRectifier":
        m = np.zeros((240, 320), np.float32)
        return rectify.StereoRectifier(rectify.RectifyMaps(m, m, m, m), **kw)
    voc = voc_mod.default_vocabulary(k=CFG.capacity.vocab_k,
                                     levels=CFG.capacity.vocab_levels)
    return LoopCloser(CFG, voc, **kw)


ENTRIES = ["SlamEngine", "LoopCloser", "WindowedSlamEngine",
           "make_window_tracker", "SlamEngine(RGBD)",
           "WindowedSlamEngine(RGBD)", "SlamEngine(MONO)",
           "WindowedSlamEngine(MONO)", "System", "AsyncSlamEngine",
           "StereoRectifier"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_device_raises_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _build(entry)


@pytest.mark.parametrize("entry", ENTRIES)
def test_explicit_cpu_builds(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = _build(entry, device="cpu")
    assert obj.device == torch.device("cpu")
    if entry == "System":
        obj = obj.engine
    if "SlamEngine" in entry or entry == "System":
        assert obj.ms.kf_valid.device.type == "cpu"
        assert obj.loop_closer.device == torch.device("cpu")
    if entry == "AsyncSlamEngine":
        assert obj._stream is None          # a worker stream on the card only
    if entry == "StereoRectifier":
        assert all(m.device.type == "cpu" for m in obj._dev_maps)


@pytest.mark.parametrize("entry", ["harvest_training_descriptors",
                                   "build_vocabulary", "default_vocabulary"])
def test_vocabulary_building_without_device_raises_without_cuda(
        entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(voc_mod, "DATA_DIR", str(tmp_path))   # no tree
    args = (np.zeros((40, 8), np.uint32),) if entry == "build_vocabulary" \
        else ()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(voc_mod, entry)(*args)


def test_default_is_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_mod.resolve() == torch.device("cuda")
    assert device_mod.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["SlamEngine(RGBD)",
                                   "WindowedSlamEngine(RGBD)"])
def test_track_rgbd_uploads_to_the_engine_device(entry, monkeypatch):
    """The RGB-D frame goes to the engine's device (the card when none was
    given): gray uint8 → float32, depth float32 as given.  ``meta``
    stands in for the card here."""
    eng = _build(entry, device="cpu")
    eng.device = torch.device("meta")
    seen = []
    monkeypatch.setattr(eng, "_track_common",
                        lambda pair, ts: seen.append(pair))
    gray = np.full((240, 320), 7, np.uint8)
    depth = np.full((240, 320), 2.5, np.float64)
    eng.track_rgbd(gray, depth, 0.0)
    (g, d), = seen
    assert g.device.type == d.device.type == "meta"
    assert g.dtype == d.dtype == torch.float32
    assert tuple(g.shape) == tuple(d.shape) == (240, 320)


@pytest.mark.parametrize("entry", ["SlamEngine(MONO)",
                                   "WindowedSlamEngine(MONO)"])
def test_track_monocular_uploads_to_the_engine_device(entry, monkeypatch):
    """The mono frame goes to the engine's device as a 1-tuple: uint8 gray
    → float32.  ``meta`` stands in for the card here."""
    eng = _build(entry, device="cpu")
    eng.device = torch.device("meta")
    seen = []
    monkeypatch.setattr(eng, "_track_common",
                        lambda pair, ts: seen.append(pair))
    eng.track_monocular(np.full((240, 320), 7, np.uint8), 0.0)
    (g,), = seen
    assert g.device.type == "meta" and g.dtype == torch.float32
    assert tuple(g.shape) == (240, 320)


# the drivers (tools/replay.py, tools/live.py): each builds its System on
# the card unless given device="cpu"
def _no_source():
    return None


DRIVERS = {
    "run_kitti_stereo": lambda r, l, **kw: r.run_kitti_stereo("seq", None,
                                                              **kw),
    "run_tum_rgbd": lambda r, l, **kw: r.run_tum_rgbd("seq", None, **kw),
    "run_tum_mono": lambda r, l, **kw: r.run_tum_mono("seq", None, **kw),
    "run_euroc_stereo": lambda r, l, **kw: r.run_euroc_stereo("mav", None,
                                                              **kw),
    "run_kitti_mono": lambda r, l, **kw: r.run_kitti_mono("seq", None,
                                                          **kw),
    "run_euroc_mono": lambda r, l, **kw: r.run_euroc_mono("mav", None,
                                                          **kw),
    "run_isl_stereo": lambda r, l, **kw: r.run_isl_stereo("l", "r", "t",
                                                          None, **kw),
    "run_ird_realsense": lambda r, l, **kw: r.run_ird_realsense(
        "seq", None, **kw),
    "run_synthetic_stereo": lambda r, l, **kw: r.run_synthetic_stereo(
        2, **kw),
    "run_mono_live": lambda r, l, **kw: l.run_mono_live(_no_source, None,
                                                        **kw),
    "run_ird_live": lambda r, l, **kw: l.run_ird_live(_no_source, None,
                                                      **kw),
    "run_multicam": lambda r, l, **kw: l.run_multicam(_no_source,
                                                      _no_source, None,
                                                      **kw),
    "run_uwb": lambda r, l, **kw: l.run_uwb(_no_source, None, {}, **kw),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_without_device_raises_without_cuda(driver, monkeypatch,
                                                   tmp_path):
    from orbslam2_tpu_torch.tools import live, replay
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DRIVERS[driver](replay, live)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_passes_device_to_system(driver, monkeypatch, tmp_path):
    """No device: None reaches System (which takes the card); "cpu"
    reaches it as given."""
    from orbslam2_tpu_torch.tools import live, replay
    seen = []

    class Stop(Exception):
        pass

    def system(*args, device=None, **kwargs):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(replay, "System", system)
    monkeypatch.setattr(live, "System", system)
    monkeypatch.chdir(tmp_path)
    for kw in ({}, {"device": "cpu"}):
        with pytest.raises(Stop):
            DRIVERS[driver](replay, live, **kw)
    assert seen == [None, "cpu"]


def test_no_mesh_on_the_cpu_or_with_one_card(monkeypatch):
    """The auto rule, JAX's ``device_count() > 1``: a mesh only where the
    component's device is one of several CUDA devices.  torch is made to
    report two cards, then one."""
    from orbslam2_tpu_torch.parallel import mesh as mesh_mod
    from orbslam2_tpu_torch.runtime.gba import GbaManager
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert mesh_mod.auto_mesh("cuda") is not None
    for entry in ("LoopCloser", "System", "SlamEngine"):
        obj = _build(entry, device="cpu")
        lc = obj if entry == "LoopCloser" else obj.engine.loop_closer \
            if entry == "System" else obj.loop_closer
        assert lc.mesh is None and lc.gba.mesh is None, entry
    mgr = GbaManager(CFG)
    mgr.launch(_build("SlamEngine", device="cpu").ms)
    mgr.wait()
    assert mgr.mesh is None and mgr.stats["distributed"] == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_mod.auto_mesh("cuda") is None


def test_ar_demo_draws_on_the_engine_device():
    from orbslam2_tpu_torch.utils.ar import ArDemo
    eng = SlamEngine(CFG, enable_loop_closing=False, device="cpu")
    demo = ArDemo(eng)
    assert demo._gen.device == eng.device
    assert demo.insert_cube() is False       # an empty map has no plane
