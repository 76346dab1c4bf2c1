"""The port's stateful entry points run on the CUDA card by default.

``System(None, None, sensor, config=cfg)``, ``SlamEngine(cfg)``,
``WindowedSlamEngine(cfg)`` (stereo, RGB-D and mono), ``LoopCloser(cfg, voc)`` and ``streaming.make_window_tracker(cfg, window)``
with no ``device`` take the card, and raise where torch has no CUDA
device (forced here with ``monkeypatch``, so the tests mean the same on a
host with a card); an explicit ``device="cpu"`` builds them on the CPU.
``track_rgbd`` and ``track_monocular`` upload their frame to the engine's
device."""

import pytest
import torch

import dataclasses

import numpy as np

from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       MONOCULAR, OrbConfig, RGBD, STEREO,
                                       SlamConfig)
from orbslam2_tpu_torch.models import vocabulary as voc_mod
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.runtime import streaming
from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser
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
    voc = voc_mod.default_vocabulary(k=CFG.capacity.vocab_k,
                                     levels=CFG.capacity.vocab_levels)
    return LoopCloser(CFG, voc, **kw)


ENTRIES = ["SlamEngine", "LoopCloser", "WindowedSlamEngine",
           "make_window_tracker", "SlamEngine(RGBD)",
           "WindowedSlamEngine(RGBD)", "SlamEngine(MONO)",
           "WindowedSlamEngine(MONO)", "System"]


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
