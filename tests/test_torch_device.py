"""The port's stateful entry points run on the CUDA card by default.

``SlamEngine(cfg)`` and ``LoopCloser(cfg, voc)`` with no ``device`` take
the card, and raise where torch has no CUDA device (forced here with
``monkeypatch``, so the tests mean the same on a host with a card); an
explicit ``device="cpu"`` builds them on the CPU."""

import pytest
import torch

from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.models import vocabulary as voc_mod
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser
from orbslam2_tpu_torch.runtime.slam import SlamEngine

torch.set_num_threads(2)

CFG = SlamConfig(
    camera=CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                        width=320, height=240, fps=10.0, th_depth=60.0),
    orb=OrbConfig(n_features=200),
    capacity=CapacityConfig(max_keyframes=4, max_map_points=1024,
                            local_ba_keyframes=2, local_ba_points=256),
    sensor=STEREO)


def _build(entry, **kw):
    if entry == "SlamEngine":
        return SlamEngine(CFG, **kw)
    voc = voc_mod.default_vocabulary(k=CFG.capacity.vocab_k,
                                     levels=CFG.capacity.vocab_levels)
    return LoopCloser(CFG, voc, **kw)


@pytest.mark.parametrize("entry", ["SlamEngine", "LoopCloser"])
def test_no_device_raises_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _build(entry)


@pytest.mark.parametrize("entry", ["SlamEngine", "LoopCloser"])
def test_explicit_cpu_builds(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = _build(entry, device="cpu")
    assert obj.device == torch.device("cpu")
    if entry == "SlamEngine":
        assert obj.ms.kf_valid.device.type == "cpu"
        assert obj.loop_closer.device == torch.device("cpu")


def test_default_is_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_mod.resolve() == torch.device("cuda")
    assert device_mod.resolve("cpu") == torch.device("cpu")
