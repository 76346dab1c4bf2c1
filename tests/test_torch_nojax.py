"""The port starts where there is no jax: the GPU host has none.

In a subprocess where ``import jax`` fails, import the port and
``chip_smoke``, run a few stereo frames through ``SlamEngine.track_stereo``
on the CPU with loop closing on (keyframe DB registration, detection,
then relocalization from LOST), then through ``WindowedSlamEngine`` in
windows of two and one LOC window of ``streaming.make_window_tracker``,
then RGB-D frames through ``SlamEngine.track_rgbd`` and
``WindowedSlamEngine.track_rgbd``, each then in localization mode (the
VO path, relocalization from LOST, windows that insert nothing), and a
GBA chunk past 256 keyframe slots (the CG solver), and check that
nothing of jax or ``orbslam2_tpu`` was loaded.
Also: ``chip_smoke.py`` refuses to run without a card, and fails on its
own outside the repository, without printing a result.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import numpy as np, torch
torch.set_num_threads(2)
import orbslam2_tpu_torch
import chip_smoke  # noqa: F401  (the GPU entry point imports no jax)
from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.utils import synthetic
cam = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                   width=320, height=240, fps=10.0, th_depth=60.0)
cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=200),
                 capacity=CapacityConfig(max_keyframes=4,
                                         max_map_points=1024,
                                         local_ba_keyframes=2,
                                         local_ba_points=256),
                 sensor=STEREO)
from orbslam2_tpu_torch.runtime import tracking
rng = np.random.default_rng(0)
world = synthetic.make_world(rng)
poses = synthetic.straight_trajectory(8, step=0.3)
eng = SlamEngine(cfg, device="cpu")         # loop closing on by default
assert eng.loop_closer is not None
for i, T in enumerate(poses):
    Tcw = eng.track_stereo(*synthetic.render_world_stereo(world, cam, T, rng,
                                                          1.0), 0.1 * i)
    assert Tcw is not None and eng.state == 2, (i, eng.state)
assert bool(eng.loop_closer.db.valid.any()), eng.stats   # keyframes in DB
eng.state = tracking.LOST                   # relocalization runs too
eng.track_stereo(*synthetic.render_world_stereo(world, cam, poses[-1], rng,
                                                1.0), 9.0)
eng.finish_gba()
from orbslam2_tpu_torch.runtime import streaming
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
frames = [synthetic.render_world_stereo(world, cam, T, rng, 1.0)
          for T in poses]
weng = WindowedSlamEngine(cfg, enable_loop_closing=False, device="cpu",
                          window=2)
for i, (left, right) in enumerate(frames[:7]):
    weng.track_stereo(left, right, 0.1 * i)
assert weng._pending is not None                     # a window in flight
assert len(weng.frame_poses()) == 7 and weng.state == 2, weng.stats
track = streaming.make_window_tracker(cfg, 1, device="cpu")
res = track(weng.ms, streaming.pack_window_uint8(frames[7:]),
            np.stack([weng.last_Tcw, weng.last_Tcw]), weng.last_assoc,
            weng.ref_kf)
assert res.summaries.shape == (1, 40) and float(res.summaries[0, 34]) >= 30
from orbslam2_tpu_torch.config import RGBD
import dataclasses
rcfg = dataclasses.replace(cfg, sensor=RGBD)
rframes = [synthetic.render_world(world, cam, T, rng, 1.0, with_depth=True)
           for T in poses]
rframes = [(np.clip(g, 0, 255).astype(np.uint8), d) for g, d in rframes]
reng = SlamEngine(rcfg, device="cpu")
for i, (g, d) in enumerate(rframes[:6]):
    assert reng.track_rgbd(g, d, 0.1 * i) is not None, i
reng.localization_only = True
kfs = reng.stats["kf_inserted"]
assert reng.track_rgbd(*rframes[6], 0.6) is not None       # the VO path
reng.state = tracking.LOST
assert reng.track_rgbd(*rframes[2], 0.7) is not None       # relocalized
assert reng.stats["kf_inserted"] == kfs and reng.stats["reloc"] == 1
rweng = WindowedSlamEngine(rcfg, enable_loop_closing=False, device="cpu",
                           window=2)
for i, (g, d) in enumerate(rframes[:5]):
    rweng.track_rgbd(g, d, 0.1 * i)
rweng.localization_only = True
kfs = rweng.stats["kf_inserted"]
for i, (g, d) in enumerate(rframes[5:], start=5):
    rweng.track_rgbd(g, d, 0.1 * i)
assert len(rweng.frame_poses()) == 8 and rweng.state == 2, rweng.stats
assert rweng.stats["kf_inserted"] == kfs
from orbslam2_tpu_torch.runtime import gba
big = dataclasses.replace(cfg, capacity=CapacityConfig(
    max_keyframes=264, max_map_points=1024, local_ba_keyframes=2,
    local_ba_points=256))
beng = SlamEngine(big, enable_loop_closing=False, device="cpu")
for i, (left, right) in enumerate(frames[:3]):
    beng.track_stereo(left, right, 0.1 * i)
chunk, _ = gba.make_gba_fns(big)
ms2, inl = chunk(beng.ms, torch.ones(264 * beng.ms.N, dtype=torch.bool),
                 True)
assert bool(torch.isfinite(ms2.kf_pose).all())
bad = sorted(m for m in sys.modules if m == "orbslam2_tpu"
             or m.startswith("orbslam2_tpu.")
             or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not bad, bad
print("NOJAX_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_port_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NOJAX_OK" in out.stdout


def test_chip_smoke_fails_without_a_card():
    """No CUDA here: the smoke script exits non-zero before any result."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-card refusal; this host has a card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
