"""The port starts where there is no jax: the GPU host has none.

In a subprocess where ``import jax`` fails, import the port and
``chip_smoke``, run one stereo frame through ``SlamEngine.track_stereo``
on the CPU, and check that nothing of jax or ``orbslam2_tpu`` was loaded.
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
rng = np.random.default_rng(0)
world = synthetic.make_world(rng)
T = synthetic.straight_trajectory(1)[0]
eng = SlamEngine(cfg, enable_loop_closing=False, device="cpu")
Tcw = eng.track_stereo(*synthetic.render_world_stereo(world, cam, T, rng,
                                                      1.0), 0.0)
assert Tcw is not None and eng.state == 2, eng.state
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
