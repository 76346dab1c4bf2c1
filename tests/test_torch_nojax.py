"""The port starts where there is no jax: the GPU host has none.

In a subprocess where ``import jax`` fails, import the port and
``chip_smoke``, run a few stereo frames through ``SlamEngine.track_stereo``
on the CPU with loop closing on (keyframe DB registration, detection,
then relocalization from LOST), then through ``WindowedSlamEngine`` in
windows of two and one LOC window of ``streaming.make_window_tracker``,
then RGB-D frames through ``SlamEngine.track_rgbd`` and
``WindowedSlamEngine.track_rgbd``, each then in localization mode (the
VO path, relocalization from LOST, windows that insert nothing), a
GBA chunk past 256 keyframe slots (the CG solver), and mono frames of
bench.py's mono walk through ``SlamEngine.track_monocular`` and
``WindowedSlamEngine.track_monocular`` (the H/F initializer, then one
window), then a ``System`` through ``tools.replay.replay``, its map saved
(``runtime/serialization.py``) and loaded by a second ``System``, which
relocalizes, stereo frames through ``AsyncSlamEngine`` (its worker maps
them; ``runtime/pipeline.py``) and a pair through ``StereoRectifier``'s
host and device paths (``ops/rectify.py``), and check that nothing of
jax or ``orbslam2_tpu`` was loaded.
Also, with PIL and cv2 unimportable too, the dataset drivers and the
stream node (``test_drivers_run_without_jax_pil_or_cv2``).
Also, with jax unimportable, a small vocabulary harvest and build, and
``default_vocabulary`` building a missing tree
(``test_vocabulary_builds_without_jax``); and ``parallel/*`` with
``tools/scaling.py``: a sharded bundle adjustment, a ``LoopCloser`` and a
``GbaManager`` on a mesh of CPU shards, and ``measure_scaling`` at a
small size (``test_parallel_runs_without_jax``); and the map-scale
circuit's module and the trajectory tool
(``test_scale_and_plot_tools_run_without_jax``).
And, with jax and cv2 unimportable, the bench legs and the replay harness
(``tools/bench.py``, ``tools/benchmark.py``;
``test_bench_tools_run_without_jax``).
And: ``chip_smoke.py`` refuses to run without a card, and fails on its
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
import orbslam2_tpu_torch.tools.async_orbit_spread  # noqa: F401
import orbslam2_tpu_torch.tools.orbit_spread  # noqa: F401
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
from orbslam2_tpu_torch.config import MONOCULAR
from orbslam2_tpu_torch.utils import trajectory
mcam = dataclasses.replace(cam, fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                           bf=0.0, width=640, height=480)
mcfg = dataclasses.replace(cfg, camera=mcam, orb=OrbConfig(n_features=1000),
                           capacity=CapacityConfig(max_keyframes=8,
                                                   max_map_points=2048,
                                                   local_ba_keyframes=4,
                                                   local_ba_points=512),
                           sensor=MONOCULAR)
mrng = np.random.default_rng(0)
mworld = synthetic.make_world(mrng)
mposes = [synthetic.look_ahead_pose(np.array([0.18 * i, 0.0, 0.04 * i]))
          for i in range(7)]
mframes = [np.clip(synthetic.render_world(mworld, mcam, T, mrng, noise=1.0),
                   0, 255).astype(np.uint8) for T in mposes]
meng = SlamEngine(mcfg, enable_loop_closing=False, device="cpu")
mout = [meng.track_monocular(g, 0.1 * i) for i, g in enumerate(mframes[:4])]
assert meng.state == 2 and mout[-1] is not None, (meng.state, meng.stats)
mweng = WindowedSlamEngine(mcfg, enable_loop_closing=False, device="cpu",
                           window=4)
for i, g in enumerate(mframes):
    mweng.track_monocular(g, 0.1 * i)
mest = [T for T in mweng.frame_poses() if T is not None]
assert mweng.state == 2 and len(mest) >= 4, (mweng.state, mweng.stats)
gt = trajectory.centers_from_poses(mposes[-len(mest):])
assert trajectory.ate_rmse(trajectory.centers_from_poses(mest), gt,
                           align=True, with_scale=True) < 0.05
import os, tempfile
from orbslam2_tpu_torch.runtime import serialization  # noqa: F401
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.tools import replay
sysm = System(None, None, STEREO, config=cfg, device="cpu")
rep = replay.replay(sysm, [(left, right, 0.1 * i)
                           for i, (left, right) in enumerate(frames[:4])],
                    "stereo", warmup=1)
assert rep.n_tracked == 4 and len(rep.durations_ms) == 3, rep
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "map.npz")
    sysm.save_map(path)
    sys2 = System(None, None, STEREO, config=cfg.replace(map_file=path),
                  device="cpu")
assert sys2.engine.localization_only and sys2.get_tracking_state() == 3
assert sys2.track_stereo(*frames[2], 5.0) is not None     # relocalized
assert sys2.get_current_covariance().shape == (6, 6)
from orbslam2_tpu_torch.runtime.pipeline import AsyncSlamEngine
aeng = AsyncSlamEngine(cfg, device="cpu")      # loop closing on
aeng.start()
aout = [aeng.track_stereo(left, right, 0.1 * i)
        for i, (left, right) in enumerate(frames[:5])]
aeng.shutdown()
assert all(T is not None for T in aout) and not aeng._worker.is_alive()
assert aeng.stats["kf_inserted"] >= 2 and len(aeng.frame_poses()) == 5
from orbslam2_tpu_torch.ops import rectify
K = np.array([[225.0, 0, 160.0], [0, 225.0, 120.0], [0, 0, 1.0]])
blk = {"K": K, "D": np.array([[-0.1, 0.01, 0.0, 0.0, 0.0]]), "R": np.eye(3),
       "P": np.hstack([K, np.zeros((3, 1))]), "width": 320, "height": 240}
rect = rectify.load_rectification(
    {f"{s}.{k}": v for s in ("LEFT", "RIGHT") for k, v in blk.items()},
    device="cpu")
rl, rr = rect.remap_pair(*frames[0])
hl, hr = rect(*frames[0])
assert float((rl - torch.from_numpy(hl)).abs().max()) < 1e-3
bad = sorted(m for m in sys.modules if m == "orbslam2_tpu"
             or m.startswith("orbslam2_tpu.")
             or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not bad, bad
print("NOJAX_OK")
"""


_DRIVERS_CHILD = r"""
import sys
for name in ("jax", "PIL", "cv2"):
    sys.modules[name] = None          # any import of them now raises
import os, tempfile, time
import numpy as np, torch
torch.set_num_threads(2)
import orbslam2_tpu_torch.runtime.ros_node  # noqa: F401
import orbslam2_tpu_torch.tools.live  # noqa: F401
import orbslam2_tpu_torch.utils.ar  # noqa: F401
import orbslam2_tpu_torch.utils.live_viewer  # noqa: F401
import orbslam2_tpu_torch.utils.sensors  # noqa: F401
import orbslam2_tpu_torch.utils.viewer  # noqa: F401
from orbslam2_tpu_torch.config import CameraConfig, STEREO
from orbslam2_tpu_torch.runtime.stream_node import StreamNode
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.tools import replay
from orbslam2_tpu_torch.utils import datasets, png, synthetic
from orbslam2_tpu_torch.utils.markers import ArucoCodeScanner, QrCodeTracker
assert not QrCodeTracker().available and not ArucoCodeScanner().available
cam = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                   width=320, height=240, fps=10.0, th_depth=60.0)
rng = np.random.default_rng(0)
world = synthetic.make_world(rng)
poses = synthetic.straight_trajectory(6, step=0.3)
d = tempfile.mkdtemp()
for sub in ("image_0", "image_1"):
    os.makedirs(os.path.join(d, sub))
for i, T in enumerate(poses):
    for sub, img in zip(("image_0", "image_1"),
                        synthetic.render_world_stereo(world, cam, T, rng,
                                                      1.0)):
        png.write_png(os.path.join(d, sub, f"{i:06d}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
with open(os.path.join(d, "times.txt"), "w") as f:
    f.write("".join(f"{0.1 * i:e}\n" for i in range(6)))
settings = os.path.join(d, "s.yaml")
with open(settings, "w") as f:
    f.write("%YAML:1.0\nCamera.fx: 225.0\nCamera.fy: 225.0\n"
            "Camera.cx: 160.0\nCamera.cy: 120.0\nCamera.bf: 75.0\n"
            "Camera.width: 320\nCamera.height: 240\nThDepth: 60.0\n"
            "ORBextractor.nFeatures: 200\n")
rep = replay.run_kitti_stereo(d, settings, os.path.join(d, "t.txt"),
                              device="cpu")
assert rep.n_frames == rep.n_tracked == 6, rep
assert len(open(os.path.join(d, "t.txt")).read().splitlines()) == 6
poses_out = []
node = StreamNode(System(None, settings, STEREO, device="cpu"),
                  on_pose=lambda p, t: poses_out.append(p))
node.start()
for i, (left, right, t) in enumerate(datasets.iter_kitti_stereo(d)):
    node.on_image_stereo(left, right, t)
    deadline = time.time() + 120      # each frame after the last's pose
    while len(poses_out) <= i and time.time() < deadline \
            and node.error is None:
        time.sleep(0.01)
node.stop()
assert node.processed == 6 and node.dropped == 0
assert all(p is not None for p in poses_out)
bad = sorted(m for m in sys.modules
             if m == "orbslam2_tpu" or m.startswith("orbslam2_tpu.")
             or (m.split(".")[0] in ("jax", "PIL", "cv2")
                 and sys.modules[m] is not None))
assert not bad, bad
print("DRIVERS_NOJAX_OK")
"""


_VOCAB_CHILD = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import os, tempfile
import numpy as np, torch
torch.set_num_threads(2)
from orbslam2_tpu_torch.models import vocabulary as voc
bank = voc._real_textures()[:1]       # one raster where matplotlib imports
voc._real_textures = lambda: list(bank)
desc = voc.harvest_training_descriptors(n_worlds=1, views_per_world=1,
                                        device="cpu")
assert desc.dtype == torch.int32 and desc.shape[1] == 8, desc.shape
assert desc.shape[0] >= 250 * (1 + 6 * len(bank)), desc.shape
v = voc.build_vocabulary(desc, k=5, levels=2, device="cpu")
assert [tuple(c.shape) for c in v.centroids] == [(5, 8), (25, 8)]
assert bool(torch.isfinite(v.idf).all()) and v.idf.shape == (25,)
voc.DATA_DIR = tempfile.mkdtemp()
voc._real_textures = lambda: []
h = voc.harvest_training_descriptors
voc.harvest_training_descriptors = \
    lambda device: h(n_worlds=1, views_per_world=1, device=device)
built = voc.default_vocabulary(k=3, levels=2, device="cpu")
assert os.path.exists(os.path.join(voc.DATA_DIR, "vocab_k3_l2.npz"))
back = voc.default_vocabulary(k=3, levels=2)
assert all(torch.equal(a, b) for a, b in zip(back.centroids,
                                              built.centroids))
bad = sorted(m for m in sys.modules if m == "orbslam2_tpu"
             or m.startswith("orbslam2_tpu.")
             or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not bad, bad
print("VOCAB_NOJAX_OK")
"""


_PARALLEL_CHILD = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import numpy as np, torch
torch.set_num_threads(2)
from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.models import vocabulary as voc_mod
from orbslam2_tpu_torch.parallel import db_shard, dist_ba, mesh as mesh_mod
from orbslam2_tpu_torch.runtime.gba import GbaManager
from orbslam2_tpu_torch.runtime.loop_closing import LoopCloser
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.tools import scaling
from orbslam2_tpu_torch.utils import synthetic
cam = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                   width=320, height=240, fps=10.0, th_depth=60.0)
cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=200),
                 capacity=CapacityConfig(max_keyframes=8,
                                         max_map_points=1024,
                                         local_ba_keyframes=2,
                                         local_ba_points=256),
                 sensor=STEREO)
rng = np.random.default_rng(0)
world = synthetic.make_world(rng)
eng = SlamEngine(cfg, device="cpu")
assert eng.loop_closer.mesh is None        # the CPU: no mesh by itself
for i, T in enumerate(synthetic.straight_trajectory(4, step=0.3)):
    assert eng.track_stereo(*synthetic.render_world_stereo(
        world, cam, T, rng, 1.0), 0.1 * i) is not None
eng.finish_gba()
mesh = mesh_mod.make_mesh(["cpu"] * 2)
mgr = GbaManager(cfg, mesh=mesh)
mgr.launch(eng.ms)
mgr.wait()
ms, merged = mgr.poll_and_merge(eng.ms)
assert merged and mgr.stats["distributed"] == 1
assert bool(torch.isfinite(ms.kf_pose).all())
voc = voc_mod.default_vocabulary(device="cpu")
lc = LoopCloser(cfg, voc, device="cpu", mesh=mesh)
for kf in torch.nonzero(eng.ms.kf_valid).flatten().tolist():
    lc.db, _, info = lc.fns.detect_step(eng.ms, lc.db, kf)
assert isinstance(lc.db, db_shard.ShardedKeyFrameDB)
assert bool(lc.db.valid.any())
out = scaling.measure_scaling(["cpu"] * 2, C=6, pts_per_cam=48, n_pts=128,
                              repeats=1)
assert out["scaling_devices"] == 2 and out["scaling_sharded_ms"] > 0
assert out["scaling_mode"].startswith("sharding-overhead proxy"), out
bad = sorted(m for m in sys.modules if m == "orbslam2_tpu"
             or m.startswith("orbslam2_tpu.")
             or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not bad, bad
print("PARALLEL_NOJAX_OK")
"""


_TOOLS_CHILD = r"""
import os, sys, tempfile
sys.modules["jax"] = None            # any `import jax` now raises
import numpy as np
from orbslam2_tpu_torch.tools import plot_trajectory, scale_demo
from orbslam2_tpu_torch.utils import trajectory
cfg = scale_demo.scale_config()
assert cfg.capacity.max_keyframes == 1024
d = tempfile.mkdtemp()
rng = np.random.default_rng(0)
gt = np.cumsum(rng.normal(0, 0.2, (40, 3)), axis=0)
ts = 0.1 * np.arange(40)
poses = []
for p in gt:
    T = np.eye(4)
    T[:3, 3] = -p
    poses.append(T)
trajectory.save_tum(os.path.join(d, "gt.txt"), ts, poses)
trajectory.save_tum(os.path.join(d, "est.txt"), ts + 0.005, poses)
os.chdir(d)
plot_trajectory.main(["est.txt", "gt.txt", "--align", "--out", "t.png"])
assert os.path.exists("t.png") or os.path.exists("t.ply"), os.listdir(d)
bad = sorted(m for m in sys.modules if m == "orbslam2_tpu"
             or m.startswith("orbslam2_tpu.")
             or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not bad, bad
print("TOOLS_NOJAX_OK")
"""


_BENCH_CHILD = r"""
import json, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["cv2"] = None            # the oracle's keys then go null
import torch
torch.set_num_threads(2)
from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.tools import bench, benchmark
cfg = SlamConfig(
    camera=CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                        width=320, height=240, fps=10.0, th_depth=60.0),
    orb=OrbConfig(n_features=200),
    capacity=CapacityConfig(max_keyframes=16, max_map_points=2048,
                            local_ba_keyframes=4, local_ba_points=512),
    sensor=STEREO)
depths = bench.Depths(warmup=8, measure=4, slam_passes=2, loc_windows=1,
                      loc_passes=1, mono_passes=1, rgbd_frames=6,
                      rgbd_warmup=2)
out = bench.run("cpu", cfg, depths, log=lambda s: None)
assert out["value"] > 0 and out["loc_mode_fps"] > 0, out
assert out["oracle_repo_ate_m"] is None, out
assert "cv2" in out["null_reasons"]["oracle_repo_ate_m"], out
rep = benchmark.main(["--frames", "2", "--device", "cpu"])
assert rep["frames"] == 2, rep
bad = sorted(m for m in sys.modules if m == "orbslam2_tpu"
             or m.startswith("orbslam2_tpu.")
             or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not bad, bad
print("BENCH_NOJAX_OK")
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


def test_drivers_run_without_jax_pil_or_cv2():
    """With jax, PIL and cv2 unimportable: every new module of the
    drivers imports, a KITTI layout written with ``utils/png.write_png`` is
    replayed by ``tools.replay.run_kitti_stereo`` on the CPU, and a
    ``StreamNode`` tracks the frames read back by the loader."""
    out = subprocess.run([sys.executable, "-c", _DRIVERS_CHILD], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "DRIVERS_NOJAX_OK" in out.stdout


def test_vocabulary_builds_without_jax():
    """With jax unimportable: a harvest (one real raster where matplotlib
    imports, one world seen once) and a k=5, levels=2 build on
    the CPU, then ``default_vocabulary`` builds, writes and reloads a
    missing tree."""
    out = subprocess.run([sys.executable, "-c", _VOCAB_CHILD], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "VOCAB_NOJAX_OK" in out.stdout


def test_parallel_runs_without_jax():
    """With jax unimportable: ``parallel/*`` and ``tools/scaling.py`` on a
    mesh of two CPU shards (see the module docstring)."""
    out = subprocess.run([sys.executable, "-c", _PARALLEL_CHILD], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PARALLEL_NOJAX_OK" in out.stdout


def test_scale_and_plot_tools_run_without_jax():
    """With jax unimportable: the map-scale circuit's module imports and
    builds its configuration, and the trajectory tool scores and plots
    (or writes a PLY of) two TUM files written by ``utils/trajectory``."""
    out = subprocess.run([sys.executable, "-c", _TOOLS_CHILD], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TOOLS_NOJAX_OK" in out.stdout
    assert "ATE RMSE: 0.0000 m over 40 matched poses" in out.stdout


def test_bench_tools_run_without_jax():
    """With jax and cv2 unimportable: ``tools/bench.py`` runs every leg at
    a small size on the CPU (the oracle's keys null for want of cv2) and
    ``tools/benchmark.py`` replays two synthetic frames."""
    out = subprocess.run([sys.executable, "-c", _BENCH_CHILD], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BENCH_NOJAX_OK" in out.stdout


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
