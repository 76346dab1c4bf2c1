"""The port's live drivers (``tools/live.py``) with callable sources.

Each driver of both packages (``tools/live/live.py`` for JAX) runs with
``System`` replaced by a recorder: the same constructor arguments, the
same ``track_*`` calls, the same savers and the same files (the T265
odometry log, the UWB fusion log, the UWB bias rows); ``main``'s ``ird``
subcommand over a recorded RealSense directory.  One ``run_ird_live`` of
the port runs end to end on the CPU, and ``open_source`` is the grab
tool's, copied."""

import importlib.util
import inspect
import io
import os
import sys

import numpy as np
import pytest
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.utils import sensors as jsensors
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.tools import live as tlive
from orbslam2_tpu_torch.utils import png, synthetic
from orbslam2_tpu_torch.utils import sensors as tsensors

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jlive():
    return _load(os.path.join(REPO, "tools", "live", "live.py"),
                 "_jax_live_drivers")


def _recorder(cfg_mod, log):
    class Recorder:
        def __init__(self, voc_file, settings_file, sensor=0,
                     use_viewer=False, save_map=False, replayer=False,
                     config=None, device=None):
            log.append(("System", settings_file, sensor, save_map,
                        replayer))
            self.cfg = cfg_mod.SlamConfig(sensor=sensor)
            self.n = 0

        def _track(self, kind, *args):
            log.append((kind,) + tuple(np.array(a) if isinstance(
                a, np.ndarray) else a for a in args))
            self.n += 1
            T = np.eye(4)
            T[:3, 3] = [0.1 * self.n, -0.05 * self.n, 0.3]
            return None if self.n == 2 else T

        def track_monocular(self, img, t):
            return self._track("mono", img, t)

        def track_rgbd(self, img, depth, t):
            return self._track("rgbd", img, depth, t)

        def save_trajectory_tum(self, path):
            log.append(("save_trajectory_tum", os.path.basename(path)))

        def shutdown(self):
            log.append(("shutdown",))

    return Recorder


def _assert_logs_equal(a, b):
    assert len(a) == len(b) > 2
    for x, y in zip(a, b):
        assert x[0] == y[0] and len(x) == len(y)
        for u, v in zip(x[1:], y[1:]):
            if isinstance(v, np.ndarray):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


def _mono_source(n=4):
    rng = np.random.default_rng(1)
    frames = [rng.uniform(0, 255, (24, 32)).astype(np.float32)
              for _ in range(n)]
    it = iter(enumerate(frames))

    def read():
        i, f = next(it, (None, None))
        return None if f is None else (f, 0.05 * i)
    return read


def _ird_source(n=4):
    rng = np.random.default_rng(2)
    frames = [(rng.uniform(0, 255, (24, 32)).astype(np.float32),
               rng.uniform(0.5, 9, (24, 32)).astype(np.float32))
              for _ in range(n)]
    it = iter(enumerate(frames))

    def grab():
        i, f = next(it, (None, None))
        return None if f is None else (f[0], f[1], 0.1 * i)
    return grab


ANCHORS = {1: np.array([0.0, 0.0, 0.0]), 2: np.array([5.0, 0.0, 10.0]),
           3: np.array([-5.0, 2.0, 20.0])}


@pytest.mark.parametrize("driver", ["mono", "ird", "ird_max2", "multicam",
                                    "uwb"])
def test_live_driver_equals_jax(driver, jlive, tmp_path, monkeypatch):
    logs = {}
    for name, mod, cfg in (("port", tlive, tconfig), ("jax", jlive,
                                                      jconfig)):
        log = logs[name] = []
        monkeypatch.setattr(mod, "System", _recorder(cfg, log))
        out = tmp_path / name
        out.mkdir()
        kw = {"device": "cpu"} if name == "port" else {}
        if driver == "mono":
            n = mod.run_mono_live(_mono_source(), "s.yaml",
                                  str(out / "traj.txt"), **kw)
        elif driver.startswith("ird"):
            n = mod.run_ird_live(_ird_source(), None, str(out / "traj.txt"),
                                 max_frames=2 if driver == "ird_max2"
                                 else None, save_map=False, **kw)
        elif driver == "multicam":
            poses = iter([np.eye(4) * (k + 1) for k in range(3)])
            n = mod.run_multicam(_ird_source(), lambda: next(poses, None),
                                 None, str(out / "d435i.txt"),
                                 str(out / "t265.txt"), **kw)
        else:
            n = mod.run_uwb(_ird_source(), None, ANCHORS,
                            str(out / "uwb.txt"), **kw)
        log.append(("frames", n))
    _assert_logs_equal(logs["port"], logs["jax"])
    for f in os.listdir(tmp_path / "jax"):
        assert ((tmp_path / "port" / f).read_text()
                == (tmp_path / "jax" / f).read_text()), f
    if driver == "uwb":
        lines = (tmp_path / "port" / "uwb.txt").read_text().splitlines()
        assert len(lines) == 3 and len(lines[0].split()) == 7


def test_uwb_bias_equals_jax(jlive):
    rows, outs = [], []
    for mod, sensors in ((tlive, tsensors), (jlive, jsensors)):
        node = sensors.UwbNode(node_id=0, anchors={1: np.zeros(3)},
                               noise_m=0.03, seed=7)
        buf = io.StringIO()
        rows.append(mod.run_uwb_bias(node, target_id=1,
                                     true_distances_cm=[100, 250, 400, -1,
                                                        999],
                                     n_measurements=50, out=buf))
        outs.append(buf.getvalue())
    assert rows[0] == rows[1] and outs[0] == outs[1]
    assert len(rows[0]) == 3
    for true_cm, avg_cm in rows[0]:
        assert abs(avg_cm - true_cm) < 3.0


def test_main_ird_equals_jax(jlive, tmp_path, monkeypatch, capsys):
    """``ird`` over a recorded RealSense (TUM-layout) directory."""
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rng = np.random.default_rng(3)
    rgb, dep = [], []
    for i in range(3):
        t = 5.0 + 0.1 * i
        png.write_png(str(tmp_path / f"rgb/{i}.png"),
                      rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
        png.write_png(str(tmp_path / f"depth/{i}.png"),
                      rng.integers(0, 9000, (12, 16), dtype=np.uint16))
        rgb.append(f"{t:.6f} rgb/{i}.png")
        dep.append(f"{t:.6f} depth/{i}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(dep) + "\n")
    logs, outs = {}, {}
    for name, mod, cfg in (("port", tlive, tconfig), ("jax", jlive,
                                                      jconfig)):
        log = logs[name] = []
        monkeypatch.setattr(mod, "System", _recorder(cfg, log))
        argv = ["ird", str(tmp_path), "--out", str(tmp_path / "t.txt")]
        if name == "port":
            mod.main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["live.py"] + argv)
            mod.main()
        outs[name] = capsys.readouterr().out
    _assert_logs_equal(logs["port"], logs["jax"])
    assert outs["port"] == outs["jax"] == "processed 3 frames\n"


def test_open_source_is_the_grab_tools():
    grab = _load(os.path.join(REPO, "tools", "grab", "grab.py"),
                 "_grab_tool")
    assert (inspect.getsource(tlive.open_source)
            == inspect.getsource(grab.open_source))
    src = _mono_source()
    assert tlive.open_source(src) is src


def test_run_ird_live_end_to_end_on_cpu(tmp_path):
    """The port's IRD driver over 5 synthetic RGB-D frames, a System on the
    CPU built from a settings file: every frame tracked, trajectory
    saved."""
    cam = tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                               bf=75.0, width=320, height=240, fps=10.0,
                               th_depth=60.0)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    frames = [synthetic.render_world(world, cam, T, rng, 1.0,
                                     with_depth=True)
              for T in synthetic.straight_trajectory(5, step=0.3)]
    (tmp_path / "s.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 225.0\nCamera.fy: 225.0\nCamera.cx: 160.0\n"
        "Camera.cy: 120.0\nCamera.bf: 75.0\nCamera.fps: 10.0\n"
        "Camera.width: 320\nCamera.height: 240\nThDepth: 60.0\n"
        "ORBextractor.nFeatures: 200\n")
    it = iter(enumerate(frames))

    def grab():
        i, f = next(it, (None, None))
        return None if f is None else (np.clip(f[0], 0, 255).astype(
            np.uint8), f[1], 0.1 * i)

    out = tmp_path / "traj.txt"
    n = tlive.run_ird_live(grab, str(tmp_path / "s.yaml"), str(out),
                           save_map=False, device="cpu")
    assert n == 5
    assert len(out.read_text().splitlines()) == 5
