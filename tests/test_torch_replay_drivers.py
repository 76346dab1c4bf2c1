"""The port's replay drivers (``tools/replay.py``) against the JAX
package's, on the same directories written here.

  * each ``run_*`` of both packages with ``System`` replaced by a recorder
    (monkeypatched in each ``replay`` module): the same constructor
    arguments (sensor, ``replayer``, ``save_map``), the same ``track_*``
    calls with bit-equal arrays and equal timestamps (the EuRoC pairs
    rectified through a distorted EuRoC-like calibration, the raw frames
    against cv2's reading), and the same saver;
  * ``replay``'s ``pace`` (``time.sleep`` patched) and ``log_every``
    lines;
  * each command-line subcommand against its ``tools/replay/*.py`` script
    on the same argv;
  * one ``run_kitti_stereo`` of the port on the CPU, end to end, over a
    KITTI layout written with ``utils/png.write_png``.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from orbslam2_tpu import config as jconfig  # noqa: E402
from orbslam2_tpu.tools import replay as jreplay  # noqa: E402
from orbslam2_tpu_torch import config as tconfig  # noqa: E402
from orbslam2_tpu_torch.tools import replay as treplay  # noqa: E402
from orbslam2_tpu_torch.utils import datasets as tds  # noqa: E402
from orbslam2_tpu_torch.utils import png, synthetic  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 96, 72, 5


def _gray(seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = 120 + 70 * np.sin(x / 5.0 + seed) * np.cos(y / 4.0) \
        + rng.normal(0, 8, (H, W))
    return np.clip(img, 0, 255).astype(np.uint8)


def _depth16(seed):
    return (1000 + 40 * _gray(seed).astype(np.uint16))


def _blocks():
    """Distorted LEFT./RIGHT. blocks shaped like EuRoC's, at W × H."""
    K = np.array([[95.0, 0.0, 47.3], [0.0, 94.6, 35.8], [0.0, 0.0, 1.0]])
    P = np.array([[80.0, 0.0, 48.0, 0.0], [0.0, 80.0, 36.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    c, s = np.cos(0.004), np.sin(0.004)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    out = {}
    for side, d in (("LEFT", [-0.2834, 0.0740, 1.94e-4, 1.76e-5, 0.0]),
                    ("RIGHT", [-0.2837, 0.0746, -1.04e-4, -3.56e-5, 0.0])):
        out.update({f"{side}.width": W, f"{side}.height": H,
                    f"{side}.K": K, f"{side}.D": np.array([d]),
                    f"{side}.R": R if side == "LEFT" else R.T,
                    f"{side}.P": P})
    return out


def _settings(path, depth_factor=True, blocks=None):
    lines = ["%YAML:1.0", "Camera.fx: 80.0", "Camera.fy: 80.0",
             "Camera.cx: 48.0", "Camera.cy: 36.0", "Camera.bf: 8.0",
             "Camera.fps: 20.0", f"Camera.width: {W}",
             f"Camera.height: {H}", "ThDepth: 40.0",
             "ORBextractor.nFeatures: 300"]
    if depth_factor:
        lines.append("DepthMapFactor: 1000.0")
    for k, v in (blocks or {}).items():
        if isinstance(v, np.ndarray):
            lines += [f"{k}: !!opencv-matrix", f"   rows: {v.shape[0]}",
                      f"   cols: {v.shape[1]}", "   dt: d",
                      "   data:[" + ", ".join(repr(float(x))
                                              for x in v.ravel()) + "]"]
        else:
            lines.append(f"{k}: {v}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Every driver's on-disk layout, N frames each."""
    root = tmp_path_factory.mktemp("layouts")
    out = {"root": root}
    kitti = root / "kitti"
    for cam in ("image_0", "image_1"):
        (kitti / cam).mkdir(parents=True)
        for i in range(N):
            cv2.imwrite(str(kitti / cam / f"{i:06d}.png"),
                        _gray(i + 10 * len(cam)))
    (kitti / "times.txt").write_text("".join(f"{0.05 * i:e}\n"
                                             for i in range(N)))
    tum = root / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    rgb, dep = [], []
    for i in range(N):
        t = 1305031102.175304 + 0.0333 * i
        g = _gray(i)
        Image.fromarray(np.stack([g, g // 2, 255 - g], -1)).save(
            tum / f"rgb/{t:.6f}.png")
        png.write_png(str(tum / f"depth/{t:.6f}.png"), _depth16(i))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.003:.6f} depth/{t:.6f}.png")
    (tum / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb) + "\n")
    (tum / "depth.txt").write_text("# depth\n" + "\n".join(dep) + "\n")
    euroc = root / "euroc"
    stamps = [str(1403636579763555584 + 50_000_000 * i) for i in range(N)]
    for k, cam in enumerate(("cam0", "cam1")):
        (euroc / cam / "data").mkdir(parents=True)
        for i, s in enumerate(stamps):
            cv2.imwrite(str(euroc / cam / "data" / f"{s}.png"),
                        _gray(100 + i + k))
    (euroc / "times.txt").write_text("\n".join(stamps[1:]) + "\n")
    isl = root / "isl"
    (isl / "l").mkdir(parents=True)
    (isl / "r").mkdir()
    isl_stamps = [str(1400000000000000000 + i * 100_000_000)
                  for i in range(N)]
    for i, s in enumerate(isl_stamps):
        cv2.imwrite(str(isl / "l" / f"{s}_left.jpg"), _gray(200 + i))
        cv2.imwrite(str(isl / "r" / f"{s}_right.jpg"), _gray(300 + i))
    (isl / "t.txt").write_text("\n".join(isl_stamps) + "\n")
    ird = root / "ird"
    (ird / "infrared").mkdir(parents=True)
    (ird / "depth").mkdir()
    for i in range(N + 2):
        t = 1000.0 + 0.1 * i
        cv2.imwrite(str(ird / "infrared" / f"{t:.6f}.png"), _gray(400 + i))
        cv2.imwrite(str(ird / "depth" / f"{t:.6f}.png"),
                    _depth16(400 + i)[::2, ::2])
    out["settings"] = _settings(root / "s.yaml")
    out["settings_raw"] = _settings(root / "raw.yaml", depth_factor=False)
    out["settings_euroc"] = _settings(root / "euroc.yaml",
                                      blocks=_blocks())
    return out


def _recorder(cfg_mod, log):
    class Recorder:
        def __init__(self, voc_file, settings_file, sensor=0,
                     use_viewer=False, save_map=False, replayer=False,
                     config=None, device=None):
            log.append(("System", voc_file, settings_file, sensor,
                        use_viewer, save_map, replayer))
            self.cfg = cfg_mod.SlamConfig.from_yaml(settings_file, sensor) \
                if settings_file else cfg_mod.SlamConfig(sensor=sensor)
            self.device = torch.device("cpu")

        def _track(self, kind, *args):
            log.append((kind,) + tuple(np.array(a, copy=True)
                                       if isinstance(a, np.ndarray) else a
                                       for a in args))
            return np.eye(4)

        def track_stereo(self, left, right, t):
            return self._track("stereo", left, right, t)

        def track_rgbd(self, img, depth, t):
            return self._track("rgbd", img, depth, t)

        def track_monocular(self, img, t):
            return self._track("mono", img, t)

        def save_trajectory_tum(self, path):
            log.append(("save_trajectory_tum", path))

        def save_trajectory_kitti(self, path):
            log.append(("save_trajectory_kitti", path))

        def save_keyframe_trajectory_tum(self, path):
            log.append(("save_keyframe_trajectory_tum", path))

        def shutdown(self):
            log.append(("shutdown",))

    return Recorder


def _assert_logs_equal(got, want):
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert len(g) == len(w) and g[0] == w[0], (g[0], w[0])
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert type(a) is type(b) and a == b, (g[0], a, b)


def _driver_args(case, lay, out):
    root = lay["root"]
    s, raw, se = lay["settings"], lay["settings_raw"], lay["settings_euroc"]
    return {
        "kitti_stereo": ("run_kitti_stereo", (str(root / "kitti"), s, out,
                                              None, False)),
        "kitti_stereo_max3": ("run_kitti_stereo", (str(root / "kitti"), s,
                                                   out, 3, False)),
        "tum_rgbd": ("run_tum_rgbd", (str(root / "tum"), s, out)),
        "tum_mono": ("run_tum_mono", (str(root / "tum"), s, out, 4)),
        "euroc_stereo": ("run_euroc_stereo", (str(root / "euroc"), se, None,
                                              out)),
        "euroc_stereo_times": ("run_euroc_stereo", (
            str(root / "euroc"), se, str(root / "euroc" / "times.txt"),
            out, 3)),
        "euroc_stereo_unrectified": ("run_euroc_stereo",
                                     (str(root / "euroc"), s, None, out)),
        "kitti_mono": ("run_kitti_mono", (str(root / "kitti"), s, out)),
        "euroc_mono": ("run_euroc_mono", (str(root / "euroc"), s,
                                          str(root / "euroc" / "times.txt"),
                                          out)),
        "isl_stereo": ("run_isl_stereo", (str(root / "isl" / "l"),
                                          str(root / "isl" / "r"),
                                          str(root / "isl" / "t.txt"), s,
                                          out)),
        "ird_realsense": ("run_ird_realsense", (str(root / "ird"), s, out)),
        "ird_realsense_raw_units": ("run_ird_realsense",
                                    (str(root / "ird"), raw, out, 3, "png",
                                     False)),
    }[case]


@pytest.mark.parametrize("case", [
    "kitti_stereo", "kitti_stereo_max3", "tum_rgbd", "tum_mono",
    "euroc_stereo", "euroc_stereo_times", "euroc_stereo_unrectified",
    "kitti_mono", "euroc_mono", "isl_stereo", "ird_realsense",
    "ird_realsense_raw_units"])
def test_driver_hands_system_what_jax_does(case, layouts, monkeypatch):
    tlog, jlog = [], []
    monkeypatch.setattr(treplay, "System", _recorder(tconfig, tlog))
    monkeypatch.setattr(jreplay, "System", _recorder(jconfig, jlog))
    name, args = _driver_args(case, layouts, "traj.txt")
    trep = getattr(treplay, name)(*args, device="cpu")
    jrep = getattr(jreplay, name)(*args)
    _assert_logs_equal(tlog, jlog)
    assert (trep.n_frames, trep.n_tracked) == (jrep.n_frames, jrep.n_tracked)
    assert len(trep.durations_ms) == len(jrep.durations_ms)
    if case == "ird_realsense_raw_units":
        # no DepthMapFactor: parsed as 1.0, so `or 1000.0` never applies
        # and depth stays in the file's raw units in both packages
        raw = tds._imread_depth(sorted(
            (layouts["root"] / "ird" / "depth").iterdir())[2], 1.0)
        ys = np.arange(H) * raw.shape[0] // H
        xs = np.arange(W) * raw.shape[1] // W
        np.testing.assert_array_equal(tlog[1][2], raw[np.ix_(ys, xs)])
    if case.startswith("euroc_stereo") and case != "euroc_stereo_unrectified":
        # the raw frames read as cv2 reads them; the rectified ones differ
        stamp = sorted(os.listdir(layouts["root"] / "euroc" / "cam0" /
                                  "data"))[0]
        raw = cv2.imread(str(layouts["root"] / "euroc" / "cam0" / "data" /
                             stamp), cv2.IMREAD_GRAYSCALE)
        got = next(tds.iter_euroc_stereo(str(layouts["root"] / "euroc")))
        np.testing.assert_array_equal(got[0], raw.astype(np.float32))
        first = tlog[1] if case == "euroc_stereo" else None
        if first is not None:
            assert not np.array_equal(first[1], raw.astype(np.float32))


def test_qrcode_replay_equals_jax(tmp_path):
    try:
        qr = cv2.QRCodeEncoder_create().encode("orbslam2")
    except Exception:
        pytest.skip("no QR encoder in this cv2 build")
    canvas = np.full((300, 300), 255, np.uint8)
    canvas[50:250, 50:250] = cv2.resize(qr, (200, 200),
                                        interpolation=cv2.INTER_NEAREST)
    img = str(tmp_path / "qr.png")
    cv2.imwrite(img, canvas)
    t = treplay.run_qrcode_replay([img], str(tmp_path / "t.txt"))
    j = jreplay.run_qrcode_replay([img], str(tmp_path / "j.txt"))
    assert t.available == j.available
    if j.available:
        assert ((tmp_path / "t.txt").read_text()
                == (tmp_path / "j.txt").read_text())
        assert ([m.payload for m in t.detect(canvas.astype(np.float32))]
                == [m.payload for m in j.detect(canvas.astype(np.float32))])


class _Timer:
    def __init__(self):
        self.ms = iter([7.25, 12.0, 9.5, 30.0, 8.0, 11.0])

    def start(self):
        pass

    def stop(self):
        return next(self.ms)


class _FakeSystem:
    device = torch.device("cpu")

    def track_stereo(self, left, right, t):
        return None if t > 2.0 else np.eye(4)


def test_pace_and_log_every_equal_jax(monkeypatch, capsys):
    sleeps = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    stamps = [0.0, 0.1, 0.5, 3.0, 2.9, 3.05]
    frames = [(None, None, t) for t in stamps]
    out = {}
    for name, mod in (("port", treplay), ("jax", jreplay)):
        monkeypatch.setattr(mod, "StageTimer", _Timer)
        del sleeps[:]
        rep = mod.replay(_FakeSystem(), frames, "stereo", pace=True,
                         log_every=2)
        out[name] = (rep.n_frames, rep.n_tracked, rep.durations_ms,
                     list(sleeps), capsys.readouterr().err)
    assert out["port"] == out["jax"]
    assert out["port"][3] == pytest.approx([0.1, 0.4, 0.15])
    assert out["port"][4].count("SLAM.Track duration:") == 3


CLI = [
    ("stereo_kitti", ["seq", "s.yaml", "--max-frames", "7", "--pace"],
     "run_kitti_stereo"),
    ("rgbd_tum", ["seq", "--out", "o.txt"], "run_tum_rgbd"),
    ("mono_tum", ["seq", "s.yaml"], "run_tum_mono"),
    ("stereo_euroc", ["mav", "s.yaml", "--timestamps", "t.txt", "--pace"],
     "run_euroc_stereo"),
    ("mono_kitti", ["seq", "s.yaml", "--max-frames", "3"],
     "run_kitti_mono"),
    ("mono_euroc", ["mav", "--timestamps", "t.txt"], "run_euroc_mono"),
    ("stereo_isl", ["l", "r", "t.txt", "s.yaml", "--out", "x.txt"],
     "run_isl_stereo"),
    ("ird_realsense", ["seq", "s.yaml", "--depth-ext", "raw",
                       "--no-save-map"], "run_ird_realsense"),
    ("qrcode_replay", ["a.png", "b.png", "--out", "q.txt"],
     "run_qrcode_replay"),
]


@pytest.mark.parametrize("name,argv,fn", CLI, ids=[c[0] for c in CLI])
def test_cli_subcommand_equals_script(name, argv, fn, monkeypatch, capsys):
    calls = {}

    def recorder(tag, mod):
        def run(*args, **kwargs):
            calls[tag] = (args, kwargs)
            if fn == "run_qrcode_replay":
                return object()
            rep = mod.ReplayReport(n_frames=3, n_tracked=2,
                                   durations_ms=[4.0, 6.0])
            return rep
        return run

    monkeypatch.setattr(treplay, fn, recorder("port", treplay))
    monkeypatch.setattr(jreplay, fn, recorder("jax", jreplay))
    spec = importlib.util.spec_from_file_location(
        f"_replay_script_{name}", os.path.join(REPO, "tools", "replay",
                                               f"{name}.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    script.main()
    jout = capsys.readouterr().out
    extra = [] if name == "qrcode_replay" else ["--device", "cpu"]
    treplay.main([name] + argv + extra)
    tout = capsys.readouterr().out
    (targs, tkw), (jargs, jkw) = calls["port"], calls["jax"]
    assert targs == jargs
    assert tkw == dict(jkw, **({"device": "cpu"} if extra else {}))
    assert tout == jout


def test_run_kitti_stereo_end_to_end_on_cpu(tmp_path):
    """The port's KITTI driver over 8 frames written with write_png, at
    320×240 and 200 features: every frame tracked, and the saved KITTI
    trajectory within 0.15 m of the truth."""
    cam = tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                               bf=75.0, width=320, height=240, fps=10.0,
                               th_depth=60.0)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(8, step=0.3)
    for cam_dir in ("image_0", "image_1"):
        (tmp_path / cam_dir).mkdir()
    for i, T in enumerate(poses):
        for cam_dir, img in zip(("image_0", "image_1"),
                                synthetic.render_world_stereo(world, cam, T,
                                                              rng, 1.0)):
            png.write_png(str(tmp_path / cam_dir / f"{i:06d}.png"),
                          np.clip(img, 0, 255).astype(np.uint8))
    (tmp_path / "times.txt").write_text("".join(f"{0.1 * i:e}\n"
                                                for i in range(8)))
    (tmp_path / "s.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 225.0\nCamera.fy: 225.0\nCamera.cx: 160.0\n"
        "Camera.cy: 120.0\nCamera.bf: 75.0\nCamera.fps: 10.0\n"
        "Camera.width: 320\nCamera.height: 240\nThDepth: 60.0\n"
        "ORBextractor.nFeatures: 200\n")
    traj = tmp_path / "traj.txt"
    rep = treplay.run_kitti_stereo(str(tmp_path), str(tmp_path / "s.yaml"),
                                   str(traj), device="cpu")
    assert rep.n_frames == rep.n_tracked == 8
    assert len(rep.durations_ms) == 6
    m = np.loadtxt(traj)
    gt = np.array([-T[:3, :3].T @ T[:3, 3] for T in poses])
    err = np.sqrt(np.mean(np.sum((m[:, [3, 7, 11]] - gt) ** 2, axis=1)))
    assert m.shape == (8, 12) and err < 0.15, err
