"""The port's ROS adapters (``runtime/ros_node.py``), AR demo
(``utils/ar.py``), markers and sensors against the JAX package's.

  * ``decode_image_msg`` bit-equal to JAX's for every encoding, with and
    without row padding;
  * the mono, stereo (rectified and not), RGB-D and mono-AR nodes' callbacks
    with a stand-in ``System``: the same calls as JAX's nodes make;
  * ``detect_plane`` against JAX's with JAX's draws passed as ``idx=``, at
    an even count of candidates, where ``jnp.nanmedian`` averages the two
    middle distances (``torch.nanmedian`` would take the lower one and
    change the inlier set, hence the origin), with ties between equal
    hypotheses (the first wins); the generator's own draws on the plane
    scene of tests/test_extras.py;
  * ``plane_frame`` and ``draw_cube`` against JAX's on the same pose;
  * the markers and sensors cases of tests/test_extras.py on the port, and
    ``RealSenseDevice``'s replay against JAX's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.runtime import ros_node as jros
from orbslam2_tpu.utils import ar as jar
from orbslam2_tpu.utils import sensors as jsensors
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.runtime import ros_node as tros
from orbslam2_tpu_torch.utils import ar as tar
from orbslam2_tpu_torch.utils import png
from orbslam2_tpu_torch.utils import sensors as tsensors
from orbslam2_tpu_torch.utils.markers import (ArucoCodeScanner, Marker,
                                              QrCodeTracker)

torch.set_num_threads(2)

ENCODINGS = ["mono8", "8UC1", "rgb8", "bgr8", "mono16", "16UC1", "32FC1"]


def _msg(img, encoding, t, pad=0, as_list=False):
    """Duck-typed sensor_msgs/Image, rows padded by ``pad`` bytes."""
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    raw = np.hstack([raw, np.full((h, pad), 7, np.uint8)])
    stamp = types.SimpleNamespace(secs=int(t), nsecs=int(round((t % 1)
                                                               * 1e9)))
    data = raw.reshape(-1).tolist() if as_list else raw.tobytes()
    return types.SimpleNamespace(height=h, width=w, encoding=encoding,
                                 data=data, step=raw.shape[1],
                                 header=types.SimpleNamespace(stamp=stamp))


def _img(encoding, rng, h=9, w=7):
    if encoding in ("rgb8", "bgr8"):
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if encoding in ("mono16", "16UC1"):
        return rng.integers(0, 65536, (h, w), dtype=np.uint16)
    if encoding == "32FC1":
        return rng.uniform(0, 9, (h, w)).astype(np.float32)
    return rng.integers(0, 256, (h, w), dtype=np.uint8)


@pytest.mark.parametrize("pad", [0, 5])
@pytest.mark.parametrize("encoding", ENCODINGS)
def test_decode_image_msg_equals_jax(encoding, pad):
    rng = np.random.default_rng(len(encoding) + pad)
    msg = _msg(_img(encoding, rng), encoding, 1.25, pad=pad,
               as_list=(pad == 5 and encoding == "mono8"))
    got, want = tros.decode_image_msg(msg), jros.decode_image_msg(msg)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_decode_unknown_encoding_raises_alike():
    msg = _msg(np.zeros((2, 2), np.uint8), "yuv422", 0.0)
    for mod in (tros, jros):
        with pytest.raises(ValueError, match="yuv422"):
            mod.decode_image_msg(msg)


class _StandIn:
    """Records what a node hands its System."""

    def __init__(self, cfg_mod, sensor, depth_factor=1.0):
        self.cfg = cfg_mod.SlamConfig(sensor=sensor).replace(
            camera=cfg_mod.CameraConfig(depth_map_factor=depth_factor))
        self.device = torch.device("cpu")
        self.calls = []

    def _rec(self, kind, *args):
        self.calls.append((kind,) + tuple(np.array(a) if isinstance(
            a, np.ndarray) else a for a in args))
        return np.eye(4)

    def track_monocular(self, img, t):
        return self._rec("mono", img, t)

    def track_stereo(self, left, right, t):
        return self._rec("stereo", left, right, t)

    def track_rgbd(self, img, depth, t):
        return self._rec("rgbd", img, depth, t)


def _assert_calls_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[0] == y[0] and len(x) == len(y)
        for u, v in zip(x[1:], y[1:]):
            if isinstance(v, np.ndarray):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


def _euroc_like_yaml(path, w=48, h=36):
    K = np.array([[46.0, 0.0, 23.6], [0.0, 45.7, 17.9], [0.0, 0.0, 1.0]])
    P = np.array([[40.0, 0.0, 24.0, 0.0], [0.0, 40.0, 18.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    lines = ["%YAML:1.0", "Camera.fx: 40.0"]
    for side in ("LEFT", "RIGHT"):
        lines += [f"{side}.width: {w}", f"{side}.height: {h}"]
        for k, v in (("K", K), ("D", np.array([[-0.28, 0.07, 2e-4, 1e-5,
                                                 0.0]])),
                     ("R", np.eye(3)), ("P", P)):
            lines += [f"{side}.{k}: !!opencv-matrix",
                      f"   rows: {v.shape[0]}", f"   cols: {v.shape[1]}",
                      "   dt: d", "   data:[" + ", ".join(
                          repr(float(x)) for x in v.ravel()) + "]"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("node", ["mono", "stereo", "stereo_rectified",
                                  "rgbd_16UC1", "rgbd_32FC1"])
def test_ros_callbacks_equal_jax(node, tmp_path):
    rng = np.random.default_rng(4)
    settings = _euroc_like_yaml(tmp_path / "s.yaml")
    stand_ins = {}
    for name, ros, cfg in (("port", tros, tconfig), ("jax", jros, jconfig)):
        if node == "mono":
            s = _StandIn(cfg, cfg.MONOCULAR)
            n = ros.RosMonoNode(s)
        elif node.startswith("stereo"):
            s = _StandIn(cfg, cfg.STEREO)
            n = ros.RosStereoNode(s, do_rectify=node.endswith("rectified"),
                                  settings_file=settings)
        else:
            s = _StandIn(cfg, cfg.RGBD, depth_factor=1000.0)
            n = ros.RosRgbdNode(s)
        stand_ins[name] = (s, n)
    for i in range(3):
        t = 100.0 + 0.05 * i
        left = _msg(_img("mono8", rng, 36, 48), "mono8", t)
        right = _msg(_img("bgr8", rng, 36, 48), "bgr8", t)
        enc = node.split("_")[-1]
        depth = _msg(_img(enc, rng, 36, 48), enc, t) \
            if node.startswith("rgbd") else None
        for s, n in stand_ins.values():
            if node == "mono":
                n.callback(left)
            elif node.startswith("stereo"):
                n.callback(left, right)
            else:
                n.callback(right, depth)
    _assert_calls_equal(stand_ins["port"][0].calls,
                        stand_ins["jax"][0].calls)


def test_stereo_node_without_blocks_refuses_alike(tmp_path):
    plain = tmp_path / "p.yaml"
    plain.write_text("%YAML:1.0\nCamera.fx: 40.0\n")
    for ros, cfg in ((tros, tconfig), (jros, jconfig)):
        with pytest.raises(ValueError, match="LEFT"):
            ros.RosStereoNode(_StandIn(cfg, cfg.STEREO), do_rectify=True,
                              settings_file=str(plain))


def _plane_scene(rng, n_on=200, n_off=60):
    """tests/test_extras.py's map: points on y = 2 (+5 mm noise) and off
    it, all candidates."""
    on = np.stack([rng.uniform(-5, 5, n_on),
                   np.full(n_on, 2.0) + rng.normal(0, 0.005, n_on),
                   rng.uniform(5, 25, n_on)], -1)
    off = np.stack([rng.uniform(-5, 5, n_off), rng.uniform(-3, 1.5, n_off),
                    rng.uniform(5, 25, n_off)], -1)
    pts = np.concatenate([on, off]).astype(np.float32)
    return pts, np.ones(len(pts), bool), np.full(len(pts), 8, np.int32)


def _even_scene():
    """50 candidates (an even count): 24 exactly on y = 2 and 26 off it by
    0.003 + 0.01 k.  A hypothesis of three on-plane points sees the
    distances 0 (×24), 0.013, 0.023, ...: jnp.nanmedian gives 0.018 (the
    mean of the middle two), so its inliers (< 0.072) include the points
    at 0.053 and 0.063; torch.nanmedian's 0.013 (< 0.052) does not.  Ten
    more points are not candidates (invalid, or seen ≤ 5 times)."""
    rng = np.random.default_rng(11)
    off = (0.003 + 0.01 * np.arange(1, 27)) * np.where(np.arange(26) % 2,
                                                       1.0, -1.0)
    ys = np.concatenate([np.full(24, 2.0), 2.0 + off, np.full(10, 2.0)])
    pts = np.stack([rng.uniform(-4, 4, 60), ys, rng.uniform(6, 20, 60)],
                   -1).astype(np.float32)
    valid = np.ones(60, bool)
    valid[50:55] = False
    n_obs = np.full(60, 8, np.int32)
    n_obs[55:] = 3
    return pts, valid, n_obs


def _jax_draws(valid, n_obs, key, P, H=64):
    cand = valid & (n_obs > 5)
    p = jnp.asarray(cand.astype(np.float32))
    p = p / jnp.clip(jnp.sum(p), 1.0, None)
    return np.array(jax.random.choice(key, P, shape=(H, 3), replace=True,
                                      p=p))


@pytest.mark.parametrize("scene", ["even_candidates", "test_extras_plane"])
def test_detect_plane_equals_jax_on_its_draws(scene):
    if scene == "even_candidates":
        pts, valid, n_obs = _even_scene()
        key = jax.random.PRNGKey(3)
    else:
        pts, valid, n_obs = _plane_scene(np.random.default_rng(0))
        key = jax.random.PRNGKey(0)
    cand = valid & (n_obs > 5)
    if scene == "even_candidates":
        assert cand.sum() == 50
    fj = jar.detect_plane(jnp.asarray(pts), jnp.asarray(valid),
                          jnp.asarray(n_obs), key)
    idx = _jax_draws(valid, n_obs, key, len(pts))
    ft = tar.detect_plane(torch.from_numpy(pts), torch.from_numpy(valid),
                          torch.from_numpy(n_obs),
                          idx=torch.from_numpy(idx))
    assert bool(ft.ok) == bool(fj.ok) is True
    np.testing.assert_array_equal(ft.n.numpy(), np.asarray(fj.n))
    np.testing.assert_allclose(float(ft.d), float(fj.d), atol=1e-6)
    np.testing.assert_allclose(ft.origin.numpy(), np.asarray(fj.origin),
                               atol=1e-5)
    if scene == "even_candidates":
        # the inliers are the 24 exact points and the 6 nearest off it
        mean_y = np.mean(np.concatenate([np.full(24, 2.0),
                                         pts[24:50, 1][np.argsort(np.abs(
                                             pts[24:50, 1] - 2.0))[:6]]]))
        assert abs(float(ft.origin[1]) - mean_y) < 1e-5


def test_detect_plane_generator_draws_find_the_plane():
    pts, valid, n_obs = _plane_scene(np.random.default_rng(0))
    gen = torch.Generator().manual_seed(5)
    fit = tar.detect_plane(torch.from_numpy(pts), torch.from_numpy(valid),
                           torch.from_numpy(n_obs), gen)
    assert bool(fit.ok)
    assert abs(abs(float(fit.n[1])) - 1.0) < 0.02
    assert abs(abs(float(fit.d)) - 2.0) < 0.1
    few = tar.detect_plane(torch.from_numpy(pts), torch.from_numpy(valid),
                           torch.from_numpy(np.zeros(len(pts), np.int32)),
                           gen)                   # no candidate at all
    assert not bool(few.ok)


@pytest.mark.parametrize("up_hint", [None, (0.0, -1.0, 0.0)])
def test_plane_frame_and_draw_cube_equal_jax(up_hint):
    pts, valid, n_obs = _plane_scene(np.random.default_rng(1))
    fj = jar.detect_plane(jnp.asarray(pts), jnp.asarray(valid),
                          jnp.asarray(n_obs), jax.random.PRNGKey(1))
    ft = tar.PlaneFit(ok=torch.tensor(True),
                      n=torch.from_numpy(np.asarray(fj.n)),
                      d=torch.tensor(float(fj.d)),
                      origin=torch.from_numpy(np.asarray(fj.origin)))
    hint = None if up_hint is None else np.array(up_hint)
    Twp_t, Twp_j = tar.plane_frame(ft, hint), jar.plane_frame(fj, hint)
    np.testing.assert_array_equal(Twp_t, Twp_j)
    kw = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0, width=640,
              height=480)
    frame = np.random.default_rng(2).uniform(0, 200, (480, 640)).astype(
        np.float32)
    for size in (0.5, 2.0):
        a = tar.draw_cube(frame, tconfig.CameraConfig(**kw), np.eye(4),
                          Twp_t, size=size)
        b = jar.draw_cube(frame, jconfig.CameraConfig(**kw), np.eye(4),
                          Twp_j, size=size)
        np.testing.assert_array_equal(a, b)
        assert (a == 255.0).sum() > 50


def test_mono_ar_node_inserts_and_renders_a_cube():
    """RosMonoARNode over a stand-in System whose engine holds the plane
    map: Insert Cube finds the plane (draws from the engine's device's
    generator), every callback publishes the annotated frame, Clear All
    drops the cubes."""
    pts, valid, n_obs = _plane_scene(np.random.default_rng(0))
    s = _StandIn(tconfig, tconfig.MONOCULAR)
    s.cfg = s.cfg.replace(camera=tconfig.CameraConfig(
        fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480))
    s.engine = types.SimpleNamespace(
        cfg=s.cfg, device=torch.device("cpu"),
        ms=types.SimpleNamespace(mp_pos=torch.from_numpy(pts),
                                 mp_valid=torch.from_numpy(valid),
                                 mp_n_obs=torch.from_numpy(n_obs)))
    published = []
    node = tros.RosMonoARNode(s, cube_size=0.5,
                              publish_fn=published.append)
    frame = np.zeros((480, 640), np.uint8)
    out = node.callback(_msg(frame, "mono8", 0.0))
    assert (out == 255.0).sum() == 0
    assert node.insert_cube() and len(node.demo.planes) == 1
    assert abs(node.demo.planes[0][1, 3] - 2.0) < 0.2
    out = node.callback(_msg(frame, "mono8", 0.1))
    assert (out == 255.0).sum() > 50 and node.last_ar_frame is out
    node.clear_cubes()
    assert (node.callback(_msg(frame, "mono8", 0.2)) == 255.0).sum() == 0
    assert len(published) == 3


# ------------------------------------------- markers and sensors (extras)
def test_qr_tracker_roundtrip(tmp_path):
    t = QrCodeTracker()
    m = Marker(payload="hello", corners=np.zeros((4, 2), np.float32),
               position=np.array([1.0, 2.0, 3.0]))
    t.landmarks.append(m)
    p = tmp_path / "QRCodes.txt"
    t.save(str(p))
    t2 = QrCodeTracker()
    t2.load(str(p))
    assert len(t2.landmarks) == 1
    assert t2.landmarks[0].payload == "hello"
    np.testing.assert_allclose(t2.landmarks[0].position, [1, 2, 3])


def test_qr_detect_if_cv2():
    cv2 = pytest.importorskip("cv2")
    t = QrCodeTracker()
    if not t.available:
        pytest.skip("no QRCodeDetector")
    try:
        qr = cv2.QRCodeEncoder_create().encode("orbslam2_tpu")
    except Exception:
        pytest.skip("no QR encoder in this cv2 build")
    img = cv2.resize(qr, (240, 240), interpolation=cv2.INTER_NEAREST)
    canvas = np.full((400, 400), 255, np.uint8)
    canvas[80:320, 80:320] = img
    found = t.track(canvas.astype(np.float32), np.eye(4))
    assert any(m.payload == "orbslam2_tpu" for m in found)
    assert len(t.landmarks) == 1


def test_uwb_simulation():
    node = tsensors.UwbNode(anchors={1: [0, 0, 0], 2: [10, 0, 0]},
                            noise_m=0.0)
    rs = node.multi_range_with(np.array([5.0, 0.0, 0.0]))
    d = {r.node_id: r.distance_m for r in rs}
    assert abs(d[1] - 5.0) < 1e-6 and abs(d[2] - 5.0) < 1e-6
    assert len(node.neighbor_table()) == 2


def test_realsense_requires_backend():
    dev = tsensors.RealSenseDevice(tsensors.Modality.IRD)
    with pytest.raises(RuntimeError):
        dev.start()
    dev.set_laser(False)
    assert dev.laser_on is False


def test_aruco_scanner_graceful():
    s = ArucoCodeScanner(valid_ids=[1, 2, 3])
    out = s.scan(np.zeros((64, 64), np.float32)) if s.available else []
    assert isinstance(out, list)


def test_realsense_replay_equals_jax(tmp_path):
    """The recorded-sequence backend reads a TUM layout through each
    package's loader: the same frames, then None at the end."""
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rng = np.random.default_rng(8)
    rgb, dep = [], []
    for i in range(3):
        t = 10.0 + 0.04 * i
        Image.fromarray(rng.integers(0, 256, (12, 16, 3),
                                     dtype=np.uint8)).save(
            tmp_path / f"rgb/{i}.png")
        png.write_png(str(tmp_path / f"depth/{i}.png"),
                      rng.integers(0, 9000, (12, 16), dtype=np.uint16))
        rgb.append(f"{t:.6f} rgb/{i}.png")
        dep.append(f"{t + 0.001:.6f} depth/{i}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(dep) + "\n")
    devs = [mod.RealSenseDevice(mod.Modality.RGBD,
                                replay_dir=str(tmp_path))
            for mod in (tsensors, jsensors)]
    for d in devs:
        d.start()
    for _ in range(3):
        a, b = (d.grab() for d in devs)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert devs[0].grab() is None and devs[1].grab() is None
