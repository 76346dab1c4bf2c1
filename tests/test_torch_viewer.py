"""The port's viewers (``utils/viewer.py``, ``utils/live_viewer.py``) and
the engine accessors they read.

``save_ply``, ``save_map_html``, ``draw_keypoints_png``,
``export_engine_state`` and ``LiveViewer.state()`` against the JAX
package's on the same map: a port engine's map on the CPU, handed to the
JAX functions through ``orbslam2_tpu_torch.convert`` (no JAX engine runs).
``frame_overlay`` on both port engines (``SlamEngine`` and
``WindowedSlamEngine``: the last retired window's final row), and the live
viewer's HTTP endpoints over a port ``System``.
"""

import json
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.utils import live_viewer as jlive
from orbslam2_tpu.utils import viewer as jviewer
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.config import (CameraConfig, CapacityConfig,
                                       OrbConfig, STEREO, SlamConfig)
from orbslam2_tpu_torch.runtime import tracking
from orbslam2_tpu_torch.runtime.slam import SlamEngine
from orbslam2_tpu_torch.runtime.system import System
from orbslam2_tpu_torch.runtime.windowed import WindowedSlamEngine
from orbslam2_tpu_torch.utils import live_viewer as tlive
from orbslam2_tpu_torch.utils import png, synthetic
from orbslam2_tpu_torch.utils import viewer as tviewer

torch.set_num_threads(2)

CFG = SlamConfig(
    camera=CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=75.0,
                        width=320, height=240, fps=10.0, th_depth=60.0),
    orb=OrbConfig(n_features=200),
    capacity=CapacityConfig(max_keyframes=8, max_map_points=2048,
                            local_ba_keyframes=4, local_ba_points=512),
    sensor=STEREO)


def _frames(n=6):
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    return [synthetic.render_world_stereo(world, CFG.camera, T, rng, 1.0)
            for T in synthetic.straight_trajectory(n, step=0.3)]


@pytest.fixture(scope="module")
def engine():
    eng = SlamEngine(CFG, enable_loop_closing=False, device="cpu")
    for i, (left, right) in enumerate(_frames()):
        assert eng.track_stereo(left, right, 0.1 * i) is not None
    return eng


def _jax_twin(eng):
    """A stand-in JAX engine holding the same map and outputs."""
    d = convert.to_numpy(eng.ms)
    ms = jms.MapState(**{k: jnp.asarray(d[k]) for k in jms.MapState._fields})
    pts, poses = eng.map_points(), eng.frame_poses()
    return types.SimpleNamespace(
        ms=ms, map_points=lambda: pts, frame_poses=lambda: poses,
        last_Tcw=eng.last_Tcw, state=eng.state, n_kfs=eng.n_kfs,
        stats=dict(eng.stats), localization_only=eng.localization_only)


def test_ply_and_html_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    traj = rng.normal(size=(10, 3))
    for mod, tag in ((tviewer, "t"), (jviewer, "j")):
        mod.save_ply(str(tmp_path / f"{tag}.ply"), pts)
        mod.save_ply(str(tmp_path / f"{tag}c.ply"), pts, colors)
        mod.save_map_html(str(tmp_path / f"{tag}.html"), pts, traj, pts[:3])
    for ext in (".ply", "c.ply", ".html"):
        assert ((tmp_path / f"t{ext}").read_text()
                == (tmp_path / f"j{ext}").read_text())
    assert "element vertex 50" in (tmp_path / "t.ply").read_text()


def test_keypoint_png_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    xy = rng.uniform(5, 55, (12, 2))
    for mod, tag in ((tviewer, "t"), (jviewer, "j")):
        mod.draw_keypoints_png(str(tmp_path / f"{tag}.png"), img, xy,
                               matched=np.arange(12) % 2 == 0,
                               state_text="OK | 12 pts")
    assert ((tmp_path / "t.png").read_bytes()
            == (tmp_path / "j.png").read_bytes())
    assert png.read_png(str(tmp_path / "t.png")).shape == (60, 80, 3)


def test_export_engine_state_equals_jax(engine, tmp_path):
    tviewer.export_engine_state(engine, str(tmp_path / "t"))
    jviewer.export_engine_state(_jax_twin(engine), str(tmp_path / "j"))
    for name in ("map.ply", "map.html"):
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())
    assert f"element vertex {len(engine.map_points())}" in \
        (tmp_path / "t" / "map.ply").read_text()


@pytest.mark.parametrize("max_points", [4000, 50])
def test_live_viewer_state_equals_jax(engine, max_points):
    got = tlive.LiveViewer(engine, max_points=max_points).state()
    want = jlive.LiveViewer(_jax_twin(engine),
                            max_points=max_points).state()
    assert got == want
    assert got["n_kfs"] >= 1 and got["camera"] is not None
    assert len(got["points"]) <= max_points


def _decoded_overlay(eng):
    data = eng.frame_overlay()
    assert data[:8] == png.SIGNATURE
    img = png.decode_png(data)
    assert img.shape == (CFG.camera.height, CFG.camera.width, 3)
    green = np.all(img == np.array([0, 255, 0], np.uint8), axis=-1)
    return img, int(green.sum())


def test_frame_overlay_sync_engine(engine):
    _, green = _decoded_overlay(engine)
    xy, valid, matched = engine._overlay_data()
    assert xy.shape == (valid.shape[0], 2) and matched.dtype == bool
    assert int((valid & matched).sum()) > 20 and green > 100
    fresh = SlamEngine(CFG, enable_loop_closing=False, device="cpu")
    assert fresh.frame_overlay() is None             # no frame yet


def test_frame_overlay_windowed_engine():
    weng = WindowedSlamEngine(CFG, enable_loop_closing=False, device="cpu",
                              window=2)
    for i, (left, right) in enumerate(_frames()):
        weng.track_stereo(left, right, 0.1 * i)
    assert weng._last_out is not None and weng.state == tracking.OK
    xy, valid, matched = weng._overlay_data()
    out = weng._last_out
    np.testing.assert_array_equal(xy, out.fds.xy_raw[-1].numpy())
    np.testing.assert_array_equal(
        matched, (out.last_assoc >= 0).numpy() & out.last_inlier.numpy())
    _, green = _decoded_overlay(weng)
    assert int((valid & matched).sum()) > 20 and green > 100
    weng._auto_reset()
    assert weng._last_out is None


def test_live_viewer_serves_state_and_menu():
    """Viewer.cc:54-248 on the port: the state endpoint, the localization
    menu toggle driving the System's mode switch, the annotated frame."""
    sys_ = System(None, None, STEREO, config=CFG, device="cpu")
    for i, (left, right) in enumerate(_frames(3)):
        sys_.track_stereo(left, right, 0.1 * i)
    viewer = tlive.LiveViewer(sys_)
    port = viewer.start()
    # the server is on this host: no proxy
    urlopen = urllib.request.build_opener(urllib.request.ProxyHandler({})).open
    try:
        base = f"http://127.0.0.1:{port}"
        page = urlopen(base + "/", timeout=10).read()
        assert b"Localization Mode" in page
        st = json.loads(urlopen(base + "/state",
                                               timeout=10).read())
        assert st["n_kfs"] >= 1 and st["n_points"] > 50
        assert st["localization"] is False
        req = urllib.request.Request(base + "/toggle_localization",
                                     method="POST")
        out = json.loads(urlopen(req, timeout=10).read())
        assert out["localization"] is True
        assert sys_.engine.localization_only is True
        frame = urlopen(base + "/frame.png",
                                       timeout=10).read()
        assert frame[:8] == png.SIGNATURE and len(frame) > 1000
        req = urllib.request.Request(base + "/reset", method="POST")
        urlopen(req, timeout=10).read()
        assert viewer.state()["n_kfs"] == 0
    finally:
        viewer.stop()
