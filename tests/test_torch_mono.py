"""Mono on the port against the JAX package: the mono frontend,
SearchForInitialization, the H/F initializer, the two-keyframe bootstrap
and ``SlamEngine`` on a mono sequence.

Tolerances (JAX's random draws are computed here and passed to the port
as ``idx=``; torch's generator draws other sets):

  * the mono frontend on a rendered 640×480 frame (uint8 gray on both
    sides), the port handed JAX's pyramid and IC angles
    (tests/jax_angles.py: both are float32 sums that round by the host
    CPU on resized levels; the port's own are held in
    test_torch_frontend.py): keypoints, levels,
    validity and descriptors exact, angles equal to JAX's within 1e-4 rad
    (met trivially under the handover), ``ur`` and ``depth`` all −1;
  * ``search_for_initialization`` on two rendered frames: match indices
    and distances exact;
  * ``initialize_mono`` on tests/test_mono.py's F scene and H scene:
    ``ok`` and ``used_h`` equal, ``Tcw2`` within 5e-4, the ``good`` mask
    ≥ 99% equal, good points within 2e-3 of their depth (the null vectors'
    signs and the FP32 SVDs differ between LAPACK and XLA; 6.6e-5 and
    4e-3 m at depths of 8-40 units seen);
  * ``nanmedian``: equal to ``jnp.nanmedian`` (the mean of the two middle
    values at an even count, where ``torch.nanmedian`` takes the lower);
  * ``mono_build`` on a scene whose good points are an even count with a
    wide gap at the median: ``kf_mp`` and ``mp_valid`` exact, ``kf_pose``
    within 5e-4, ``mp_pos`` within 2e-3 of the points' depth;
  * ``SlamEngine`` over 12 frames of bench.py's mono leg (its world and
    sideways walk) at 1000 features, loop closing off, JAX's PRNGKey(7)
    and per-attempt split replayed into the port: both initialize on the
    same frame, neither LOST, keyframe counts within ±1, the port's
    similarity-aligned ATE below 0.03 × path length and within 0.01 m of
    the JAX engine's;
  * in localization mode a mono engine tracks with ``track_body``, never
    with the depth sensors' ``track_loc_body``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, MONOCULAR,
                                 OrbConfig, SlamConfig)
from orbslam2_tpu.models import frame as jframe
from orbslam2_tpu.models import map_state as JM
from orbslam2_tpu.ops import initializer as jinit
from orbslam2_tpu.ops import matching as jmatching
from orbslam2_tpu.runtime import tracking as jtracking
from orbslam2_tpu.runtime.slam import SlamEngine as JaxEngine
from orbslam2_tpu.utils import camera as jcam
from orbslam2_tpu.utils import lie as jlie
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.convert import frame_data_from_numpy
from orbslam2_tpu_torch.models import frame as tframe
from orbslam2_tpu_torch.models import map_state as TM
from orbslam2_tpu_torch.ops import initializer as tinit
from orbslam2_tpu_torch.ops import matching as tmatching
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchEngine
from orbslam2_tpu_torch.utils import camera as tcam

from jax_angles import hand_over as hand_over_jax_angles
from jax_angles import hand_over_pyramid
from orbslam2_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                   height=480, fps=10.0)
CAP = CapacityConfig(max_keyframes=16, max_map_points=4096,
                     local_ba_keyframes=8, local_ba_points=1024)
JCFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=1000), capacity=CAP,
                  sensor=MONOCULAR)


def tcfg_of(cfg):
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=tconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
        capacity=tconfig.CapacityConfig(**dataclasses.asdict(cfg.capacity)),
        sensor=cfg.sensor)


TCFG = tcfg_of(JCFG)
N_FRAMES = 12                    # bench.py's mono walk, cut to 12 frames
T_CAM = tcam.Camera.from_config(TCFG.camera)
J_CAM = jcam.Camera.from_config(CAM)


def jax_draws(key, valid):
    """JAX's RANSAC sets for ``valid``, drawn as initializer.py:259 does."""
    prob = jnp.asarray(valid, jnp.float32)
    prob = prob / jnp.clip(jnp.sum(prob), 1.0, None)
    idx = jax.random.choice(key, prob.shape[0], shape=(jinit.N_SETS, 8),
                            replace=True, p=prob)
    return torch.from_numpy(np.array(idx))


def bench_mono_sequence(n):
    """bench.py's mono leg: the bench world, gray frames along a sideways
    look-ahead walk (bench.py:199-211), uint8 as the engines take them."""
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = [synthetic.look_ahead_pose(np.array([0.18 * i, 0.0, 0.04 * i]))
             for i in range(n)]
    frames = [np.clip(synthetic.render_world(world, CAM, T, rng, noise=1.0),
                      0, 255).astype(np.uint8) for T in poses]
    return poses, frames


@pytest.fixture(scope="module")
def sequence():
    return bench_mono_sequence(N_FRAMES)


def sim3_ate(eng, poses_gt):
    """Similarity-aligned ATE over the tracked frames (tests/test_mono.py:
    frames before initialization have no entry) and their count."""
    est, gt = [], []
    entries = eng.trajectory
    for Te, Tg, e in zip(eng.frame_poses(), poses_gt[-len(entries):],
                         entries):
        if Te is None or e.lost:
            continue
        est.append(-Te[:3, :3].T @ Te[:3, 3])
        gt.append(-Tg[:3, :3].T @ Tg[:3, 3])
    return ttraj.ate_rmse(np.asarray(est), np.asarray(gt), align=True,
                          with_scale=True), len(est)


# ------------------------------------------------------------- frontend --

def test_mono_frontend_exact(sequence, monkeypatch):
    _, frames = sequence
    hand_over_pyramid(monkeypatch)
    hand_over_jax_angles(monkeypatch)
    g32 = frames[3].astype(np.float32)
    jfd = jframe.make_frontend_mono(JCFG)(jnp.asarray(g32))
    tfd = tframe.make_frontend(TCFG)(torch.from_numpy(g32))
    for f in ("xy", "xy_raw", "level", "valid", "ur", "depth"):
        np.testing.assert_array_equal(getattr(tfd, f).numpy(),
                                      np.asarray(getattr(jfd, f)), err_msg=f)
    np.testing.assert_array_equal(tfd.desc.numpy().view(np.uint32),
                                  np.asarray(jfd.desc))
    np.testing.assert_allclose(tfd.angle.numpy(), np.asarray(jfd.angle),
                               atol=1e-4, rtol=0)
    assert (tfd.ur.numpy() == -1).all() and (tfd.depth.numpy() == -1).all()
    assert int(tfd.valid.sum()) > 500


def test_search_for_initialization_exact(sequence):
    _, frames = sequence
    front = jframe.make_frontend_mono(JCFG)
    a, b = (front(jnp.asarray(frames[i].astype(np.float32))) for i in (0, 2))
    args = lambda f: (f.xy, f.desc, f.valid, f.level)   # noqa: E731
    jm, jd = jax.jit(jmatching.search_for_initialization)(
        *args(a), *args(b), a.angle, b.angle)
    ta, tb = (frame_data_from_numpy({k: np.asarray(v)
                                     for k, v in f._asdict().items()})
              for f in (a, b))
    tm, td = tmatching.search_for_initialization(
        *args(ta), *args(tb), ta.angle, tb.angle)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int((tm >= 0).sum()) >= 100


# ---------------------------------------------------------- initializer --

def two_view(rng, planar, depths=None):
    """tests/test_mono.py's two views (its F scene, or its H scene when
    ``planar``): matched pixels with noise, and the in-image mask."""
    n = 300
    if depths is None:
        depths = np.full(n, 10.0) if planar else rng.uniform(5, 25, n)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), depths], -1)
    w = [0.03, -0.04, 0.02] if planar else [0.02, -0.05, 0.01]
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    t = np.array([0.7, 0.1, 0.05] if planar else [0.6, 0.05, 0.1])
    uv1 = pts[:, :2] / pts[:, 2:] * 450 + [320, 240]
    pc2 = pts @ R.T + t
    uv2 = pc2[:, :2] / pc2[:, 2:] * 450 + [320, 240]
    noise = 0.3 if planar else 0.4
    uv1 = uv1 + rng.normal(0, noise, uv1.shape)
    uv2 = uv2 + rng.normal(0, noise, uv2.shape)
    inb = ((uv2[:, 0] > 0) & (uv2[:, 0] < 640)
           & (uv2[:, 1] > 0) & (uv2[:, 1] < 480))
    return uv1.astype(np.float32), uv2.astype(np.float32), inb


def assert_init_close(tr, jr):
    assert bool(tr.ok) == bool(jr.ok)
    assert bool(tr.used_h) == bool(jr.used_h)
    np.testing.assert_allclose(tr.Tcw2.numpy(), np.asarray(jr.Tcw2),
                               atol=5e-4, rtol=0)
    jg = np.asarray(jr.good)
    assert (tr.good.numpy() == jg).mean() >= 0.99
    both = jg & tr.good.numpy()
    X, Xj = tr.points.numpy()[both], np.asarray(jr.points)[both]
    err = np.linalg.norm(X - Xj, axis=-1) / np.abs(Xj[:, 2])
    assert err.max() < 2e-3, err.max()


@pytest.mark.parametrize("planar,seed", [(False, 0), (True, 1)],
                         ids=["F scene", "H scene"])
def test_initialize_mono_matches_jax(planar, seed):
    uv1, uv2, inb = two_view(np.random.default_rng(0), planar)
    key = jax.random.PRNGKey(seed)
    jr = jax.jit(lambda a, b, v, k: jinit.initialize_mono(J_CAM, a, b, v, k))(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(inb), key)
    tr = tinit.initialize_mono(T_CAM, torch.from_numpy(uv1),
                               torch.from_numpy(uv2), torch.from_numpy(inb),
                               idx=jax_draws(key, inb))
    assert bool(jr.ok) and bool(jr.used_h) == planar
    assert_init_close(tr, jr)


def test_initialize_mono_without_valid_matches_is_not_ok():
    """No valid match: the draws fall back to uniform on the device (no
    host check, no raise), and the initializer reports not ok."""
    uv1, uv2, _ = two_view(np.random.default_rng(0), False)
    none = torch.zeros(uv1.shape[0], dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    tr = tinit.initialize_mono(T_CAM, torch.from_numpy(uv1),
                               torch.from_numpy(uv2), none, g)
    assert not bool(tr.ok) and not bool(tr.good.any())


@pytest.mark.parametrize("vals", [
    [3.0, np.nan, 1.0, 8.0],                 # odd count: 3
    [5.0, 1.0, np.nan, 2.0, 9.0],            # even: the mean of 2 and 5
    [np.nan, np.nan], [4.0], [2.0, 7.0, 1.0, 6.0, 3.0, 9.0]])
def test_nanmedian_is_jax_nanmedian(vals):
    x = np.asarray(vals, np.float32)
    got = float(tinit.nanmedian(torch.from_numpy(x)))
    want = float(jnp.nanmedian(jnp.asarray(x)))
    assert (np.isnan(got) and np.isnan(want)) or got == want, (got, want)


# --------------------------------------------------------- mono_build --

def bootstrap_frames(cfg, rng):
    """Two frames whose matched keypoints are the bimodal F scene: 150
    points at 4-6 and 150 at 20-30 depth units, so that the median of the
    good depths (an even count) falls in a wide gap; the second frame's
    rows are shuffled, so the keyframe-1 associations go through the
    match indices.  Returns (ref, cur, m) as numpy dicts and [N] int32."""
    N = cfg.orb.n_features_padded
    depths = np.concatenate([rng.uniform(4, 6, 150), rng.uniform(20, 30, 150)])
    uv1, uv2, inb = two_view(rng, False, depths)
    n = uv1.shape[0]
    perm = rng.permutation(N)[:n]

    def frame(rows, uv):
        xy = np.zeros((N, 2), np.float32)
        xy[rows] = uv
        return {"xy": xy, "xy_raw": xy,
                "level": np.zeros(N, np.int32),
                "angle": rng.uniform(0, 6.28, N).astype(np.float32),
                "response": np.zeros(N, np.float32),
                "valid": np.isin(np.arange(N), rows),
                "desc": rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32),
                "ur": np.full(N, -1.0, np.float32),
                "depth": np.full(N, -1.0, np.float32)}

    m = np.full(N, -1, np.int32)
    m[:n] = np.where(inb, perm, -1)
    return frame(np.arange(n), uv1), frame(perm, uv2), m


def test_mono_build_matches_jax_at_an_even_count():
    cfg = dataclasses.replace(JCFG, orb=OrbConfig(n_features=300))
    tcfg = tcfg_of(cfg)
    ref, cur, m = bootstrap_frames(cfg, np.random.default_rng(3))
    key = jax.random.PRNGKey(5)
    _, j_build = jtracking.make_mono_init_fns(cfg)
    jfd = [jframe.FrameData(**{k: jnp.asarray(v) for k, v in f.items()})
           for f in (ref, cur)]
    jms, jok, jT2, jassoc, jn = j_build(
        JM.empty_map(cfg), *jfd, jnp.asarray(m), key, jnp.int32(3),
        jnp.int32(4), jnp.float32(0.3), jnp.float32(0.4))
    tfns = ttracking.make_tracking_fns(tcfg)
    tms, tok, tT2, tassoc, tn = tfns.mono_build(
        TM.empty_map(tcfg), frame_data_from_numpy(ref),
        frame_data_from_numpy(cur), torch.from_numpy(m).long(), 3, 4, 0.3,
        0.4, idx=jax_draws(key, m >= 0))
    assert bool(jok) and bool(tok) and int(tn) == int(jn)
    assert int(jn) % 2 == 0              # the median is a two-value mean
    np.testing.assert_array_equal(tassoc.numpy(), np.asarray(jassoc))
    for k in ("kf_mp", "mp_valid", "kf_valid", "kf_parent"):
        np.testing.assert_array_equal(getattr(tms, k).numpy(),
                                      np.asarray(getattr(jms, k)),
                                      err_msg=k)
    np.testing.assert_allclose(tms.kf_pose.numpy(), np.asarray(jms.kf_pose),
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(tT2.numpy(), np.asarray(jT2), atol=5e-4,
                               rtol=0)
    valid = np.asarray(jms.mp_valid)
    Xj = np.asarray(jms.mp_pos)[valid]
    err = np.linalg.norm(tms.mp_pos.numpy()[valid] - Xj, axis=-1)
    assert (err / np.abs(Xj[:, 2])).max() < 2e-3, err.max()


# -------------------------------------------------------------- engine --

class JaxDraws:
    """The JAX engine's draws (PRNGKey(7), one split per attempt,
    runtime/slam.py:389, 403) passed to the port's mono_build as idx."""

    def __init__(self, build):
        self.key = jax.random.PRNGKey(7)
        self.build = build

    def __call__(self, ms, ref, cur, m, fid_ref, fid_cur, ts_ref, ts_cur,
                 generator=None):
        self.key, k = jax.random.split(self.key)
        return self.build(ms, ref, cur, m, fid_ref, fid_cur, ts_ref, ts_cur,
                          idx=jax_draws(k, (m >= 0).numpy()))


def run_mono(eng, frames, windowed=False):
    """Track the frames (``_mapper_idle`` patched to True: whether a device
    program has finished is timing); returns the first frame that gave a
    pose."""
    eng._mapper_idle = lambda: True
    first = None
    for i, img in enumerate(frames):
        out = eng.track_monocular(img, 0.1 * i)
        if out is not None and first is None:
            first = i
    if windowed:
        eng.flush()
    return first


def engines_track_alike(jeng, teng, sequence, windowed=False):
    """Both mono engines over the sequence, JAX's draws replayed into the
    port; the file's bars on the result."""
    poses, frames = sequence
    teng.fns = teng.fns._replace(mono_build=JaxDraws(teng.fns.mono_build))
    j_first = run_mono(jeng, frames, windowed)
    t_first = run_mono(teng, frames, windowed)
    assert jeng.state == teng.state == 2
    assert t_first == j_first is not None
    assert abs(teng.stats["kf_inserted"] - jeng.stats["kf_inserted"]) <= 1, \
        (teng.stats, jeng.stats)
    j_ate, jn = sim3_ate(jeng, poses)
    t_ate, tn = sim3_ate(teng, poses)
    centres = ttraj.centers_from_poses(poses)
    path = float(np.sum(np.linalg.norm(np.diff(centres, axis=0), axis=1)))
    assert tn == jn >= N_FRAMES - 3, (tn, jn)
    assert t_ate < 0.03 * path, (t_ate, path)
    assert abs(t_ate - j_ate) < 0.01, (t_ate, j_ate)
    return teng


def test_mono_engine_tracks_like_jax(sequence):
    teng = engines_track_alike(
        JaxEngine(JCFG, enable_loop_closing=False),
        TorchEngine(TCFG, enable_loop_closing=False, device="cpu"), sequence)
    assert teng.n_kfs >= 3 and teng.stats["mp_created"] > 100


# ----------------------------------------------------- localization --

SMALL = tconfig.SlamConfig(
    camera=tconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                                bf=75.0, width=320, height=240, fps=10.0,
                                th_depth=60.0),
    orb=tconfig.OrbConfig(n_features=200),
    capacity=tconfig.CapacityConfig(max_keyframes=4, max_map_points=1024,
                                    local_ba_keyframes=2,
                                    local_ba_points=256))


class Spied(Exception):
    pass


@pytest.mark.parametrize("sensor,path", [(tconfig.MONOCULAR, "track_body"),
                                         (tconfig.RGBD, "track_loc_body")])
def test_localization_mode_mono_takes_track_body(sensor, path):
    """A tracked engine in localization mode with a previous frame: RGB-D
    takes the VO path (``track_loc_body``), mono has no depth and must
    take ``track_body``."""
    eng = TorchEngine(dataclasses.replace(SMALL, sensor=sensor),
                      enable_loop_closing=False, device="cpu")
    N = SMALL.orb.n_features_padded
    eng.state = ttracking.OK
    eng.localization_only = True
    eng.last_Tcw = np.eye(4, dtype=np.float32)
    eng.last_assoc = torch.full((N,), -1, dtype=torch.int32)
    eng.last_inlier = torch.ones(N, dtype=torch.bool)
    eng.last_fd = eng.frontend(*(torch.zeros(240, 320) for _ in
                                 range(1 if sensor == tconfig.MONOCULAR
                                       else 2)))
    seen = []

    def spy(name):
        def f(*a, **k):
            seen.append(name)
            raise Spied
        return f

    eng.fns = eng.fns._replace(track_body=spy("track_body"),
                               track_loc_body=spy("track_loc_body"))
    img = np.zeros((240, 320), np.uint8)
    with pytest.raises(Spied):
        if sensor == tconfig.MONOCULAR:
            eng.track_monocular(img, 0.0)
        else:
            eng.track_rgbd(img, np.ones((240, 320), np.float32), 0.0)
    assert seen == [path]
