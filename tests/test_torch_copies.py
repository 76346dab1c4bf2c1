"""The port's copies of the numpy-only modules (config, BRIEF pattern,
synthetic scenes, trajectory export and ATE, HPose, the native runtime's
ctypes bindings) stay equal to the JAX package's originals."""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.ops import pattern as jpattern
from orbslam2_tpu.runtime import native as jnative
from orbslam2_tpu.utils import hpose as jhpose
from orbslam2_tpu.utils import synthetic as jsynthetic
from orbslam2_tpu.utils import trajectory as jtrajectory
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.ops import pattern as tpattern
from orbslam2_tpu_torch.runtime import native as tnative
from orbslam2_tpu_torch.utils import hpose as thpose
from orbslam2_tpu_torch.utils import synthetic as tsynthetic
from orbslam2_tpu_torch.utils import trajectory as ttrajectory

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [7, 11])
def test_brief_pattern_identical(seed):
    np.testing.assert_array_equal(tpattern.brief_pattern(seed),
                                  jpattern.brief_pattern(seed))


def test_ic_angle_disc_identical():
    np.testing.assert_array_equal(tpattern.ic_angle_disc(),
                                  jpattern.ic_angle_disc())


@pytest.mark.parametrize("section", ["camera", "orb", "tracking", "loop",
                                     "optimizer", "viewer", "capacity"])
def test_config_defaults_identical(section):
    a = dataclasses.asdict(getattr(jconfig.SlamConfig(), section))
    b = dataclasses.asdict(getattr(tconfig.SlamConfig(), section))
    assert a == b


@pytest.mark.parametrize("n", [200, 400, 1000, 1100])
def test_n_features_padded_identical(n):
    assert (tconfig.OrbConfig(n_features=n).n_features_padded
            == jconfig.OrbConfig(n_features=n).n_features_padded)


def test_synthetic_world_images_identical():
    cam_j = jconfig.CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                                 bf=75.0, width=320, height=240)
    cam_t = tconfig.CameraConfig(**dataclasses.asdict(cam_j))
    wj = jsynthetic.make_world(np.random.default_rng(3))
    wt = tsynthetic.make_world(np.random.default_rng(3))
    T = jsynthetic.straight_trajectory(3, step=0.25)[2]
    lj, rj = jsynthetic.render_world_stereo(wj, cam_j, T,
                                            np.random.default_rng(5), 1.0)
    lt, rt = tsynthetic.render_world_stereo(wt, cam_t, T,
                                            np.random.default_rng(5), 1.0)
    np.testing.assert_array_equal(lj, lt)
    np.testing.assert_array_equal(rj, rt)


def test_trajectory_copy_identical(tmp_path):
    """Same source below the copy's header, and the same numbers: the
    similarity-aligned ATE (mono's), its alignment, centres, and the TUM
    and KITTI files."""
    src_j = open(jtrajectory.__file__).read()
    src_t = open(ttrajectory.__file__).read()
    assert src_t.endswith(src_j)
    rng = np.random.default_rng(4)
    poses = [jsynthetic.look_ahead_pose(rng.normal(0, 2, 3),
                                        yaw=rng.normal(0, 0.3))
             for _ in range(9)]
    poses[3] = None
    est = rng.normal(0, 3, (20, 3))
    gt = 1.7 * est @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3
    for align, with_scale in ((False, False), (True, False), (True, True)):
        assert (ttrajectory.ate_rmse(est, gt, align, with_scale)
                == jtrajectory.ate_rmse(est, gt, align, with_scale))
    for a, b in zip(ttrajectory.umeyama(est, gt),
                    jtrajectory.umeyama(est, gt)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttrajectory.centers_from_poses(poses),
                                  jtrajectory.centers_from_poses(poses))
    for name, save, args in (("tum", "save_tum", (np.arange(9) * 0.1, poses)),
                             ("kitti", "save_kitti", (poses,))):
        getattr(ttrajectory, save)(str(tmp_path / f"t.{name}"), *args)
        getattr(jtrajectory, save)(str(tmp_path / f"j.{name}"), *args)
        assert ((tmp_path / f"t.{name}").read_text()
                == (tmp_path / f"j.{name}").read_text())


def test_hpose_copy_identical():
    """Same source below the copy's header; the same HPose, world-frame
    remap and Euler angles, also at a half turn (the non-trace branch)."""
    assert open(thpose.__file__).read().endswith(
        open(jhpose.__file__).read())
    rng = np.random.default_rng(6)
    poses = [jsynthetic.look_ahead_pose(rng.normal(0, 2, 3),
                                        yaw=rng.normal(0, 1.0),
                                        pitch=rng.normal(0, 0.3))
             for _ in range(6)]
    poses.append(np.diag([-1.0, 1.0, -1.0, 1.0]))
    for T in poses:
        hj = jhpose.HPose.from_Tcw(T)
        ht = thpose.HPose.from_Tcw(T)
        for a, b in ((ht, hj), (ht.to_world_frame(), hj.to_world_frame())):
            np.testing.assert_array_equal(a.position, b.position)
            np.testing.assert_array_equal(a.quaternion, b.quaternion)
            np.testing.assert_array_equal(a.euler(), b.euler())


def test_native_copy_identical():
    """Same source below the copy's header, and the copy binds the same
    library (or falls back alike): its StageTimer, queue and flag work."""
    assert open(tnative.__file__).read().endswith(
        open(jnative.__file__).read())
    assert tnative.have_native() == jnative.have_native()
    timer = tnative.StageTimer()
    for _ in range(3):
        timer.start()
        assert timer.stop() >= 0.0
    mean, median, lo, hi = timer.stats()
    assert timer.count() == 3 and 0.0 <= lo <= median <= hi
    q = tnative.TokenQueue(2)
    assert q.push(5) and q.pop(0) == 5
    flag = tnative.InterruptFlag()
    flag.set(1)
    assert flag.consume() == 1 and flag.get() == 0


def test_markers_copy_identical():
    """Same source below the copy's header."""
    from orbslam2_tpu.utils import markers as jmarkers
    from orbslam2_tpu_torch.utils import markers as tmarkers
    assert open(tmarkers.__file__).read().endswith(
        open(jmarkers.__file__).read())


def test_sensors_copy_identical():
    """Same source below the copy's header, but for the recorded-sequence
    backend's loader, which is the port's."""
    from orbslam2_tpu.utils import sensors as jsensors
    from orbslam2_tpu_torch.utils import sensors as tsensors
    src_j = open(jsensors.__file__).read().replace(
        "from orbslam2_tpu.utils.datasets import",
        "from orbslam2_tpu_torch.utils.datasets import")
    assert open(tsensors.__file__).read().endswith(src_j)


@pytest.mark.parametrize("name", ["_real_textures", "_alt_texture",
                                  "photometric_augment"])
def test_vocabulary_corpus_copies_identical(name):
    """The harvest's numpy functions in the port's models/vocabulary.py:
    the same source as the JAX package's, and the same arrays (the
    real-raster bank where matplotlib imports; every texture family; the
    augmentation), with the generator left in the same state."""
    import inspect

    from orbslam2_tpu.models import vocabulary as jvoc
    from orbslam2_tpu_torch.models import vocabulary as tvoc
    fj, ft = getattr(jvoc, name), getattr(tvoc, name)
    assert inspect.getsource(ft) == inspect.getsource(fj)
    if name == "_real_textures":
        pytest.importorskip("matplotlib")
        got, want = ft(), fj()
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    rj, rt = np.random.default_rng(8), np.random.default_rng(8)
    bank = [np.random.default_rng(9).uniform(0, 255, (90, 70)).astype(
        np.float32)]
    img = np.random.default_rng(10).uniform(-20, 280, (48, 64))
    for _ in range(10):
        if name == "_alt_texture":
            a, b = ft(rt, bank, 96), fj(rj, bank, 96)
        else:
            a, b = ft(img, rt), fj(img, rj)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert rt.bit_generator.state == rj.bit_generator.state
