"""The port's copies of the numpy-only modules (config, BRIEF pattern,
synthetic scenes) stay equal to the JAX package's originals."""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.ops import pattern as jpattern
from orbslam2_tpu.utils import synthetic as jsynthetic
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.ops import pattern as tpattern
from orbslam2_tpu_torch.utils import synthetic as tsynthetic

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
