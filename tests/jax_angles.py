"""JAX's values handed to the port, for parity tests that hold descriptors
or counts exact downstream of the frontend.

Both packages compute some of the frontend's float32 values in an order
that depends on the library and on the host CPU's vector path:

  * the IC angle's 961 moment terms (``hand_over``): on a resized pyramid
    level (non-integer pixels) the two sums can differ by an ULP, which
    can move the rounding of a steered BRIEF point and flip a descriptor
    bit;
  * the resized pyramid levels (``hand_over_pyramid``): JAX resizes by two
    matrix products, whose XLA CPU kernels sum a pixel's two taps with or
    without an FMA by shape, and the port by two rounded products and a
    sum (on the scale circuit's 320×240 frames 9-20% of the pixels of
    levels 1-7 differ by an ULP).  JAX's stereo frontend extracts from
    pyramids built under ``vmap`` over the pair, which differ again from
    the single-image pyramids its stereo matching reads (levels 3-7);
  * the stereo SAD sums over 11×11 patches of those levels, and through
    them ``ur`` and the depth (``hand_over_frontend``).

tests/test_torch_frontend.py holds both packages' angles against a
float64 evaluation within the float32 summation bound, and the pyramids
within 1e-4; tests downstream take JAX's values, as here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.models import frame as jframe
from orbslam2_tpu.ops import extractor as jext
from orbslam2_tpu.ops import image as jimage
from orbslam2_tpu_torch.convert import frame_data_from_numpy
from orbslam2_tpu_torch.models import frame as tframe
from orbslam2_tpu_torch.ops import extractor as text
from orbslam2_tpu_torch.ops import image as timage

_jax_angles = jax.jit(jext.keypoint_angles)
_jax_pyramid = jax.jit(jimage.build_pyramid, static_argnums=(1, 2))


def with_jax_angles(level_img, xy):
    """The port's ``keypoint_angles`` replaced by JAX's on the same level
    and keypoints."""
    return torch.from_numpy(np.array(_jax_angles(
        jnp.asarray(level_img.cpu().numpy()),
        jnp.asarray(xy.cpu().numpy().astype(np.int32))))).to(xy.device)


def hand_over(monkeypatch):
    """Make the port's extractor take JAX's angles for this test."""
    monkeypatch.setattr(text, "keypoint_angles", with_jax_angles)


def with_jax_pyramid(img, n_levels, scale_factor):
    """The port's ``build_pyramid`` replaced by JAX's on the same image
    (one image, as JAX's RGB-D and mono frontends and the vocabulary
    harvest build it)."""
    return [torch.from_numpy(np.array(x)).to(img.device)
            for x in _jax_pyramid(jnp.asarray(img.cpu().numpy()), n_levels,
                                  scale_factor)]


def hand_over_pyramid(monkeypatch):
    """Make the port build JAX's single-image pyramids for this test (not
    for a stereo frontend: see ``hand_over_frontend``)."""
    monkeypatch.setattr(timage, "build_pyramid", with_jax_pyramid)


def _jax_cfg(cfg):
    return jconfig.SlamConfig(
        camera=jconfig.CameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=jconfig.OrbConfig(**dataclasses.asdict(cfg.orb)),
        sensor=cfg.sensor)


def _jax_frontend(make_jax):
    def make(cfg):
        front = make_jax(_jax_cfg(cfg))

        def frontend(*imgs):
            out = front(*(jnp.asarray(x.cpu().numpy()) for x in imgs))
            return frame_data_from_numpy(
                {k: np.asarray(v) for k, v in out._asdict().items()},
                imgs[0].device)

        return frontend

    return make


def hand_over_frontend(monkeypatch):
    """Make the port's engines and trackers built in this test take JAX's
    FrameData (its jitted stereo, RGB-D and mono frontends on the same
    float32 images): the pyramids, the IC angles and the stereo SAD as
    JAX computes them.  JAX's windowed tracker runs the same frontend
    inside its scan and gives the same bits."""
    for name in ("make_frontend_stereo", "make_frontend_rgbd",
                 "make_frontend_mono"):
        monkeypatch.setattr(tframe, name, _jax_frontend(getattr(jframe,
                                                                name)))
