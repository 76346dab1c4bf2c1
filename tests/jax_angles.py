"""JAX's IC angles handed to the port, for parity tests that hold
descriptors bit-exact.

Both packages sum an angle's 961 moment terms in float32, in an order
that depends on the library and on the host CPU's vector path.  On a
resized pyramid level (non-integer pixels) the two sums can differ by an
ULP, and that can move the rounding of a steered BRIEF point, which flips
one descriptor bit.  tests/test_torch_frontend.py holds both packages'
angles against a float64 evaluation within the float32 summation bound;
tests downstream of the angles hand the port JAX's, as here."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu.ops import extractor as jext
from orbslam2_tpu_torch.ops import extractor as text

_jax_angles = jax.jit(jext.keypoint_angles)


def with_jax_angles(level_img, xy):
    """The port's ``keypoint_angles`` replaced by JAX's on the same level
    and keypoints."""
    return torch.from_numpy(np.array(_jax_angles(
        jnp.asarray(level_img.cpu().numpy()),
        jnp.asarray(xy.cpu().numpy().astype(np.int32))))).to(xy.device)


def hand_over(monkeypatch):
    """Make the port's extractor take JAX's angles for this test."""
    monkeypatch.setattr(text, "keypoint_angles", with_jax_angles)
