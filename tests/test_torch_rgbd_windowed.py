"""The port's ``WindowedSlamEngine(window=4)`` against the JAX package's
on test_torch_rgbd.py's RGB-D sequence (12 frames, loop closing off,
uint8 gray, ``_mapper_idle`` patched to True on both), with that file's
bars: neither LOST, keyframe counts within ±1, port ATE < 0.05 m and
within 0.01 m of the JAX engine's.  A file of its own, so that each of
the two stays near 75 s on one worker (the JAX windowed engine compiles
for most of it).
"""

import torch

from orbslam2_tpu.runtime.windowed import WindowedSlamEngine as JaxWindowed
from orbslam2_tpu_torch.runtime.windowed import \
    WindowedSlamEngine as TorchWindowed
from test_torch_rgbd import JCFG, TCFG, engines_track_alike, sequence  # noqa: F401

torch.set_num_threads(2)


def test_windowed_rgbd_engine_tracks_like_jax(sequence):  # noqa: F811
    engines_track_alike(
        JaxWindowed(JCFG, enable_loop_closing=False, window=4),
        TorchWindowed(TCFG, enable_loop_closing=False, device="cpu",
                      window=4),
        sequence, flush=True)
