"""Per-frame data: the tensor analogue of ``Frame``.

Port of ``orbslam2_tpu/models/frame.py``: the stereo and RGB-D
frontends (the mono frontend waits for its ROADMAP item).  The JAX
version vmaps the extractor over the L/R pair; here the pair is a
two-iteration loop, and each image's pyramid is built once and shared by
extraction and stereo.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.config import RGBD, SlamConfig
from orbslam2_tpu_torch.ops import extractor, image as image_ops
from orbslam2_tpu_torch.ops import stereo as stereo_ops
from orbslam2_tpu_torch.utils import camera as cam_mod


class FrameData(NamedTuple):
    xy: torch.Tensor        # [N, 2] undistorted keypoint coords
    xy_raw: torch.Tensor    # [N, 2] raw (distorted) coords
    level: torch.Tensor     # [N] int32
    angle: torch.Tensor     # [N] float32
    response: torch.Tensor  # [N]
    valid: torch.Tensor     # [N] bool
    desc: torch.Tensor      # [N, 8] int32 words (uint32 bits)
    ur: torch.Tensor        # [N] right-image u coord (−1: mono)
    depth: torch.Tensor     # [N] stereo depth (−1: none)

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def make_frontend_stereo(cfg: SlamConfig):
    """(left, right) float32 [H, W] tensors → FrameData (stereo Frame
    ctor, Frame.cc:61-118)."""
    cam = cam_mod.Camera.from_config(cfg.camera)
    orb = cfg.orb

    def frontend(left: torch.Tensor, right: torch.Tensor) -> FrameData:
        pyr_l = image_ops.build_pyramid(left, orb.n_levels, orb.scale_factor)
        pyr_r = image_ops.build_pyramid(right, orb.n_levels, orb.scale_factor)
        fl = extractor.extract(pyr_l, orb)
        fr = extractor.extract(pyr_r, orb)
        sm = stereo_ops.match_stereo(fl, fr, pyr_l, pyr_r, cfg.camera.bf,
                                     cfg.camera.fx, orb.scale_factor)
        xy_und = (cam_mod.undistort_points(cam, fl.xy)
                  if cfg.camera.has_distortion else fl.xy)
        return FrameData(xy=xy_und, xy_raw=fl.xy, level=fl.level,
                         angle=fl.angle, response=fl.response, valid=fl.valid,
                         desc=fl.desc, ur=sm.u_right, depth=sm.depth)

    return frontend


def make_frontend_rgbd(cfg: SlamConfig):
    """(gray, depth) float32 [H, W] tensors → FrameData (RGB-D Frame ctor,
    Frame.cc:120): depth in the camera's units, read at the raw
    keypoints."""
    cam = cam_mod.Camera.from_config(cfg.camera)
    orb = cfg.orb

    def frontend(gray: torch.Tensor, depth_map: torch.Tensor) -> FrameData:
        pyr = image_ops.build_pyramid(gray, orb.n_levels, orb.scale_factor)
        f = extractor.extract(pyr, orb)
        sm = stereo_ops.depth_from_rgbd(f, depth_map, cfg.camera.bf)
        xy_und = (cam_mod.undistort_points(cam, f.xy)
                  if cfg.camera.has_distortion else f.xy)
        return FrameData(xy=xy_und, xy_raw=f.xy, level=f.level,
                         angle=f.angle, response=f.response, valid=f.valid,
                         desc=f.desc, ur=sm.u_right, depth=sm.depth)

    return frontend


def make_frontend(cfg: SlamConfig):
    """The sensor's frontend: called with a (left, right) pair for stereo,
    a (gray, depth) pair for RGB-D."""
    if cfg.sensor == RGBD:
        return make_frontend_rgbd(cfg)
    return make_frontend_stereo(cfg)
