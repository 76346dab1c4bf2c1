"""The JSON line of the port's bench (``orbslam2_tpu_torch/tools/bench.py``)
against ``bench.py``, on the CPU, at tests/test_torch_bench.py's widths.

  * A whole run holds every key that bench.py emits (read from its source
    with ``ast``) or names it under ``deviations``; every null key has its
    reason.
  * Without cv2 the oracle keys are null with a reason; the scaling keys
    are ``tools/scaling.measure_scaling``'s, null on the CPU.
  * Without a card the bench refuses to run and names ``--device cpu``.
  * Given the reference YAML, the RGB-D leg reports bench.py's
    ``ird_yaml_*`` keys; without it, ``rgbd_*``.
"""

import ast
import json
import os
import sys

import pytest
import torch

from orbslam2_tpu_torch.tools import bench

from test_torch_bench import CFG, DEPTHS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_py_keys():
    """Every key bench.py's main() puts in its JSON line: the string keys
    of its dict literals and of its subscript assignments."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_json_line_holds_every_bench_py_key_or_names_it():
    depths = DEPTHS._replace(slam_passes=2, loc_passes=1, mono_passes=1,
                             rgbd_frames=6, rgbd_warmup=2)
    out = bench.run("cpu", CFG, depths, log=lambda s: None)
    json.loads(json.dumps(out))
    keys = _bench_py_keys()
    assert {"metric", "slam_device_ms_per_frame", "mono_error",
            "oracle_repo_beats_proxy", "loc_device_limit_fps"} <= keys
    named = " ".join(out["deviations"])
    missing = sorted(k for k in keys if k not in out and k not in named)
    assert not missing, missing
    assert out["metric"] == "slam_mode_fps_per_chip" and out["value"] > 0
    assert out["device"] == "cpu"
    assert out["headline_is"] == "median of 2 passes"
    assert len(out["slam_pass_fps"]) == 2 and len(out["loc_pass_fps"]) == 1
    assert len(out["mono_pass_fps"]) == 1
    assert out["rgbd_fps"] > 0
    # cv2 imports here: the oracle ran
    assert out["oracle_repo_ate_m"] < bench.CV2_PROXY_ATE
    for k, v in out.items():
        if v is None:
            assert out["null_reasons"].get(k), k
    assert set(out["null_reasons"]) == {k for k, v in out.items()
                                        if v is None}


def test_oracle_keys_are_null_with_a_reason_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    keys, reasons = bench.oracle_leg(CFG, [], [], [], 4)
    assert keys == dict.fromkeys(bench.ORACLE_KEYS)
    assert set(reasons) == set(bench.ORACLE_KEYS)
    assert all("cv2" in r for r in reasons.values())


def test_scaling_keys_are_measure_scalings_and_null_on_the_cpu():
    from orbslam2_tpu_torch.tools.scaling import measure_scaling

    out = measure_scaling(["cpu"] * 2, C=6, pts_per_cam=48, n_pts=128,
                          repeats=1)
    assert tuple(out) == bench.SCALING_KEYS
    keys, reasons = bench.scaling_leg(torch.device("cpu"))
    assert keys == dict.fromkeys(bench.SCALING_KEYS)
    assert set(reasons) == set(bench.SCALING_KEYS)


def test_bench_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.run("cuda", CFG, DEPTHS)


def test_reference_yaml_runs_under_the_ird_yaml_keys(tmp_path):
    """Given the reference YAML (``--ird-yaml``), the RGB-D leg runs it
    unchanged at the bench capacity and reports bench.py's ``ird_yaml_*``
    keys; without it, the bench camera with ``sensor=RGBD`` under
    ``rgbd_*``, the YAML keys null with the reason."""
    from orbslam2_tpu_torch.config import RGBD

    leg = {"fps": 2.5, "kf_per_frame": 0.1}
    cfg, from_yaml = bench.rgbd_config(bench.bench_config())
    assert not from_yaml and cfg.sensor == RGBD
    assert cfg.camera == bench.bench_config().camera
    keys, reasons = bench.rgbd_leg_keys(leg, from_yaml)
    assert (keys["rgbd_fps"], keys["rgbd_kf_per_frame"]) == (2.5, 0.1)
    assert all(keys[k] is None for k in bench.IRD_KEYS)
    assert set(reasons) == set(bench.IRD_KEYS)
    assert any("RGB-D" in d for d in bench.deviations(False))

    yaml = tmp_path / "RealSense-D435i-IRD.yaml"
    yaml.write_text("%YAML:1.0\nCamera.fx: 615.0\nCamera.fy: 615.5\n"
                    "Camera.cx: 320.0\nCamera.cy: 240.0\n"
                    "Camera.width: 640\nCamera.height: 480\n"
                    "Camera.fps: 30.0\nCamera.bf: 30.75\nThDepth: 40.0\n"
                    "DepthMapFactor: 1000.0\nORBextractor.nFeatures: 1000\n")
    cfg, from_yaml = bench.rgbd_config(bench.bench_config(), str(yaml))
    assert from_yaml and cfg.sensor == RGBD
    assert (cfg.camera.fx, cfg.camera.fps) == (615.0, 30.0)
    assert cfg.capacity == bench.bench_config().capacity
    keys, reasons = bench.rgbd_leg_keys(leg, from_yaml)
    assert keys["ird_yaml_fps"] == 2.5 and keys["ird_yaml_kf_per_frame"] == 0.1
    assert keys["ird_yaml_config"] == "RealSense-D435i-IRD.yaml (unchanged)"
    assert all(keys[k] is None for k in bench.RGBD_KEYS)
    assert set(reasons) == set(bench.RGBD_KEYS)
    assert not any("RGB-D" in d for d in bench.deviations(True))


def test_mono_keys_are_null_with_a_reason_where_the_engine_ended_lost():
    """An engine that ended LOST timed relocalization attempts: the mono
    rates are null, the reason gives the tracked frames and the rates."""
    from orbslam2_tpu_torch.runtime import tracking

    leg = {"fps": 0.8, "pass_fps": [1.0, 0.6], "kf_per_frame": 0.27,
           "n_tracked": 67, "relocalized": 0, "state": tracking.OK}
    keys, reasons = bench.mono_leg_keys(leg, 124)
    assert keys == {"mono_slam_fps": 0.8, "mono_pass_fps": [1.0, 0.6],
                    "mono_kf_per_frame": 0.27} and not reasons
    keys, reasons = bench.mono_leg_keys(
        dict(leg, state=tracking.LOST), 124)
    assert keys == dict.fromkeys(bench.MONO_KEYS)
    assert set(reasons) == set(bench.MONO_KEYS)
    assert all("ended LOST: 67 of 124" in r and "[1.0, 0.6]" in r
               for r in reasons.values())


@pytest.mark.parametrize("check,res,match", [
    (bench.check_slam, {"n_lost": 1, "ate_m": 0.01}, "bench-slam: lost 1"),
    (bench.check_slam, {"n_lost": 0, "ate_m": 0.2}, "bench-slam: lost 0"),
    (bench.check_rgbd, {"n_lost": 2, "ate_m": 0.01}, "bench-rgbd: lost 2"),
    (bench.check_rgbd, {"n_lost": 0, "ate_m": 0.15}, "bench-rgbd: lost 0"),
    (lambda r: bench.check_loc(r, CFG), {"fewest_inliers": 29, "ate_m": 0.0},
     "only 29 map inliers"),
    (lambda r: bench.check_loc(r, CFG), {"fewest_inliers": 30, "ate_m": 0.2},
     "bench-loc: ATE"),
], ids=["slam-lost", "slam-ate", "rgbd-lost", "rgbd-ate", "loc-inliers",
        "loc-ate"])
def test_a_leg_past_its_bar_ends_the_run(check, res, match):
    with pytest.raises(AssertionError, match=match):
        check(res)
