"""The trajectory tool (``orbslam2_tpu_torch/tools/plot_trajectory.py``)
against ``tools/analysis/plot_trajectory.py`` on TUM files made from a
seed, with and without ground truth, with ``--align`` and ``--align
--scale``: the same printed lines, and the same PLY bytes with
matplotlib hidden (moved from tests/test_torch_scale.py).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.tools import plot_trajectory as tplot

torch.set_num_threads(2)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_plot_tool():
    path = os.path.join(REPO, "tools", "analysis", "plot_trajectory.py")
    spec = importlib.util.spec_from_file_location("_jax_plot_trajectory",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_tum(path, ts, pos, rng):
    q = rng.normal(size=(len(ts), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, qq in zip(ts, pos, q):
            f.write(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*p, *qq))
                    + "\n")


@pytest.fixture(scope="module")
def tum_files(tmp_path_factory):
    """A ground-truth walk and an estimate of it: rotated, shifted,
    scaled by 1.3 and noisy, on timestamps jittered by up to 15 ms, with
    gaps (estimate frames with no ground truth within 20 ms)."""
    d = tmp_path_factory.mktemp("tum")
    rng = np.random.default_rng(11)
    n = 120
    ts = 0.1 * np.arange(n)
    gt = np.cumsum(rng.normal(0, 0.2, (n, 3)), axis=0)
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    est = 1.3 * gt @ R.T + np.array([0.5, -0.2, 1.0]) \
        + rng.normal(0, 0.01, (n, 3))
    ts_e = ts + rng.uniform(-0.015, 0.015, n)
    ts_e[::17] += 0.05
    _write_tum(d / "gt.txt", ts, gt, rng)
    _write_tum(d / "est.txt", ts_e, est, rng)
    return str(d / "est.txt"), str(d / "gt.txt")


def _run_tool(main, argv, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", ["plot_trajectory.py", *argv])
    main()
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    pytest.param(None, id="no-gt"), pytest.param([], id="gt"),
    pytest.param(["--align"], id="align"),
    pytest.param(["--align", "--scale"], id="align-scale")])
def test_plot_tool_matches_jax_without_matplotlib(flags, tum_files,
                                                  tmp_path, monkeypatch,
                                                  capsys):
    est, gt = tum_files
    argv = [est] + ([] if flags is None else [gt, *flags]) + \
        ["--out", "traj.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    jtool = _jax_plot_tool()
    outs = {}
    for name, main in (("jax", jtool.main), ("port", tplot.main)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = (_run_tool(main, argv, d, monkeypatch, capsys),
                      (d / "traj.ply").read_bytes())
        assert os.listdir(d) == ["traj.ply"]
    assert outs["port"] == outs["jax"]
    lines = outs["port"][0].splitlines()
    assert lines[-1] == "matplotlib unavailable; wrote traj.ply"
    if flags is not None:
        t_est = np.loadtxt(est, usecols=0)
        t_gt = np.loadtxt(gt, usecols=0)
        n_matched = int(np.sum(
            np.abs(t_est[:, None] - t_gt[None]).min(axis=1) <= 0.02))
        assert n_matched == 112          # the fixture's 8 gaps
        assert lines[0].startswith("ATE RMSE: ")
        assert lines[0].endswith(f" m over {n_matched} matched poses")


def test_plot_tool_matches_jax_with_matplotlib(tum_files, tmp_path,
                                               monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    est, gt = tum_files
    argv = [est, gt, "--align", "--scale", "--out", "traj.png"]
    jtool = _jax_plot_tool()
    outs = {}
    for name, main in (("jax", jtool.main), ("port", tplot.main)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = _run_tool(main, argv, d, monkeypatch, capsys)
        assert os.listdir(d) == ["traj.png"]
        assert (d / "traj.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert outs["port"] == outs["jax"]
    assert outs["port"].splitlines()[-1] == "wrote traj.png"


def test_associate_matches_jax():
    jtool = _jax_plot_tool()
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 10, 200))
    b = np.sort(rng.uniform(0, 10, 150))
    for dt in (0.005, 0.02, 0.1):
        assert tplot.associate(a, b, dt) == jtool.associate(a, b, dt)
