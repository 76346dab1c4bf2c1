"""The replay harness of the port (``orbslam2_tpu_torch/tools/benchmark.py``)
against ``tools/benchmarks/benchmark.py``, the JAX package's, on the CPU.

  * ``--kind synthetic --frames 6 --device cpu`` runs the port's synthetic
    replay end to end and prints one JSON line with the JAX script's five
    keys (read from its source with ``ast``): every frame tracked, ``fps``
    from the median;
  * for each ``--kind``, with both packages' ``run_*`` drivers replaced by
    recorders that return the same report: the same driver called with the
    same arguments on the same argv (the port's adds its device), the same
    summary lines and the same JSON line;
  * without a card, ``--device cuda`` (the default) raises and names
    ``--device cpu``.
"""

import ast
import importlib.util
import json
import os
import sys

import pytest
import torch

from orbslam2_tpu.tools import replay as jreplay
from orbslam2_tpu_torch.tools import benchmark
from orbslam2_tpu_torch.tools import replay as treplay

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "tools", "benchmarks", "benchmark.py")
DRIVERS = {"synthetic": "run_synthetic_stereo", "kitti": "run_kitti_stereo",
           "tum": "run_tum_rgbd", "euroc": "run_euroc_stereo"}


def _jax_keys():
    """The keys of the JSON line the JAX script prints."""
    with open(JAX_SCRIPT) as f:
        tree = ast.parse(f.read())
    call = next(n for n in ast.walk(tree)
                if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    return [k.value for k in call.args[0].keys]


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


def test_synthetic_replay_prints_the_jax_scripts_keys(capsys):
    ret = benchmark.main(["--kind", "synthetic", "--frames", "6",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    line = _json_line(out)
    assert list(line) == _jax_keys() == ["median_ms", "mean_ms", "fps",
                                         "tracked", "frames"]
    assert line == ret
    assert out.splitlines()[0] == "device: cpu"
    assert "tracked 6/6 frames" in out
    assert line["frames"] == line["tracked"] == 6
    assert line["fps"] == pytest.approx(1000.0 / line["median_ms"])
    assert 0 < line["median_ms"] and 0 < line["mean_ms"]


def _recorder(module, report_cls, calls):
    """Replaces every driver of ``module`` by one that records its
    arguments and returns a fixed report."""
    def make(name):
        def run(*args, **kwargs):
            kwargs.pop("device", None)
            calls.append((name, args, kwargs))
            return report_cls(n_frames=3, n_tracked=2,
                              durations_ms=[30.0, 10.0, 20.0])
        return run
    return {name: make(name) for name in DRIVERS.values()}


@pytest.mark.parametrize("kind", list(DRIVERS))
def test_each_kind_calls_the_driver_the_jax_script_calls(
        kind, monkeypatch, capsys):
    argv = ["--kind", kind, "--frames", "3", "--path", "/seq",
            "--settings", "/seq/s.yaml"]
    jcalls, tcalls = [], []
    for name, fn in _recorder(jreplay, jreplay.ReplayReport,
                              jcalls).items():
        monkeypatch.setattr(jreplay, name, fn)
    for name, fn in _recorder(treplay, treplay.ReplayReport,
                              tcalls).items():
        monkeypatch.setattr(treplay, name, fn)

    spec = importlib.util.spec_from_file_location("jax_benchmark",
                                                  JAX_SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["benchmark.py"] + argv)
    script.main()
    jout = capsys.readouterr().out.splitlines()
    benchmark.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out.splitlines()

    assert tcalls == jcalls and tcalls[0][0] == DRIVERS[kind]
    assert tout[0] == "device: cpu" and jout[0].startswith("devices: ")
    assert tout[1:] == jout[1:]


def test_harness_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        benchmark.main(["--frames", "1"])
