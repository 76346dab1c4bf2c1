"""Time the hamming_top2 kernel on the card, and sweep its launch geometry.

    python3 orbslam2_tpu_torch/kernels/bench_hamming_top2.py [--default-only]
                                                            [--out FILE]

For each shape the main path and ``chip_smoke.py`` give the kernel, the
wrapper and (without ``--default-only``) the kernel built at every other
launch geometry (warps per block 8/16/32 × warps per A row 1/2/4, each a
variant library built with ``-DHT2_WARPS_PER_BLOCK`` and
``-DHT2_WARPS_PER_ROW``) is checked bit-exact against the plain version
and timed: device µs per launch from ``torch.profiler`` (the kernel's own
events) and, for the wrapper, its host µs per call, and at the first
shape the host µs of each part of the wrapper.  Host costs are timed
before any profiler session.  (1, 1) is the floor: a launch with next to
no work.  Each line carries the card's name and power limit.

``--default-only`` calls only ``hamming_top2(a, av, b, bv)``, so the same
file times an older checkout of the package, put first on ``PYTHONPATH``.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import numpy as np
import torch

SHAPES = [(1024, 1024), (600, 512), (1024, 16384), (64, 16384), (64, 700),
          (1, 1024), (1, 1)]


def device_us(fn, n=200, match="hamming_top2"):
    """(mean device µs per launch, launches recorded) of the CUDA kernels
    whose name holds ``match`` over ``n`` calls of ``fn`` (one launch
    each), from ``torch.profiler``: their summed durations over the
    launches it recorded (it has been seen to record fewer than ``n``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and match in e.name]
    if not times or sum(times) <= 0:
        raise RuntimeError(f"torch.profiler saw no device time for kernels "
                           f"named *{match}*")
    return sum(times) / len(times), len(times)


def host_us(fn, n=1000, rounds=5):
    """Host µs per call of ``fn``: the median over ``rounds`` of the mean
    over ``n`` calls, no synchronize inside a round (what a caller's
    thread pays to launch)."""
    for _ in range(10):
        fn()
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        means.append(1e6 * (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    return float(np.median(means))


def host_parts(ht2, a, av, b, bv):
    """Host µs per call of the wrapper and of each part of it, every part
    timed alone with what the others compute done once beforehand; {} for
    a package without the parts (an older checkout)."""
    if not hasattr(ht2, "_check_inputs"):
        return {}
    launch = ht2._kernel_fn()
    A, B, dev = ht2._check_inputs(a, av, b, bv)
    out = a.new_empty((3, A))
    ptrs = (a.data_ptr(), av.data_ptr(), b.data_ptr(), bv.data_ptr(), A, B,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "wrapper": lambda: ht2.hamming_top2(a, av, b, bv),
        "input checks": lambda: ht2._check_inputs(a, av, b, bv),
        "device context": device_context,
        "torch.cuda.Stream lookup": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw stream lookup": lambda: torch._C._cuda_getCurrentRawStream(
            dev.index),
        "output alloc": lambda: a.new_empty((3, A)),
        "ctypes launch": lambda: launch(*ptrs),
        "unbind": lambda: out.unbind(0),
    }
    return {name: host_us(fn) for name, fn in parts.items()}


def variant(warps_per_block, warps_per_row):
    """The kernel built at another launch geometry → a call taking the
    wrapper's inputs (no checks, no launch count)."""
    from orbslam2_tpu_torch.kernels import build

    fn = build.load("hamming_top2", (
        f"-DHT2_WARPS_PER_BLOCK={warps_per_block}",
        f"-DHT2_WARPS_PER_ROW={warps_per_row}")).hamming_top2_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, p, p]
    fn.restype = i

    def call(a, av, b, bv):
        out = a.new_empty((3, a.shape[0]))
        err = fn(a.data_ptr(), av.data_ptr(), b.data_ptr(), bv.data_ptr(),
                 a.shape[0], b.shape[0], out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"hamming_top2 {warps_per_block}x"
                               f"{warps_per_row}: CUDA error {err}")
        return out.unbind(0)

    return call


def inputs(A, B, seed=0, p=0.9):
    rng = np.random.default_rng(seed)

    def words(n):
        return torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8),
                                             dtype=np.uint32).view(np.int32)
                                ).cuda()

    return (words(A), torch.from_numpy(rng.random(A) < p).cuda(),
            words(B), torch.from_numpy(rng.random(B) < p).cuda())


def _exact(got, ref):
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--default-only", action="store_true")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_hamming_top2: no CUDA device")
    from orbslam2_tpu_torch.ops import hamming_top2 as ht2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[bench] {smi} | {ht2.__file__}", flush=True)
    # host costs first, before any profiler session can colour them
    rows, inputs_of, variants = [], {}, {}
    for A, B in SHAPES:
        x = inputs_of[A, B] = inputs(A, B)
        exact = _exact(ht2.hamming_top2(*x), ht2.hamming_top2_reference(*x))
        if not exact:
            raise SystemExit(f"bench_hamming_top2: {A}x{B} differs from the "
                             f"plain version")
        host = host_us(lambda: ht2.hamming_top2(*x))
        rows.append({"A": A, "B": B, "config": "default", "exact": exact,
                     "host_us": host})
        print(f"[bench] {A}x{B} default: wrapper host {host:.2f} us per "
              f"call, bit-exact {exact} ({smi})", flush=True)
    parts = host_parts(ht2, *inputs_of[SHAPES[0]])
    if parts:
        print(f"[bench] {SHAPES[0][0]}x{SHAPES[0][1]} host us per call by "
              f"part: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
              + f" ({smi})", flush=True)
    for A, B in SHAPES:
        x = inputs_of[A, B]
        ref = ht2.hamming_top2_reference(*x)
        configs = [None]
        if not args.default_only:
            # (warps per block, warps per row); (16, 2) is the wrapper's
            configs += [(w, g) for w in (8, 16, 32) for g in (1, 2, 4)
                        if (w, g) != (16, 2)]
        for cfg in configs:
            if cfg is not None and cfg not in variants:
                variants[cfg] = variant(*cfg)
            fn = ht2.hamming_top2 if cfg is None else variants[cfg]

            def call():
                return fn(*x)

            exact = _exact(call(), ref)
            if not exact:
                raise SystemExit(f"bench_hamming_top2: {A}x{B} {cfg} differs "
                                 f"from the plain version")
            us, recorded = device_us(call)
            if cfg is None:
                next(r for r in rows if (r["A"], r["B"]) == (A, B)).update(
                    device_us=us, recorded=recorded)
            else:
                rows.append({"A": A, "B": B, "config": cfg, "exact": exact,
                             "device_us": us, "recorded": recorded})
            print(f"[bench] {A}x{B} {cfg or 'default'}: device {us:.3f} us "
                  f"(mean of {recorded} recorded launches), bit-exact "
                  f"{exact} ({smi})", flush=True)
    x = inputs_of[SHAPES[0]]
    after = host_us(lambda: ht2.hamming_top2(*x))
    print(f"[bench] {SHAPES[0][0]}x{SHAPES[0][1]} default: wrapper host "
          f"{after:.2f} us per call after the profiler sessions ({smi})",
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "host_parts_us": parts,
                       "host_us_after_profiling": after, "rows": rows},
                      f, indent=1)


if __name__ == "__main__":
    main()
