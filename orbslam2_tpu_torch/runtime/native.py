# Copy of orbslam2_tpu/runtime/native.py (ctypes over csrc/libslamrt.so,
# with a pure-Python fallback): the JAX package imports jax on import,
# which the GPU host does not have.  tests/test_torch_copies.py holds it
# equal.  From here the library path also resolves to the repository's
# csrc/libslamrt.so.
"""ctypes bindings for the native runtime core (csrc/slamrt.cpp).

Provides the reference's C++ runtime primitives — token queues
(LocalMapping::mlNewKeyFrames), interrupt flags (mbAbortBA/mbStopGBA),
steady-clock stage timers — with a pure-Python fallback so the framework
works before ``make -C csrc`` has run.
"""

from __future__ import annotations

import ctypes
import os
import queue as pyqueue
import threading
import time
from typing import List, Optional

_SO_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                 "libslamrt.so"),
    os.path.join(os.path.dirname(__file__), "libslamrt.so"),
]


def _load() -> Optional[ctypes.CDLL]:
    for p in _SO_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.slamrt_queue_new.restype = ctypes.c_void_p
            lib.slamrt_queue_new.argtypes = [ctypes.c_uint64]
            lib.slamrt_queue_free.argtypes = [ctypes.c_void_p]
            lib.slamrt_queue_push.restype = ctypes.c_int32
            lib.slamrt_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.slamrt_queue_push_latest.restype = ctypes.c_int32
            lib.slamrt_queue_push_latest.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_uint64]
            lib.slamrt_queue_pop.restype = ctypes.c_int32
            lib.slamrt_queue_pop.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.slamrt_queue_size.restype = ctypes.c_uint64
            lib.slamrt_queue_size.argtypes = [ctypes.c_void_p]
            lib.slamrt_queue_close.argtypes = [ctypes.c_void_p]
            lib.slamrt_flag_new.restype = ctypes.c_void_p
            lib.slamrt_flag_free.argtypes = [ctypes.c_void_p]
            lib.slamrt_flag_set.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.slamrt_flag_get.restype = ctypes.c_uint32
            lib.slamrt_flag_get.argtypes = [ctypes.c_void_p]
            lib.slamrt_flag_consume.restype = ctypes.c_uint32
            lib.slamrt_flag_consume.argtypes = [ctypes.c_void_p]
            lib.slamrt_timer_new.restype = ctypes.c_void_p
            lib.slamrt_timer_free.argtypes = [ctypes.c_void_p]
            lib.slamrt_timer_start.argtypes = [ctypes.c_void_p]
            lib.slamrt_timer_stop.restype = ctypes.c_double
            lib.slamrt_timer_stop.argtypes = [ctypes.c_void_p]
            lib.slamrt_timer_count.restype = ctypes.c_uint64
            lib.slamrt_timer_count.argtypes = [ctypes.c_void_p]
            lib.slamrt_timer_stats.argtypes = [ctypes.c_void_p,
                                               ctypes.POINTER(ctypes.c_double)]
            return lib
    return None


_LIB = _load()


def have_native() -> bool:
    return _LIB is not None


class TokenQueue:
    """Bounded MPMC queue of opaque uint64 tokens."""

    def __init__(self, capacity: int = 64):
        if _LIB is not None:
            self._h = _LIB.slamrt_queue_new(capacity)
            self._native = True
        else:
            self._q: pyqueue.Queue = pyqueue.Queue(maxsize=capacity)
            self._closed = False
            self._native = False

    def push(self, token: int) -> bool:
        if self._native:
            return _LIB.slamrt_queue_push(self._h, token) == 0
        try:
            self._q.put(token)
            return True
        except Exception:
            return False

    def push_latest(self, token: int) -> bool:
        """Push, dropping the oldest if full.  Returns True if dropped."""
        if self._native:
            return _LIB.slamrt_queue_push_latest(self._h, token) == 1
        dropped = False
        while True:
            try:
                self._q.put_nowait(token)
                return dropped
            except pyqueue.Full:
                try:
                    self._q.get_nowait()
                    dropped = True
                except pyqueue.Empty:
                    pass

    def pop(self, timeout_ms: int = -1) -> Optional[int]:
        if self._native:
            out = ctypes.c_uint64(0)
            rc = _LIB.slamrt_queue_pop(self._h, timeout_ms, ctypes.byref(out))
            return int(out.value) if rc == 0 else None
        try:
            if self._closed and self._q.empty():
                return None
            t = None if timeout_ms < 0 else timeout_ms / 1000.0
            return self._q.get(timeout=t)
        except pyqueue.Empty:
            return None

    def size(self) -> int:
        if self._native:
            return int(_LIB.slamrt_queue_size(self._h))
        return self._q.qsize()

    def close(self):
        if self._native:
            _LIB.slamrt_queue_close(self._h)
        else:
            self._closed = True

    def __del__(self):
        if getattr(self, "_native", False) and _LIB is not None:
            _LIB.slamrt_queue_free(self._h)


class InterruptFlag:
    """mbAbortBA-style interrupt cell."""

    def __init__(self):
        if _LIB is not None:
            self._h = _LIB.slamrt_flag_new()
            self._native = True
        else:
            self._v = 0
            self._lock = threading.Lock()
            self._native = False

    def set(self, v: int = 1):
        if self._native:
            _LIB.slamrt_flag_set(self._h, v)
        else:
            with self._lock:
                self._v = v

    def get(self) -> int:
        if self._native:
            return int(_LIB.slamrt_flag_get(self._h))
        with self._lock:
            return self._v

    def consume(self) -> int:
        if self._native:
            return int(_LIB.slamrt_flag_consume(self._h))
        with self._lock:
            v, self._v = self._v, 0
            return v

    def __del__(self):
        if getattr(self, "_native", False) and _LIB is not None:
            _LIB.slamrt_flag_free(self._h)


class StageTimer:
    """Per-stage latency recorder (benchmark.cc per-frame duration logs)."""

    def __init__(self):
        if _LIB is not None:
            self._h = _LIB.slamrt_timer_new()
            self._native = True
        else:
            self._samples: List[float] = []
            self._t0 = 0.0
            self._native = False

    def start(self):
        if self._native:
            _LIB.slamrt_timer_start(self._h)
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._native:
            return float(_LIB.slamrt_timer_stop(self._h))
        ms = (time.perf_counter() - self._t0) * 1e3
        self._samples.append(ms)
        return ms

    def stats(self):
        """(mean, median, min, max) in ms."""
        if self._native:
            out = (ctypes.c_double * 4)()
            _LIB.slamrt_timer_stats(self._h, out)
            return tuple(out)
        if not self._samples:
            return (0.0, 0.0, 0.0, 0.0)
        s = sorted(self._samples)
        return (sum(s) / len(s), s[len(s) // 2], s[0], s[-1])

    def count(self) -> int:
        if self._native:
            return int(_LIB.slamrt_timer_count(self._h))
        return len(self._samples)

    def __del__(self):
        if getattr(self, "_native", False) and _LIB is not None:
            _LIB.slamrt_timer_free(self._h)
