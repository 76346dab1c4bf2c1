"""Asynchronous tracking/mapping pipeline.

Port of ``orbslam2_tpu/runtime/pipeline.py``.  The reference runs
Tracking in the caller's thread and LocalMapping + LoopClosing in their
own threads, talking through keyframe queues and interrupt flags
(System.cc:104-112, LocalMapping::mlNewKeyFrames, mbAbortBA).  Here:

  * tracking runs on the caller's thread; local mapping and loop closing
    run on one worker thread behind the native token queue
    (``runtime/native.py`` over csrc/slamrt.cpp), with the job payloads
    handed over in a dict;
  * backpressure: NeedNewKeyFrame consults the worker's idleness (c1b
    needs an idle mapper; a busy one has its BA interrupted and takes a
    keyframe only while fewer than 3 wait), and the worker skips local BA
    when more keyframes are waiting (LocalMapping.cc:624-627);
  * tracking never folds its visible/found counters into the map: it sums
    them on the device between keyframes and hands the sums over with the
    next keyframe (the reference updates them per frame under the map
    mutex).

On the card the worker issues its work on its own CUDA stream, so that
its host reads (the mapping step's stats) wait for its own kernels and
not for the tracking thread's, and the two overlap on the device.
PyTorch's side streams do not synchronise with the default stream, so
every tensor that crosses between the threads is handed over explicitly
(``device.handoff``: an event recorded by the producer on its stream, a
wait on it by the consumer's stream, and ``record_stream`` so that the
caching allocator does not give the block to the producer's stream while
the consumer may still read it):

  (a) tracking → worker: the keyframe job (frame data, pose,
      associations, counter sums), with an event recorded when it is
      queued;
  (b) the map: ``ms`` and ``ref_kf`` are one published pair with the event
      of the stream that wrote it, swapped as one reference; a thread
      makes its stream wait on a pair another thread published before it
      first reads it (the tracking thread at the start of a frame, the
      worker at the start of a job); relocalization hands the keyframe DB
      over the same way;
  (c) worker ↔ global BA thread: in ``runtime/gba.py``;
  (d) ``shutdown``: after the join, the caller's stream waits on the
      worker's stream before the last global BA is merged.

An exception on the worker is kept and raised on the tracking thread's
next ``track_*`` call and in ``shutdown`` (the JAX worker dies silently).
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict, NamedTuple, Optional

import torch

from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.models import map_state as M
from orbslam2_tpu_torch.runtime import device as device_mod
from orbslam2_tpu_torch.runtime.native import InterruptFlag, TokenQueue
from orbslam2_tpu_torch.runtime.slam import SlamEngine


class _Published(NamedTuple):
    ms: M.MapState
    ref_kf: int
    ready: Optional[torch.cuda.Event]   # the writer's stream, after ms


class AsyncSlamEngine(SlamEngine):
    """Pipeline-parallel engine: call ``track_*`` from the tracking thread,
    mapping work happens concurrently.  Call ``start()`` first,
    ``shutdown()`` at the end (drains the queue).  On the CUDA card unless
    ``device`` says otherwise (``device="cpu"``)."""

    def __init__(self, cfg: SlamConfig, enable_loop_closing: bool = True,
                 vocabulary=None, queue_capacity: int = 8, device=None):
        self._published: Optional[_Published] = None
        self._local = threading.local()   # the pair this thread last took
        super().__init__(cfg, enable_loop_closing=enable_loop_closing,
                         device=device, vocabulary=vocabulary)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.kf_queue = TokenQueue(queue_capacity)
        self.abort_ba = InterruptFlag()
        self._jobs: Dict[int, tuple] = {}
        self._jobs_lock = threading.Lock()
        self._token = 0
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._worker_busy = False
        self._error: Optional[Exception] = None
        self._pending_vis = None   # accumulated counter sums (device)
        self._pending_found = None

    # ------------------------------------------------ the published map
    @property
    def ms(self) -> M.MapState:
        return self._take().ms

    @ms.setter
    def ms(self, value: M.MapState) -> None:
        pub = self._published
        self._publish(value, 0 if pub is None else pub.ref_kf)

    @property
    def ref_kf(self) -> int:
        return self._take().ref_kf

    @ref_kf.setter
    def ref_kf(self, value: int) -> None:
        self._publish(self._take().ms, value)

    def _publish(self, ms: M.MapState, ref_kf: int) -> None:
        """Swap in a new (map, reference keyframe) pair made on this
        thread's current stream."""
        pub = _Published(ms, int(ref_kf), device_mod.mark(self.device))
        self._published = pub
        self._local.seen = pub

    def _take(self) -> _Published:
        """The latest pair; this thread's stream waits on it the first
        time it sees it (handoff (b))."""
        pub = self._published
        if getattr(self._local, "seen", None) is not pub:
            device_mod.handoff(pub.ms, pub.ready)
            self._local.seen = pub
        return pub

    def _map_and_ref(self):
        pub = self._take()
        return pub.ms, pub.ref_kf

    # ------------------------------------------------------------ control
    def start(self) -> None:
        self._running = True
        self._worker = threading.Thread(target=self._mapping_loop,
                                        name="local-mapping", daemon=True)
        self._worker.start()

    def shutdown(self, timeout: float = 120.0) -> None:
        """RequestFinish + join (LocalMapping.cc:731-755), then the caller's
        stream waits on the worker's (handoff (d)) and a background global
        BA is drained (System::Shutdown, System.cc:435-439).  Raises a
        worker failure, and a worker still running after ``timeout``."""
        self._running = False
        self.kf_queue.close()
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                raise RuntimeError(f"the mapping worker did not finish "
                                   f"within {timeout} s")
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self._raise_worker_error()
        self.finish_gba()

    def _raise_worker_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("the mapping worker failed") from self._error

    # -------------------------------------------------- tracking overrides
    def _track_common(self, pair, timestamp: float):
        self._raise_worker_error()
        return super()._track_common(pair, timestamp)

    def _absorb_track(self, ms, res) -> None:
        """Accumulate on the device; the worker folds the sums in at the
        next keyframe insertion (tracking never writes the map)."""
        if self._pending_vis is None:
            self._pending_vis = res.visible_mask.to(torch.int32)
            self._pending_found = res.found_mask.to(torch.int32)
        else:
            self._pending_vis = self._pending_vis + res.visible_mask
            self._pending_found = self._pending_found + res.found_mask

    def _relocalize(self, fd):
        """Relocalization against the keyframe DB as the worker last left
        it: read once, then handed over from the worker's stream."""
        db = self.loop_closer.db
        device_mod.handoff(db, device_mod.mark(self.device, self._stream))
        return self.loop_closer.relocalize(self.ms, fd, db)

    def _mapper_idle(self) -> bool:
        return self.kf_queue.size() == 0 and not self._worker_busy

    def _mapping_queue_len(self) -> int:
        return self.kf_queue.size()

    def _interrupt_ba(self) -> None:
        self.abort_ba.set(1)

    def _counter_args(self):
        vis, found = self._pending_vis, self._pending_found
        self._pending_vis = None
        self._pending_found = None
        if vis is None:
            return self._zeros_p, self._zeros_p
        return vis, found

    def _create_keyframe(self, fd, res, timestamp: float) -> None:
        """Queue instead of mapping inline (Tracking::CreateNewKeyFrame →
        LocalMapping::InsertKeyFrame, Tracking.cc:1162 / LocalMapping.cc:
        114), with an event for handoff (a)."""
        tok = self._token
        self._token += 1
        counters = self._counter_args()
        with self._jobs_lock:
            self._jobs[tok] = (fd, res.Tcw, res.assoc, self.frame_id,
                               timestamp, counters,
                               device_mod.mark(self.device))
        self.abort_ba.set(1)             # interrupt a running local BA
        self.kf_queue.push(tok)
        self.last_kf_frame_id = self.frame_id

    # ------------------------------------------------------ mapping worker
    def _mapping_loop(self) -> None:
        try:
            # torch's current stream is per thread: enter it here
            with torch.cuda.stream(self._stream):
                while True:
                    tok = self.kf_queue.pop(timeout_ms=200)
                    if tok is None:
                        if not self._running and self.kf_queue.size() == 0:
                            return
                        continue
                    self._worker_busy = True
                    try:
                        self._map_job(tok)
                    finally:
                        self._worker_busy = False
        except Exception as e:   # the thread's boundary: kept for the
            # tracking thread, which raises it at its next call
            self._error = e

    def _map_job(self, tok: int) -> None:
        with self._jobs_lock:
            job = self._jobs.pop(tok)
        fd, Tcw, assoc, frame_id, ts, counters, ready = job
        device_mod.handoff((fd, Tcw, assoc, counters), ready)
        if not self._free_kf_slots:
            if not self._capacity_warned:
                warnings.warn("keyframe capacity exhausted in the async "
                              "worker: dropping a queued keyframe",
                              RuntimeWarning)
                self._capacity_warned = True
            return
        kf_slot = self._take_kf_slot()
        # local BA unless newer keyframes are waiting (mbAbortBA)
        self.abort_ba.consume()
        ba_ok = self.kf_queue.size() == 0
        ms, parent = self._map_and_ref()
        ms = self._run_mapping_step(ms, fd, Tcw, assoc, kf_slot, parent,
                                    frame_id, ts, ba_ok=ba_ok,
                                    counters=counters)
        if self.loop_closer is not None:
            ms, closed = self.loop_closer.on_keyframe(ms, kf_slot,
                                                      self.kf_ordinal)
            ms, _ = self.loop_closer.gba.poll_and_merge(ms)
            if closed:
                self.stats["loops_closed"] += 1
        self._publish(ms, kf_slot)
