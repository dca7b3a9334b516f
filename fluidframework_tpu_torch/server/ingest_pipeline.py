"""Pipelined columnar-ingest executor: overlap pack / sequence+dispatch /
log across waves.

``StringServingEngine.ingest_planes`` is a serial walk of four stages —
prepare/pack → sequence → dispatch → log — whose host walls add up. This
executor runs the SAME stage methods on three worker threads so the stage
sum becomes a max:

- **pack worker** — ``_ingest_prepare(prepack=True)``: validation + the
  interner/table build, FIFO, for wave N+1 while wave N is on the device.
  A wave that could not be prepacked (a tree wave on the dense path, whose
  table handles mint at dispatch) holds the worker until that wave has
  dispatched, so handles are minted in submission order;
- **seq/dispatch worker** — ``_ingest_sequence`` + ``_ingest_dispatch``:
  the native sequencing call and the asynchronous kernel launch share one
  thread (they share the sequencer and the compaction cursor). Kernels
  launch on that thread's current CUDA stream;
- **log worker** — ``_ingest_log``: the whole-batch log append, after
  which the wave's ticket resolves (the ack-safe point). A wave whose
  deferred overflow read shows an overflowed doc marks recovery due;
  ``drain`` runs it once no wave is in flight.

In-flight depth is bounded: ``submit`` blocks while ``depth`` waves are
packing, sequenced or unlogged. Stages are FIFO per worker, so sequencing
order == submission order == log order, and payload-handle allocation
matches the serial path. Failure is fail-stop: the first stage exception
fails that wave's ticket and every younger wave; the executor then refuses
new submits.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

_STOP = object()

#: stage names for the occupancy clock
_STAGES = ("pack", "seq_dispatch", "log")


class StageClock:
    """Per-stage busy-time accounting: ``overlap()`` (summed busy time over
    the clock's open span) above 1.0 shows that stages ran concurrently."""

    def __init__(self, stages):
        self.stages = tuple(stages)
        self.busy_ms: Dict[str, float] = {s: 0.0 for s in self.stages}
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def add(self, stage: str, ms: float) -> None:
        with self._lock:
            self.busy_ms[stage] += ms

    def overlap(self) -> float:
        span = (time.perf_counter() - self._t0) * 1000 or 1.0
        with self._lock:
            return sum(self.busy_ms.values()) / span


class IngestTicket:
    """Handle for one submitted wave: resolves with ``ingest_planes``'s
    result dict after the wave's log append commits, or with the stage
    exception. ``add_done_callback`` runs on the resolving worker thread
    (the columnar front door bounces acks back to its event loop)."""

    __slots__ = ("index", "_event", "_result", "_error", "wave", "t_done",
                 "_dispatched", "_callbacks", "_lock")

    def __init__(self, index: int):
        self.index = index
        self.wave = None
        # set once the wave has dispatched (or failed): the pack worker's
        # barrier behind a wave it could not prepack
        self._dispatched = threading.Event()
        #: perf_counter() when the ticket resolved (per-wave wall)
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._result: Optional[dict] = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable[["IngestTicket"], None]] = []
        self._lock = threading.Lock()

    def error(self) -> Optional[BaseException]:
        return self._error

    def add_done_callback(self, fn: Callable[["IngestTicket"], None]
                          ) -> None:
        """Call ``fn(ticket)`` once the wave resolves (now, if it has)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until the wave's log append commits; raises the stage
        exception on a failed wave."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"wave {self.index} still in flight")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result: Optional[dict] = None,
                 error: Optional[BaseException] = None) -> None:
        with self._lock:
            self._result, self._error = result, error
            self.t_done = time.perf_counter()
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


class PipelinedIngestExecutor:
    """Bounded-depth staged pipeline over a ``StringServingEngine``'s
    columnar-ingest stage methods. One executor per engine; drain before
    mixing with the serial ``ingest_planes``."""

    def __init__(self, engine, depth: int = 2):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.engine = engine
        self.depth = depth
        self._sem = threading.BoundedSemaphore(depth)
        self._pack_q: "queue.Queue" = queue.Queue()
        self._seq_q: "queue.Queue" = queue.Queue()
        self._log_q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight = 0
        self._max_inflight = 0
        self._waves = 0
        self._failed_at: Optional[int] = None
        self._failure: Optional[BaseException] = None
        self._closed = False
        self.clock = StageClock(_STAGES)
        self._threads: List[threading.Thread] = [
            threading.Thread(target=fn, name=name, daemon=True)
            for fn, name in ((self._pack_worker, "ingest-pack"),
                             (self._seq_worker, "ingest-seq-dispatch"),
                             (self._log_worker, "ingest-log"))]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ public

    def submit(self, *args: Any, **kwargs: Any) -> IngestTicket:
        """Enqueue one wave (the arguments of ``ingest_planes``); blocks
        while ``depth`` waves are in flight."""
        if self._closed:
            raise RuntimeError("pipelined ingest executor is closed")
        if self._failure is not None:
            raise RuntimeError(
                "pipelined ingest executor failed; close it and rebuild "
                "the engine") from self._failure
        with self._lock:
            idle = self._inflight == 0
        if idle:
            # mid-flight the engine is poisoned BY DESIGN
            self.engine._check_poisoned()
        self._sem.acquire()
        with self._lock:
            ticket = IngestTicket(self._waves)
            self._waves += 1
            self._inflight += 1
            self._max_inflight = max(self._max_inflight, self._inflight)
        self._pack_q.put((ticket, args, kwargs))
        return ticket

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every in-flight wave has logged (or failed); then
        run the overflow recovery a wave's log stage marked due (recovery
        replays the log, so it needs no wave in flight). Raises the first
        stage failure.

        Detection is one compaction late (the deferred flag copy), so a
        caller that needs every doc healed calls the engine's
        ``recover_overflowed()`` once more after this."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._inflight == 0,
                                       timeout):
                raise TimeoutError("pipelined ingest drain timed out")
        eng = self.engine
        if self._failure is None and eng._ov_recover_due:
            eng._ov_recover_due = False
            eng.recover_overflowed()
        if self._failure is not None:
            raise RuntimeError(
                f"pipelined ingest failed at wave {self._failed_at}"
            ) from self._failure

    def close(self, timeout: float = 30.0) -> None:
        """Drain (best effort) and stop the workers."""
        if self._closed:
            return
        self._closed = True
        try:
            self.drain(timeout=timeout)
        except (RuntimeError, TimeoutError):
            pass
        self._pack_q.put(_STOP)
        for t in self._threads:
            t.join(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            return {"waves": self._waves, "depth": self.depth,
                    "max_inflight": self._max_inflight,
                    "stage_busy_ms": dict(self.clock.busy_ms),
                    "overlap": self.clock.overlap()}

    # ----------------------------------------------------------- workers

    def _skip(self, ticket: IngestTicket) -> bool:
        """True when an older wave already failed (fail-stop)."""
        return self._failed_at is not None and ticket.index > \
            self._failed_at

    def _fail(self, ticket: IngestTicket, error: BaseException) -> None:
        with self._lock:
            if self._failed_at is None or ticket.index < self._failed_at:
                self._failed_at, self._failure = ticket.index, error
        self._finish(ticket, error=error)

    def _finish(self, ticket: IngestTicket, result: Optional[dict] = None,
                error: Optional[BaseException] = None) -> None:
        ticket._dispatched.set()   # release any pack-worker barrier
        ticket._resolve(result=result, error=error)
        self._sem.release()
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def _chain_error(self, ticket: IngestTicket) -> RuntimeError:
        err = RuntimeError(
            f"wave {ticket.index} aborted: wave {self._failed_at} "
            "failed earlier in the pipeline")
        err.__cause__ = self._failure
        return err

    def _stage(self, name: str, ticket: IngestTicket,
               fn: Callable[[], Any]):
        """Run one stage body, timing it: (True, its value), or (False,
        None) after failing the ticket."""
        t0 = time.perf_counter()
        try:
            value = fn()
        except BaseException as e:  # noqa: BLE001 — fail-stop
            self._fail(ticket, e)
            return False, None
        self.clock.add(name, (time.perf_counter() - t0) * 1000)
        return True, value

    def _pack_worker(self) -> None:
        eng = self.engine
        while True:
            item = self._pack_q.get()
            if item is _STOP:
                self._seq_q.put(_STOP)
                return
            ticket, args, kwargs = item
            if self._skip(ticket):
                self._finish(ticket, error=self._chain_error(ticket))
                continue
            ok, ticket.wave = self._stage(
                "pack", ticket,
                lambda: eng._ingest_prepare(*args, prepack=True, **kwargs))
            if ok:
                self._seq_q.put(ticket)
                if ticket.wave.prepacked is None:
                    # its interner writes happen at dispatch: packing the
                    # next wave's tables first would mint handles out of
                    # submission order
                    ticket._dispatched.wait()

    def _seq_worker(self) -> None:
        eng = self.engine
        while True:
            ticket = self._seq_q.get()
            if ticket is _STOP:
                self._log_q.put(_STOP)
                return
            if self._skip(ticket):
                self._finish(ticket, error=self._chain_error(ticket))
                continue

            def body():
                eng._ingest_sequence(ticket.wave)
                eng._ingest_dispatch(ticket.wave)

            if self._stage("seq_dispatch", ticket, body)[0]:
                ticket._dispatched.set()
                self._log_q.put(ticket)

    def _log_worker(self) -> None:
        eng = self.engine
        while True:
            ticket = self._log_q.get()
            if ticket is _STOP:
                return
            # no younger-failure skip: a wave that reached the log queue was
            # sequenced and dispatched before the failure, so it must log
            ok, result = self._stage("log", ticket,
                                     lambda: eng._ingest_log(ticket.wave))
            if ok:
                self._finish(ticket, result=result)

    def __enter__(self) -> "PipelinedIngestExecutor":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
