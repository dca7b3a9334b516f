"""Host span tracing: sampled root spans on the serving hot paths.

A :class:`TraceContext` (trace id + span id) names one node of a span
tree. :data:`TRACER` records completed spans into a bounded ring, and
parentage flows through a thread-local context stack, so nested spans
need no plumbing. The columnar front door opens a sampled root span
around one window in 256 (``maybe_root_span``) and hands its context to
the ack fan, which records the window's whole rx → ack span
(``record_complete``), so the end-to-end latency histogram's exemplar
names a real trace (``utils/telemetry.py``) whose spans :meth:`Tracer.events`
reads back.

The in-process service (``server/tinylicious.py``) carries a context
across its log hops as a 2-key wire dict (:meth:`TraceContext.to_wire`,
``current_wire()``): the raw-log record holds the submitter's context,
and the Deli and apply spans parent on it (a span's ``parent`` may be
that dict). The Chrome trace export waits for the ops endpoint.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class TraceContext:
    """One node of a span tree: (trace_id, span_id). Serializes to a
    2-key dict for log records."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_wire(self) -> dict:
        return {"tid": self.trace_id, "sid": self.span_id}

    @staticmethod
    def from_wire(d: Any) -> Optional["TraceContext"]:
        if isinstance(d, dict) and "tid" in d and "sid" in d:
            return TraceContext(d["tid"], d["sid"])
        return None

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}, {self.span_id})"


class Span:
    """A timed span, used as a context manager. While entered, it is the
    thread's current context: child spans parent to it."""

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 parent_id: Optional[int], args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.args = args
        self._ts_us: Optional[float] = None
        self._t0 = 0.0

    def annotate(self, **args: Any) -> "Span":
        """Attach args after entry (counters measured inside the span)."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._ts_us = time.time() * 1e6
        self._t0 = time.perf_counter()
        self.tracer._push(self.ctx)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.tracer._pop()
        event = {
            "name": self.name,
            "trace_id": self.ctx.trace_id,
            "span_id": self.ctx.span_id,
            "parent_id": self.parent_id,
            "ts": self._ts_us,
            "dur": (time.perf_counter() - self._t0) * 1e6,  # µs
            "tid": threading.get_ident(),
            "args": self.args,
        }
        if exc is not None:
            event["error"] = repr(exc)
        self.tracer._record(event)


class _NullSpan:
    """Unsampled stand-in: same surface, no recording."""

    ctx = None
    args: Dict[str, Any] = {}

    def annotate(self, **_args: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *_exc) -> None:
        pass


_NULL = _NullSpan()


class Tracer:
    """Process-wide span recorder: a bounded ring of completed span
    events plus a thread-local current-context stack."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._local = threading.local()
        self._sample_counters: Dict[str, int] = {}

    def new_trace_id(self) -> str:
        return f"{os.getpid():x}.{next(self._trace_ids):x}"

    # ---------------------------------------------------- context plumbing

    def _stack(self) -> List[TraceContext]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, ctx: TraceContext) -> None:
        self._stack().append(ctx)

    def _pop(self) -> None:
        stack = self._stack()
        if stack:
            stack.pop()

    def current(self) -> Optional[TraceContext]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _child_of(self, parent: Any):
        """(context, parent span id) of a new span under ``parent``: a
        :class:`TraceContext`, a wire dict, or None (under the current
        span, or a new trace)."""
        if parent is not None and not isinstance(parent, TraceContext):
            parent = TraceContext.from_wire(parent)
        if parent is None:
            parent = self.current()
        if parent is None:
            return TraceContext(self.new_trace_id(),
                                next(self._span_ids)), None
        return TraceContext(parent.trace_id,
                            next(self._span_ids)), parent.span_id

    # ------------------------------------------------------------ spanning

    def span(self, name: str, parent: Any = None, **args: Any) -> Span:
        """Open a span under ``parent`` (see ``_child_of``)."""
        ctx, parent_id = self._child_of(parent)
        return Span(self, name, ctx, parent_id, args)

    def maybe_root_span(self, name: str, every: int = 1024,
                        **args: Any) -> Any:
        """Sampled root span for server-only hot paths: a real span when
        a trace is already current, or on every ``every``-th call."""
        if self.current() is not None:
            return self.span(name, **args)
        n = self._sample_counters.get(name, 0)
        self._sample_counters[name] = n + 1
        if n % every == 0:
            return self.span(name, **args)
        return _NULL

    # ----------------------------------------------------------- recording

    def _record(self, event: dict) -> None:
        self._events.append(event)

    def record_complete(self, name: str, dur_ms: float,
                        parent: Any = None,
                        **args: Any) -> TraceContext:
        """Record an already-measured span ending now: one ring append.
        Returns its context."""
        ctx, parent_id = self._child_of(parent)
        now_us = time.time() * 1e6
        self._record({
            "name": name, "trace_id": ctx.trace_id,
            "span_id": ctx.span_id, "parent_id": parent_id,
            "ts": now_us - dur_ms * 1e3, "dur": dur_ms * 1e3,
            "tid": threading.get_ident(), "args": args,
        })
        return ctx

    def events(self, trace_id: Optional[str] = None) -> List[dict]:
        evs = list(self._events)
        if trace_id is not None:
            evs = [e for e in evs if e["trace_id"] == trace_id]
        return evs


#: the process tracer
TRACER = Tracer()


def span(name: str, parent: Any = None, **args: Any) -> Span:
    return TRACER.span(name, parent, **args)


def current_wire() -> Optional[dict]:
    """The current context as a wire dict, or None: what is stamped into
    log records at a serialization boundary."""
    ctx = TRACER.current()
    return ctx.to_wire() if ctx is not None else None

