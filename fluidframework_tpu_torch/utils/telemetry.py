"""The process-wide metrics registry: counters, gauges and latency
histograms.

The durable log (``server/oplog.py``, ``server/native_oplog.py``) and
the serving engines' append and summary seams bump its counters
(``oplog_appends``, ``oplog_spill_lines``, ``oplog_spill_bytes``,
``oplog_torn_tails_recovered``, ``oplog_chain_verify_failures_total``,
``fenced_appends_rejected_total``). The columnar front door
(``server/columnar_ingress.py``) counts its drain passes, windows and
throttled ops, gauges its paused readers, and observes the per-stage
latency histograms of its windows (``server/opsd.py``), the end-to-end
one with a trace exemplar, into :data:`REGISTRY` and into a registry of
its own that ``opsd.latency_breakdown`` reads.

A component keeps a registry of its own (``MetricsCollector``) and
``attach``-es it to :data:`REGISTRY` under a name and optional labels
(the serving service's replica counters and its per-partition consume
collectors). Structured events go through a :class:`TelemetryLogger` to
a host-provided sink (``BufferSink`` collects them in memory). The full
snapshot and Prometheus rendering wait for the ops endpoint.
"""

from __future__ import annotations

import bisect
import weakref
from typing import Any, Callable, Dict, List, Optional

# event category (reference: ITelemetryBaseEvent.category)
WARNING = "warning"   # degraded-but-serving conditions (shed load, stalls)

Sink = Callable[[dict], None]


class TelemetryLogger:
    """Namespaced structured logger (reference: ITelemetryLoggerExt).
    Events are flat dicts ``{category, eventName, ...props}``; namespaces
    chain with ``:``. With no sink an event goes nowhere."""

    def __init__(self, sink: Optional[Sink] = None, namespace: str = ""):
        self._sink = sink
        self.namespace = namespace

    def send(self, category: str, event_name: str, **props) -> None:
        name = f"{self.namespace}:{event_name}" if self.namespace \
            else event_name
        if self._sink is not None:
            self._sink({"category": category, "eventName": name, **props})

    def send_warning(self, event_name: str, **props) -> None:
        """Degradation events: the system still serves but sheds load or
        runs slow (replica overflow); they must be visible."""
        self.send(WARNING, event_name, **props)


class Histogram:
    """Fixed-bucket latency histogram with percentile reads.

    ``observe(value, exemplar=...)`` also keeps the worst *exemplar*, a
    (value, trace id, span id) triple, so a slow percentile can name the
    trace of its worst sampled window."""

    def __init__(self, buckets_ms: Optional[List[float]] = None):
        # log-spaced defaults covering 10 µs .. 10 s
        self.bounds = buckets_ms if buckets_ms is not None else [
            0.01 * (10 ** (i / 4)) for i in range(25)]
        self.counts = [0] * (len(self.bounds) + 1)
        self.n = 0
        #: running sum of observed values: exact per-stage means
        self.sum_ms = 0.0
        #: the exemplar with the largest value observed
        self.worst_exemplar: Optional[tuple] = None

    def record(self, value_ms: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value_ms)] += 1
        self.n += 1
        self.sum_ms += value_ms

    @property
    def mean(self) -> float:
        """Exact mean of observed values (0.0 when empty)."""
        return self.sum_ms / self.n if self.n else 0.0

    def observe(self, value_ms: float, exemplar: Any = None) -> None:
        """Record a sample; ``exemplar`` may be a ``TraceContext``
        (``trace_id`` / ``span_id``) naming the sample's trace."""
        self.record(value_ms)
        if exemplar is None:
            return
        if self.worst_exemplar is None or value_ms >= self.worst_exemplar[0]:
            self.worst_exemplar = (value_ms, exemplar.trace_id,
                                   exemplar.span_id)

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket holding the p-th percentile; ``inf``
        when it lands in the overflow bucket past the last bound."""
        if self.n == 0:
            return 0.0
        target = p / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) \
                    else float("inf")
        return float("inf")

    @property
    def overflow(self) -> int:
        """Values past the last bucket bound."""
        return self.counts[-1]


#: the stage-attribution grid (``stage_*`` histograms): 16 log-spaced
#: buckets a decade from 0.1 ms out to ~100 s (a contended storm's
#: rx → ack timeline reaches tens of seconds)
_STAGE_BOUNDS = [0.1 * (10 ** (i / 16)) for i in range(97)]


def _buckets_for(name: str) -> Optional[List[float]]:
    return list(_STAGE_BOUNDS) if name.startswith("stage_") else None


class MetricsRegistry:
    """Counters, gauges and latency histograms: the analog of the
    reference server's per-lambda Prometheus metrics."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        # key -> weakref to an attached component registry (components
        # come and go; the process registry must not keep them alive)
        self._components: Dict[str, Any] = {}
        # key -> label dict of a label-qualified attachment
        self._component_labels: Dict[str, Dict[str, str]] = {}

    # ----------------------------------------------------------- recording

    def inc(self, name: str, by: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + by

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value_ms: float,
                exemplar: Any = None) -> None:
        if name not in self.histograms:
            self.histograms[name] = Histogram(_buckets_for(name))
        self.histograms[name].observe(value_ms, exemplar=exemplar)

    # ---------------------------------------------------------- components

    @staticmethod
    def component_key(name: str, labels: Optional[Dict[str, Any]]) -> str:
        """``name`` bare, or ``name{k=v,...}`` with sorted label keys."""
        if not labels:
            return name
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        return f"{name}{{{inner}}}"

    def attach(self, name: str, registry: "MetricsRegistry",
               labels: Optional[Dict[str, Any]] = None) -> str:
        """Register a component's own registry under ``name`` (qualified
        by ``labels``). A key held by another live registry gets a
        numeric suffix on the name (``name2``, ...). Returns the key."""
        base, i = name, 1
        while True:
            key = self.component_key(name, labels)
            ref = self._components.get(key)
            if ref is None or ref() is None or ref() is registry:
                break
            i += 1
            name = f"{base}{i}"
        self._components[key] = weakref.ref(registry)
        if labels:
            self._component_labels[key] = {
                k: str(v) for k, v in labels.items()}
        return key

    def components(self) -> Dict[str, "MetricsRegistry"]:
        """The live attached registries by key (dead ones are dropped)."""
        live = {}
        for key, ref in list(self._components.items()):
            reg = ref()
            if reg is None:
                del self._components[key]
                self._component_labels.pop(key, None)
            else:
                live[key] = reg
        return live

    def component_labels(self, key: str) -> Dict[str, str]:
        """Labels a component was attached with (empty for bare names)."""
        return dict(self._component_labels.get(key, {}))

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> Dict[str, Any]:
        """Counters and gauges by name, and per histogram ``_p50_ms`` /
        ``_p99_ms`` / ``_count`` / ``_overflow``."""
        out: Dict[str, Any] = dict(self.counters)
        out.update(self.gauges)
        for name, h in self.histograms.items():
            out[f"{name}_p50_ms"] = h.percentile(50)
            out[f"{name}_p99_ms"] = h.percentile(99)
            out[f"{name}_count"] = h.n
            out[f"{name}_overflow"] = h.overflow
        return out


#: a component's own collector is a registry
MetricsCollector = MetricsRegistry

#: the process-wide registry
REGISTRY = MetricsRegistry()


class BufferSink:
    """Test / inspection sink: collects events in memory."""

    def __init__(self):
        self.events: List[dict] = []

    def __call__(self, event: dict) -> None:
        self.events.append(event)

    def named(self, suffix: str) -> List[dict]:
        return [e for e in self.events
                if e["eventName"].endswith(suffix)]
