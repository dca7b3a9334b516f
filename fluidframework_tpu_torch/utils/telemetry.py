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
its own that ``opsd.latency_breakdown`` reads. Component attachment,
the full snapshot and Prometheus rendering wait for the ops endpoint.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional


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


#: the process-wide registry
REGISTRY = MetricsRegistry()
