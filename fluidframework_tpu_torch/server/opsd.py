"""The door's operations pieces: per-stage latency attribution and the
hot-doc sketch.

* Latency attribution — :func:`observe_window_timeline` turns the
  monotonic crossing stamps the columnar front door and the ingest stages
  record onto each window (rx buffer → drain / decode → admission → pack
  → sequence → dispatch → log append → ack) into per-stage
  ``stage_*_ms`` histograms. Stages are consecutive segments of one
  timeline, so they sum to the observed end-to-end ack latency by
  construction; :func:`latency_breakdown` reads them back.
* :class:`SpaceSaving` — the bounded heavy-hitter sketch over ``(doc,
  tenant)`` the door's drain pass feeds; :func:`publish_hotdoc_gauges`
  rolls sketches up into the ``hotdoc_*`` gauges.

The reference's live HTTP plane (``OpsServer``: ``/metrics``,
``/healthz``, ``/debug/*``) is not ported yet.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils.telemetry import REGISTRY, MetricsRegistry

__all__ = ["SpaceSaving", "STAGES", "observe_window_timeline",
           "latency_breakdown", "publish_hotdoc_gauges"]


# --------------------------------------------------------------------------
# latency attribution
# --------------------------------------------------------------------------

#: canonical stage order of the ingest path; ``stage_{name}_ms``
#: histograms are consecutive segments of one monotonic timeline
STAGES = ("rx", "decode", "admit", "pack",
          "sequence", "dispatch", "log", "ack")


def observe_window_timeline(tl: dict, marks: dict, t_ack: float,
                            registry: Optional[MetricsRegistry] = None,
                            exemplar: Any = None) -> None:
    """Attribute one window's end-to-end ack latency to stages.

    ``tl`` is the front-door timeline the drain pass stamps
    (``t_rx``/``t_drain0``/``decode_ms``/``admit_ms``/``t_ready``),
    ``marks`` the executor-side crossings the engine's stage methods
    stamp (``pack1``/``seq1``/``disp1``/``log1``, absolute
    ``perf_counter`` seconds), ``t_ack`` the ack-fan time. Segment k is
    ``crossing[k+1] - crossing[k]`` with crossings clamped monotonic, so
    ``sum(stage_*_ms) == stage_e2e_ack_ms`` exactly — queue waits land
    in the stage that absorbed them (pack's segment includes the
    executor hand-off wait; ack's the done-callback bounce)."""
    t_rx = float(tl["t_rx"])
    t_ready = float(tl["t_ready"])
    admit_s = max(0.0, float(tl.get("admit_ms", 0.0))) * 1e-3
    crossings = [
        t_rx,
        float(tl["t_drain0"]),      # rx segment ends: drain pass starts
        t_ready - admit_s,          # decode ends where admission begins
        t_ready,                    # decoded + admitted, awaiting submit
        float(marks.get("pack1", t_ready)),
        float(marks.get("seq1", t_ready)),
        float(marks.get("disp1", t_ready)),
        float(marks.get("log1", t_ready)),
        float(t_ack),
    ]
    for i in range(1, len(crossings)):   # clock skew / missing marks
        if crossings[i] < crossings[i - 1]:
            crossings[i] = crossings[i - 1]
    reg = registry if registry is not None else REGISTRY
    for name, a, b in zip(STAGES, crossings, crossings[1:]):
        reg.observe(f"stage_{name}_ms", (b - a) * 1e3)
    reg.observe("stage_e2e_ack_ms", (crossings[-1] - crossings[0]) * 1e3,
                exemplar=exemplar)


def latency_breakdown(registry: Optional[MetricsRegistry] = None) -> dict:
    """Per-stage summary of the accumulated attribution histograms.

    ``stage_sum_ms`` (the sum of per-stage means) matches ``e2e_mean_ms``
    within clock-granularity tolerance whenever every observed window
    recorded all stages. The stage with the largest mean share is the
    next thing to scale out."""
    reg = registry if registry is not None else REGISTRY
    stages: Dict[str, dict] = {}
    stage_sum = 0.0
    for name in STAGES:
        h = reg.histograms.get(f"stage_{name}_ms")
        if h is None or h.n == 0:
            continue
        stages[name] = {"mean_ms": h.mean, "p50_ms": h.percentile(50),
                        "p99_ms": h.percentile(99), "count": h.n}
        stage_sum += h.mean
    e2e = reg.histograms.get("stage_e2e_ack_ms")
    e2e_mean = e2e.mean if e2e is not None and e2e.n else 0.0
    for name, row in stages.items():
        row["share"] = row["mean_ms"] / e2e_mean if e2e_mean else 0.0
    return {
        "stages": stages,
        "stage_sum_ms": stage_sum,
        "e2e_mean_ms": e2e_mean,
        "e2e_p99_ms": e2e.percentile(99) if e2e is not None else 0.0,
        "windows": e2e.n if e2e is not None else 0,
        "coverage": stage_sum / e2e_mean if e2e_mean else 0.0,
    }


# --------------------------------------------------------------------------
# heavy-hitter sketch
# --------------------------------------------------------------------------

class SpaceSaving:
    """Bounded Space-Saving heavy-hitter sketch (Metwally et al. 2005).

    Tracks at most ``capacity`` keys in O(capacity) memory. Estimated
    counts overestimate the true count by at most the entry's ``err``
    (the evicted minimum it inherited), and any key whose true count
    exceeds ``total / capacity`` is guaranteed to be tracked — exactly
    the guarantee a hot-doc router or eviction policy needs. Thread-safe:
    the drain pass offers from the ingress loop, the ops endpoint reads
    from scrape threads."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        #: key -> [count, err]
        self._entries: Dict[Any, List[int]] = {}
        self.total = 0
        self._lock = threading.Lock()

    def offer(self, key: Any, n: int = 1) -> None:
        with self._lock:
            self.total += n
            e = self._entries.get(key)
            if e is not None:
                e[0] += n
                return
            if len(self._entries) < self.capacity:
                self._entries[key] = [n, 0]
                return
            # evict the current minimum; the newcomer inherits its count
            # as the overestimation bound
            victim = min(self._entries, key=lambda k: self._entries[k][0])
            floor = self._entries.pop(victim)[0]
            self._entries[key] = [floor + n, floor]

    def top(self, k: int = 10) -> List[Tuple[Any, int, int]]:
        """``(key, estimated_count, err)`` rows, largest first.
        ``estimated_count - err`` is a guaranteed lower bound."""
        with self._lock:
            rows = sorted(self._entries.items(),
                          key=lambda kv: kv[1][0], reverse=True)
        return [(key, e[0], e[1]) for key, e in rows[:k]]

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.total = 0


def publish_hotdoc_gauges(sketches: List[SpaceSaving],
                          registry: Optional[MetricsRegistry] = None
                          ) -> None:
    """Roll the attached sketches up into the ``hotdoc_*`` gauges: how
    many keys are tracked, the hottest key's estimated ops, and its
    share of all sketched traffic — the skew signal at a glance."""
    reg = registry if registry is not None else REGISTRY
    tracked = sum(len(s) for s in sketches)
    total = sum(s.total for s in sketches)
    top = 0
    for s in sketches:
        rows = s.top(1)
        if rows:
            top = max(top, rows[0][1])
    reg.set_gauge("hotdoc_tracked", float(tracked))
    reg.set_gauge("hotdoc_top_count", float(top))
    reg.set_gauge("hotdoc_top_share", top / total if total else 0.0)
