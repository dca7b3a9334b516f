"""The process-wide counter registry.

The durable log (``server/oplog.py``, ``server/native_oplog.py``) and
the serving engines' append and summary seams bump its counters
(``oplog_appends``, ``oplog_spill_lines``, ``oplog_spill_bytes``,
``oplog_torn_tails_recovered``, ``oplog_chain_verify_failures_total``,
``fenced_appends_rejected_total``); ``snapshot()`` reads them.
"""

from __future__ import annotations

from typing import Dict


class MetricsRegistry:
    """Named monotonic counters: the analog of the reference server's
    per-lambda Prometheus counters."""

    def __init__(self):
        self.counters: Dict[str, float] = {}

    def inc(self, name: str, by: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + by

    def snapshot(self) -> Dict[str, float]:
        """Every counter by name."""
        return dict(self.counters)


REGISTRY = MetricsRegistry()
