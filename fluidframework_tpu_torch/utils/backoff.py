"""Retry backoff with decorrelated jitter.

:class:`Backoff` yields *decorrelated jitter* delays (``sleep = min(cap,
uniform(base, 3 * prev))``), so a herd of reconnecting clients spreads
out instead of retrying in lockstep, and counts every delay it hands out
under its own metric name. :func:`retry` is the loop around it; the
columnar client's ``connect_with_backoff`` connects through it.

Deterministic under a seeded ``random.Random``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, TypeVar

T = TypeVar("T")


class Backoff:
    """Decorrelated-jitter delay source.

    ``base``    first/minimum delay (seconds)
    ``cap``     hard ceiling per delay (seconds)
    ``rng``     ``random.Random`` for jitter (shared module rng when None)
    ``metric``  counter name inc'd on every consumed delay (observability
                hook: bind retries, connect backoffs, session reconnects
                all count under their own name)
    ``registry``metrics registry exposing ``inc(name)``; resolved lazily
                to the global registry when None so importing this module
                never drags in telemetry
    """

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 rng: Optional[random.Random] = None,
                 metric: Optional[str] = None, registry=None):
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap, got {base}, {cap}")
        self.base = base
        self.cap = cap
        self.rng = rng or random
        self.metric = metric
        self._registry = registry
        self._prev = base

    def reset(self) -> None:
        """Back to the first-attempt delay (call after a success so the
        next failure episode starts cheap)."""
        self._prev = self.base

    def next_delay(self) -> float:
        """The next sleep, decorrelated-jittered, counted if a metric
        name was bound."""
        delay = min(self.cap, self.rng.uniform(self.base, self._prev * 3))
        self._prev = max(self.base, delay)
        if self.metric:
            reg = self._registry
            if reg is None:
                from .telemetry import REGISTRY as reg
            reg.inc(self.metric)
        return delay

    def delays(self, attempts: int) -> Iterator[float]:
        """``attempts`` consecutive delays (a fresh episode)."""
        self.reset()
        for _ in range(max(0, attempts)):
            yield self.next_delay()


def retry(fn: Callable[[], T], attempts: int = 8,
          exceptions: tuple = (OSError,),
          backoff: Optional[Backoff] = None,
          sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn`` until it returns, sleeping a jittered delay between
    failures; the last exception propagates after ``attempts`` tries.
    ``sleep`` is injectable so tests (and async shims) control time."""
    bo = backoff or Backoff()
    bo.reset()
    last: Optional[BaseException] = None
    for i in range(max(1, attempts)):
        try:
            return fn()
        except exceptions as e:       # noqa: PERF203 — retry loop
            last = e
            if i + 1 < attempts:
                sleep(bo.next_delay())
    assert last is not None
    raise last
