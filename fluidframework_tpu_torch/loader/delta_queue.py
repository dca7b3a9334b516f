"""DeltaQueue: the ordered op pump with pause/resume and continuity checks.

Reference counterpart: ``DeltaQueue`` inside
``@fluidframework/container-loader`` (SURVEY.md §2.10, §3.2): inbound ops are
delivered strictly in sequence-number order; duplicates (overlap between the
catch-up tail read and the live stream) are dropped; out-of-order arrivals
are buffered until the gap fills; the queue can be paused (during catch-up or
summarizer load) and resumed without losing ordering.
"""

from __future__ import annotations

import heapq
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class DeltaQueue(Generic[T]):
    def __init__(self, handler: Callable[[T], None],
                 seq_of: Callable[[T], int], initial_seq: int = 0):
        self._handler = handler
        self._seq_of = seq_of
        self.last_seq = initial_seq
        self._heap: List[tuple] = []   # (seq, tiebreak, item)
        self._tiebreak = 0
        self._paused = 0
        self._draining = False
        self.dropped_duplicates = 0

    # ------------------------------------------------------------ flow control

    def pause(self) -> None:
        self._paused += 1

    def resume(self) -> None:
        assert self._paused > 0, "resume without matching pause"
        self._paused -= 1
        if self._paused == 0:
            self._drain()

    @property
    def paused(self) -> bool:
        return self._paused > 0

    @property
    def pending(self) -> int:
        return len(self._heap)

    # ----------------------------------------------------------------- intake

    def push(self, item: T) -> None:
        seq = self._seq_of(item)
        if seq <= self.last_seq:
            # tail-read / live-stream overlap: already processed
            self.dropped_duplicates += 1
            return
        self._tiebreak += 1
        heapq.heappush(self._heap, (seq, self._tiebreak, item))
        self._drain()

    def _drain(self) -> None:
        if self._paused or self._draining:
            return
        # re-entrancy guard: a handler may push (the local pipeline is
        # synchronous) — the outer drain loop picks those up
        self._draining = True
        try:
            while self._heap and not self._paused:
                seq = self._heap[0][0]
                if seq <= self.last_seq:
                    heapq.heappop(self._heap)
                    self.dropped_duplicates += 1
                    continue
                if seq != self.last_seq + 1:
                    break  # gap: wait for the tail fetch to fill it
                _, _, item = heapq.heappop(self._heap)
                self.last_seq = seq
                self._handler(item)
        finally:
            self._draining = False

    def has_gap(self) -> Optional[int]:
        """If blocked on a gap, the first missing seq; else None."""
        if self._heap and self._heap[0][0] > self.last_seq + 1:
            return self.last_seq + 1
        return None
