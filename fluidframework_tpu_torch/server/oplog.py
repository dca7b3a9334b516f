"""Partitioned, ordered op log — the Kafka analog, in memory.

Reference counterpart: Kafka as Routerlicious' ordering backbone: topics
are partitioned, each partition is an ordered log, documents map to
partitions by a stable hash.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional


class OplogCorruptionError(ValueError):
    """The log no longer holds the history a summary was cut from (it is
    shorter than the summary's offset): replaying its tail would silently
    serve a different history."""


def partition_of(doc_id: str, n_partitions: int) -> int:
    """Stable doc → partition mapping (FNV-1a over the UTF-8 id)."""
    h = 2166136261
    for ch in doc_id.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h % n_partitions


class PartitionedLog:
    """In-memory partitioned log. Each partition has its own lock, so
    appends to different partitions never contend."""

    def __init__(self, n_partitions: int = 8):
        self.n_partitions = n_partitions
        self._parts: List[List[Any]] = [[] for _ in range(n_partitions)]
        self._plocks = [threading.Lock() for _ in range(n_partitions)]

    def append(self, partition: int, record: Any) -> int:
        """Append; returns the record's offset."""
        with self._plocks[partition]:
            part = self._parts[partition]
            part.append(record)
            return len(part) - 1

    def read(self, partition: int, from_offset: int = 0,
             to_offset: Optional[int] = None) -> List[Any]:
        with self._plocks[partition]:
            return list(self._parts[partition][from_offset:to_offset])

    def size(self, partition: int) -> int:
        with self._plocks[partition]:
            return len(self._parts[partition])
