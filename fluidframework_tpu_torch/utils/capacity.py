"""Capacity plane: host-byte estimates, the device-memory census and
idle-age tracking.

* :func:`record_nbytes` — the durable log (``server/oplog.py``) charges
  every record it keeps in memory at append time, so ``mem_stats()``
  reads precomputed per-partition byte counters and never walks the
  record lists. The constants are measured amortized costs of CPython
  3.10 on x86-64 (held against tracemalloc), not guesses.
* :class:`IdleAgeTracker` — a last-touch clock per doc row. The columnar
  front door stamps it from its drain pass with one vectorized scatter
  (``last[rows] = now``), no per-op cost.
* :class:`CapacityLedger` (:data:`LEDGER`) — stores and idle trackers
  register weakly; :meth:`CapacityLedger.census` rolls them up: device
  bytes by store (its state tensors' ``nbytes``), the card's allocator
  (``torch.cuda.memory_stats`` on each registered store's device), idle
  ages and the coldest rows. The reference's pull providers of host
  bytes and heaviest docs wait for an owner on the port's path that
  reports them.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import telemetry as _telemetry

#: amortized dict-table bytes per entry, EXCLUDING key/value objects
DICT_ENTRY_BYTES = 52
#: numpy array object header + base overhead beyond ``.nbytes``
NDARRAY_OVERHEAD_BYTES = 128
#: python object header of a small dataclass/record instance
RECORD_OVERHEAD_BYTES = 64


def record_nbytes(rec: Any) -> int:
    """Host bytes of one oplog in-memory tail record.

    Counts numpy plane payloads (the dominant cost of columnar
    records) plus a constant object overhead: the record's header, its
    field dict (a 64-byte table plus ``DICT_ENTRY_BYTES`` an entry) and
    ``NDARRAY_OVERHEAD_BYTES`` an array. Deliberately does NOT walk str
    fields: sequenced-message texts are shared references into the
    interner payload table, which already charges them — a second
    charge here would double-count against tracemalloc. Runs once an
    append, so the helpers are written inline."""
    d = getattr(rec, "__dict__", None)
    if d is None:
        if not hasattr(rec, "__dataclass_fields__"):
            return RECORD_OVERHEAD_BYTES
        d = {f: getattr(rec, f, None) for f in rec.__dataclass_fields__}
    if not d:
        return RECORD_OVERHEAD_BYTES
    total = RECORD_OVERHEAD_BYTES + 64 + DICT_ENTRY_BYTES * len(d)
    for v in d.values():
        if isinstance(v, np.ndarray):
            total += v.nbytes + NDARRAY_OVERHEAD_BYTES
    return total


def store_nbytes(store) -> int:
    """Device bytes of a store's state tensors."""
    return sum(t.numel() * t.element_size()
               for t in store.state.fields().values())


def device_census(devices) -> Dict[str, Any]:
    """The caching allocator's view of each CUDA device in ``devices``
    (``torch.cuda.memory_stats``): bytes held by live tensors and bytes
    reserved. ``available`` is False when none is a CUDA device."""
    out: Dict[str, Any] = {}
    for dev in sorted({torch.device(d) for d in devices}, key=str):
        if dev.type != "cuda":
            continue
        st = torch.cuda.memory_stats(dev)
        out[str(dev)] = {
            "allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
            "reserved_bytes": int(st.get("reserved_bytes.all.current", 0))}
    return {"available": bool(out), "devices": out,
            "total_bytes": sum(v["allocated_bytes"] for v in out.values())}


# --------------------------------------------------------------------------
# idle-age tracking
# --------------------------------------------------------------------------

class IdleAgeTracker:
    """Monotonic last-touch clock per doc row.

    ``touch(rows)`` is ONE numpy scatter (``last[rows] = now``) with the
    unique-row vector the drain pass already computes for the hot-doc
    sketch. Rows never touched are not resident (stamp < 0). The tracker
    grows on demand, so the door need not know the engine's capacity."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._last = np.full(0, -1.0, dtype=np.float64)
        self.touches = 0          # windows observed, not ops

    def ensure(self, n: int) -> None:
        if n > self._last.shape[0]:
            grown = np.full(max(n, 2 * self._last.shape[0] or 64), -1.0,
                            dtype=np.float64)
            grown[:self._last.shape[0]] = self._last
            self._last = grown

    def touch(self, rows: np.ndarray,
              now: Optional[float] = None) -> None:
        """Stamp ``rows`` as touched now: one vectorized scatter."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        self.ensure(int(rows.max()) + 1)
        self._last[rows] = self._clock() if now is None else now
        self.touches += 1

    def resident_rows(self) -> np.ndarray:
        return np.nonzero(self._last >= 0.0)[0]

    def ages(self, now: Optional[float] = None) -> np.ndarray:
        """Idle age in seconds of every touched row."""
        now = self._clock() if now is None else now
        return now - self._last[self._last >= 0.0]

    def coldest(self, k: int = 8,
                now: Optional[float] = None) -> List[Dict[str, float]]:
        """Top-``k`` longest-idle rows with the exact stamp of their
        last touch: "untouched since tick T", provably."""
        now = self._clock() if now is None else now
        rows = self.resident_rows()
        if rows.size == 0:
            return []
        stamps = self._last[rows]
        order = np.argsort(stamps, kind="stable")[:max(0, int(k))]
        return [{"row": int(rows[i]), "last_touch": float(stamps[i]),
                 "idle_s": float(now - stamps[i])} for i in order]

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        ages = self.ages(now)
        out: Dict[str, Any] = {"resident_rows": int(ages.size),
                               "touch_windows": int(self.touches)}
        if ages.size:
            out.update(
                idle_p50_s=float(np.percentile(ages, 50)),
                idle_p99_s=float(np.percentile(ages, 99)),
                idle_max_s=float(ages.max()))
        return out


def idle_age_histogram(ages_s: np.ndarray) -> _telemetry.Histogram:
    """A point-in-time ``Histogram`` of idle ages (seconds) filled in one
    vectorized pass: idle age is a level, so the census rebuilds it
    rather than re-observing resident rows into a cumulative one."""
    h = _telemetry.Histogram()
    ages = np.asarray(ages_s, dtype=np.float64)
    h.n = int(ages.size)
    h.sum_ms = float(ages.sum()) if ages.size else 0.0
    if ages.size:
        idx = np.searchsorted(np.asarray(h.bounds), ages, side="left")
        counts = np.bincount(idx, minlength=len(h.counts))
        h.counts = [int(c) for c in counts]
    return h


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------

class CapacityLedger:
    """Process-wide capacity accounting: stores and idle trackers,
    rolled up into one census. Every registration is weak (a bound
    method through ``weakref.WeakMethod``): an owner that dies drops out
    of the census."""

    def __init__(self):
        self._stores: Dict[str, Any] = {}        # key -> weak store ref
        self._idle: Dict[str, Any] = {}          # key -> weak tracker ref
        self._idle_resolvers: Dict[str, Any] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _free_key(table: Dict[str, Any], owner: str) -> str:
        """``owner``, suffixed past any still-live registration."""
        base, i, key = owner, 1, owner
        while key in table and table[key]() is not None:
            i += 1
            key = f"{base}{i}"
        return key

    def register_store(self, owner: str, store) -> str:
        """Register a device store (``state.fields()`` tensors, ``n_docs``
        rows). Returns the key."""
        with self._lock:
            key = self._free_key(self._stores, owner)
            self._stores[key] = weakref.ref(store)
            return key

    def add_idle_tracker(self, owner: str, tracker: IdleAgeTracker,
                         row_doc_id: Optional[Callable[[int], Any]] = None
                         ) -> str:
        """Attach an idle tracker; ``row_doc_id`` (a bound method, held
        weakly) resolves a row to its doc id for the coldest-doc
        census."""
        with self._lock:
            key = self._free_key(self._idle, owner)
            self._idle[key] = weakref.ref(tracker)
            if row_doc_id is not None:
                self._idle_resolvers[key] = weakref.WeakMethod(row_doc_id)
            return key

    def _live(self, table: Dict[str, Any]) -> List[Tuple[str, Any]]:
        out = []
        with self._lock:
            for key in list(table):
                obj = table[key]()
                if obj is None:
                    del table[key]
                    if table is self._idle:
                        self._idle_resolvers.pop(key, None)
                else:
                    out.append((key, obj))
        return out

    def census(self, top_k: int = 8) -> Dict[str, Any]:
        """One capacity census: device bytes and resident docs by store,
        the allocator of every registered store's device, idle-age
        summaries per tracker, and the top-K coldest docs. Publishes the
        idle-age distribution as the ``doc_idle_age_s`` histogram of
        :data:`telemetry.REGISTRY`."""
        t0 = time.perf_counter()
        stores = self._live(self._stores)
        dev_by_owner = {key: store_nbytes(st) for key, st in stores}
        docs_by_owner = {key: int(st.n_docs) for key, st in stores}

        idle: Dict[str, Any] = {}
        coldest: List[Dict[str, Any]] = []
        ages: List[np.ndarray] = []
        for key, tr in self._live(self._idle):
            idle[key] = tr.snapshot()
            ages.append(tr.ages())
            res = self._idle_resolvers.get(key)
            resolve = res() if res is not None else None
            for row in tr.coldest(top_k):
                row = dict(row, owner=key)
                if resolve is not None:
                    row["doc"] = resolve(row["row"])
                coldest.append(row)
        coldest.sort(key=lambda r: r["idle_s"], reverse=True)
        if ages:
            _telemetry.REGISTRY.histograms["doc_idle_age_s"] = \
                idle_age_histogram(np.concatenate(ages))

        return {
            "device": {"total_bytes": sum(dev_by_owner.values()),
                       "by_owner": dev_by_owner,
                       "allocator": device_census(
                           t.device for _, st in stores
                           for t in st.state.fields().values())},
            "docs": {"resident": sum(docs_by_owner.values()),
                     "by_owner": docs_by_owner},
            "idle": idle,
            "coldest": coldest[:max(0, int(top_k))],
            "census_ms": (time.perf_counter() - t0) * 1e3,
        }


#: the process-wide ledger
LEDGER = CapacityLedger()
