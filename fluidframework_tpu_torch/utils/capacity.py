"""Host-byte estimate of one op-log record.

The durable log (``server/oplog.py``) charges every record it keeps in
memory with :func:`record_nbytes` at append time, so ``mem_stats()``
reads precomputed per-partition byte counters and never walks the record
lists.

The constants are measured amortized costs of CPython 3.10 on x86-64
(held against tracemalloc), not guesses.
"""

from __future__ import annotations

from typing import Any

import numpy as np

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
