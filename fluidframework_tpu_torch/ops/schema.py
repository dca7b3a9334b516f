"""Op kinds of the device op planes and the JSON value interner.

Ops reach the device as struct-of-arrays int32 planes (kind, a0, a1, a2,
seq, client, ref_seq); variable-length payloads (text, JSON values) stay in
host tables and ride as integer handles.
"""

from __future__ import annotations

import enum
import json

import numpy as np


class OpKind(enum.IntEnum):
    # merge-tree / SharedString ops (reference: IMergeTreeOp types)
    STR_INSERT = 0    # a0=pos, a1=len, a2=payload handle
    STR_REMOVE = 1    # a0=start, a1=end
    STR_ANNOTATE = 2  # a0=start, a1=end, a2=props handle
    # map ops
    MAP_SET = 3
    MAP_DELETE = 4
    MAP_CLEAR = 5
    # matrix ops
    MAT_SET_CELL = 6
    MAT_INSERT_ROWS = 7
    MAT_INSERT_COLS = 8
    MAT_REMOVE_ROWS = 9
    MAT_REMOVE_COLS = 10
    COUNTER_INCREMENT = 11
    NOOP = 12         # heartbeat / padding: touches no state
    AXIS_RESOLVE = 13


def pad_rows_pow2(rows):
    """Pad a row list to the next power of two by repeating row 0, so the
    row gathers and writes of incremental summaries come in a few shapes
    (a repeated gather is dropped, a repeated write writes the same
    values). Returns (rows_padded, p2, n)."""
    rows = np.ascontiguousarray(rows, np.int32)
    n = len(rows)
    p2 = 1 << (n - 1).bit_length() if n else 1
    if p2 > n:
        rows = np.concatenate([rows, np.full(p2 - n, rows[0], np.int32)])
    return rows, p2, n


def bucket_rows(a, p2: int, n: int):
    """Pad a per-row array to the ``pad_rows_pow2`` bucket by repeating
    row 0's entry."""
    a = np.asarray(a, np.int32)
    if p2 > n:
        a = np.concatenate([a, np.repeat(a[:1], p2 - n, axis=0)])
    return a


class ValueInterner:
    """JSON value ↔ int32 handle interning: handle 0 is reserved for "no
    value"; equal values (by canonical JSON encoding) share one handle."""

    def __init__(self):
        self._values: list = [None]
        self._ids: dict = {}

    def handle(self, value) -> int:
        enc = json.dumps(value, sort_keys=True)
        if enc not in self._ids:
            self._ids[enc] = len(self._values)
            self._values.append(value)
        return self._ids[enc]

    def bulk(self, items) -> list:
        """Handles for a whole value table at once (columnar ingest)."""
        ids = self._ids
        values = self._values
        get = ids.get
        dumps = json.dumps
        out = []
        append = out.append
        for v in items:
            enc = dumps(v, sort_keys=True)
            h = get(enc)
            if h is None:
                h = len(values)
                ids[enc] = h
                values.append(v)
            append(h)
        return out

    def bulk_ints(self, items) -> list:
        """``bulk`` for a column of Python ints: the canonical JSON of an
        int is ``repr(int)``, so no encoder runs (callers exclude ``bool``:
        ``True`` and ``1`` encode differently)."""
        ids = self._ids
        values = self._values
        get = ids.get
        out = []
        append = out.append
        for v in items:
            enc = repr(v)
            h = get(enc)
            if h is None:
                h = len(values)
                ids[enc] = h
                values.append(v)
            append(h)
        return out

    def value(self, handle: int):
        return self._values[handle]

    def __len__(self) -> int:
        return len(self._values)

    def export(self) -> list:
        """Values in handle order (element 0 is the reserved None)."""
        return list(self._values)

    def export_from(self, base: int) -> list:
        """Values appended since ``base`` (the table is append-only: an
        incremental summary carries only this delta)."""
        return list(self._values[base:])

    def extend_from(self, values: list) -> None:
        """Re-append an ``export_from`` delta."""
        for v in values:
            self.handle(v)

    @classmethod
    def restore(cls, values: list) -> "ValueInterner":
        it = cls()
        for v in values[1:]:
            it.handle(v)
        return it


def positions_in_doc(rows):
    """Per-record position among its doc's records (flat order preserved
    per doc); returns (pos, widest_doc_count)."""
    rows = np.asarray(rows)
    order = np.argsort(rows, kind="stable")
    r_sorted = rows[order]
    starts = np.r_[0, np.flatnonzero(np.diff(r_sorted)) + 1]
    sizes = np.diff(np.r_[starts, len(r_sorted)])
    pos_sorted = np.arange(len(r_sorted)) - np.repeat(starts, sizes)
    pos = np.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos, (int(sizes.max()) if len(sizes) else 0)
