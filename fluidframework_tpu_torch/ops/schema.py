"""Op kinds of the device op planes and the JSON value interner.

Ops reach the device as struct-of-arrays int32 planes (kind, a0, a1, a2,
seq, client, ref_seq); variable-length payloads (text, JSON values) stay in
host tables and ride as integer handles.
"""

from __future__ import annotations

import enum
import json


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
