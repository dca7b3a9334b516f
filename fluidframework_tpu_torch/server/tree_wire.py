"""Columnar wire format for SharedTree general edits.

Port of ``fluidframework_tpu/server/tree_wire.py`` (pure numpy; the
encoders, the decoders and the wire batches are the same bytes).

The string engine's volume path works because its wire format IS columnar
(``ingest_planes``: position planes + payload tables, never a per-op dict
server-side). This module gives the tree engine the same property for its
GENERAL edit stream (insert/remove/move/setValue/transaction — the
reference's ``@fluidframework/tree`` op surface, SURVEY.md §2.6):

- **Client side** — ``TreeBatchEncoder`` turns op dicts into the kernel's
  flat record planes plus per-batch string/value tables (``ops.tree_kernel``
  documents the record protocol; ``ops.tree_store.RecordEmitter`` is the
  single canonical encoder). The emitter's handle callbacks only RECORD
  occurrences (one list append each); table resolution happens once per
  batch as vectorized first-occurrence ``np.unique`` passes — one dict hit
  per UNIQUE id/field/type/value instead of one per record column. The
  output is byte-identical to the JAX package's per-op
  ``ReferenceTreeBatchEncoder`` (parity-tested), the executable spec.
- **Server side** — ``TreeServingEngine.ingest_records`` validates bounds,
  maps the batch-local tables into the store interners (one dict hit per
  UNIQUE string, not per op), sequences the batch in one native call,
  scatters the records into dense (doc × record) planes, and dispatches one
  device apply. The durable record keeps the RAW planes (``TreeRecordOps``),
  so recovery replays bit-identical records — live state and recovered
  state cannot diverge on any bounded input.
- ``decode_records`` inverts the encoder for a whole batch, with the
  handle→table gathers done as single vectorized passes per column —
  the audit/oracle-replay consumer (``TreeRecordOps.expand``). A
  constraint-free single-edit transaction normalizes to the bare edit —
  semantically identical by the oracle's transaction rule.
- ``encode_leaf_records`` is the array-native encoder behind the FLAT
  path (``ingest_leaves``): N single-node inserts become N
  ``INSERT_SOLO`` records with the same unique-pass table resolution —
  no per-item Python ``handle()`` loop anywhere on the flat wire.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ..ops.tree_kernel import META_NESTED, TreeOpKind
from ..ops.tree_store import ANON_BASE, RecordEmitter


# ------------------------------------------------- vectorized resolution
#
# The emitter's callbacks append to occurrence columns and return the
# 1-based OCCURRENCE index; ``batch()`` resolves every column with one
# first-occurrence ``np.unique`` pass and remaps the record planes with
# a single table gather. First-occurrence ordering makes the resolved
# tables (and therefore the whole wire batch) byte-identical to the
# per-op reference: a dict interner hands out handles in stream order.


class _OccColumn:
    """Append-only occurrence column (``handle()`` = one list append)."""

    __slots__ = ("occ",)

    def __init__(self):
        self.occ: list = []

    def handle(self, item) -> int:
        self.occ.append(item)
        return len(self.occ)


def _first_occurrence(arr: np.ndarray):
    """(first_idx_in_stream_order, per-occurrence 1-based handles) for a
    sortable occurrence array — the unique pass that replaces the dict."""
    uniq, first, inv = np.unique(arr, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(1, len(uniq) + 1)
    return first[order], rank[inv].astype(np.int32)


def _resolve_strs(occ: list):
    """(items, remap) for a plain-string column; ``remap`` maps the
    1-based occurrence index (0 = none) to the table handle."""
    m = np.zeros(len(occ) + 1, np.int32)
    if not occ:
        return [], m
    first, handles = _first_occurrence(np.asarray(occ))
    m[1:] = handles
    return [occ[int(j)] for j in first], m


def _resolve_values(occ: list):
    """Like ``_resolve_strs`` keyed by the canonical JSON encoding; the
    table keeps the ORIGINAL value at each key's first occurrence.
    Type-homogeneous columns (all-int, all-str — the flat/leaf shapes)
    skip the per-occurrence ``json.dumps``: int and str equality ARE
    canonical-encoding equality (bool is a distinct type, so the
    ``true``/``1`` key split survives)."""
    m = np.zeros(len(occ) + 1, np.int32)
    if not occ:
        return [], m
    kinds = set(map(type, occ))
    arr = None
    if kinds == {int}:
        try:
            arr = np.asarray(occ, np.int64)
        except OverflowError:
            arr = None
    elif kinds == {str}:
        arr = np.asarray(occ)
    if arr is None:
        arr = np.asarray([json.dumps(v, sort_keys=True) for v in occ])
    first, handles = _first_occurrence(arr)
    m[1:] = handles
    return [occ[int(j)] for j in first], m


def _parse_numeric_names(uniq: np.ndarray):
    """Vectorized ``#<digits>`` parse over a '<U' array via its UCS4
    code view (no per-element string objects): returns (is_num, vals),
    or None when the widths could overflow int64 (caller falls back to
    the exact per-item parse)."""
    n = len(uniq)
    w = uniq.dtype.itemsize // 4
    if w < 2 or w - 1 > 18:
        return None
    codes = np.ascontiguousarray(uniq).view(np.int32).reshape(n, w)
    tail = codes[:, 1:]
    dig = (tail >= 48) & (tail <= 57)
    pad = tail == 0
    # an all-digit non-empty tail with padding only at the end (an
    # embedded NUL is not a digit to str.isdigit)
    is_num = ((codes[:, 0] == 35) & (dig | pad).all(axis=1) & dig[:, 0]
              & ~(pad[:, :-1] & dig[:, 1:]).any(axis=1))
    vals = np.zeros(n, np.int64)
    for c in range(w - 1):
        d = tail[:, c]
        vals = np.where(d != 0, vals * 10 + (d - 48), vals)
    return is_num, vals


def _resolve_ids(occ: list):
    """Id column: unique the raw names first, then numeric-parse only the
    uniques (``#<n>``, n ≥ ANON_BASE → int entry) and re-dedup by parsed
    key in stream-first-occurrence order — exactly the per-op reference
    encoder's numeric-parsing id table (``#0001048576`` and
    ``#1048576`` share one entry there too)."""
    m = np.zeros(len(occ) + 1, np.int32)
    if not occ:
        return [], m
    return _resolve_ids_arr(np.asarray(occ), m)


def _resolve_ids_arr(arr: np.ndarray, m: np.ndarray):
    uniq, first, inv = np.unique(arr, return_index=True,
                                 return_inverse=True)
    nu = len(uniq)
    order = np.argsort(first, kind="stable")
    parsed = _parse_numeric_names(uniq)
    dedup_needed = True
    if parsed is not None:
        is_num, vals = parsed
        is_num &= vals >= ANON_BASE
        if is_num.all():
            keys: list = vals.tolist()
        else:
            keys = uniq.tolist()
            hits = np.flatnonzero(is_num)
            for j, v in zip(hits.tolist(), vals[hits].tolist()):
                keys[j] = v
        # distinct strings share a key only via leading zeros — when the
        # parsed ints are unique, handles are plain first-occurrence rank
        nv = int(is_num.sum())
        dedup_needed = nv and np.unique(vals[is_num]).size != nv
    else:
        keys = uniq.tolist()
        for j in range(nu):
            s = keys[j]
            if s.startswith("#"):
                t = s[1:]
                if t.isdigit():
                    v = int(t)
                    if v >= ANON_BASE:
                        keys[j] = v
    if not dedup_needed:
        items = [keys[j] for j in order]
        uh = np.empty(nu, np.int32)
        uh[order] = np.arange(1, nu + 1, dtype=np.int32)
    else:
        items = []
        kidx: Dict[object, int] = {}
        uh = np.zeros(nu, np.int32)
        for j in order.tolist():
            k = keys[j]
            h = kidx.get(k)
            if h is None:
                items.append(k)
                h = kidx[k] = len(items)
            uh[j] = h
    m[1:] = uh[inv]
    return items, m


class TreeBatchEncoder:
    """Accumulate ops into one columnar record batch (client side).
    ``add()`` only appends occurrences; ``batch()`` runs the vectorized
    table resolution (module docstring) — the same output bytes as a
    per-op dict-interning encoder."""

    def __init__(self):
        self._ids = _OccColumn()
        self._fields = _OccColumn()
        self._types = _OccColumn()
        self._values = _OccColumn()
        self._emitter = RecordEmitter(
            self._ids.handle, self._fields.handle, self._values.handle,
            self._types.handle)
        self._rec_op: List[int] = []
        self._recs: List[tuple] = []
        self._n_ops = 0

    def add(self, op: dict) -> int:
        """Encode one op; returns its index in the batch."""
        recs = self._emitter.emit_op(op)
        i = self._n_ops
        self._rec_op.extend([i] * len(recs))
        self._recs.extend(recs)
        self._n_ops += 1
        return i

    def batch(self) -> dict:
        """The wire batch: record planes + tables (see module docstring)."""
        recs = (np.array(self._recs, np.int32)
                if self._recs else np.zeros((0, 8), np.int32))
        ids, idm = _resolve_ids(self._ids.occ)
        fields, fm = _resolve_strs(self._fields.occ)
        types, tm = _resolve_strs(self._types.occ)
        values, vm = _resolve_values(self._values.occ)
        if len(recs):
            recs[:, 1] = idm[recs[:, 1]]
            recs[:, 2] = idm[recs[:, 2]]
            recs[:, 3] = idm[recs[:, 3]]
            recs[:, 4] = fm[recs[:, 4]]
            recs[:, 5] = vm[recs[:, 5]]
            recs[:, 6] = tm[recs[:, 6]]
        return {
            "rec_op": np.asarray(self._rec_op, np.int64),
            "recs": recs,
            "ids": ids, "fields": fields, "types": types,
            "values": values,
        }


def encode_tree_batch(ops) -> dict:
    enc = TreeBatchEncoder()
    for op in ops:
        enc.add(op)
    return enc.batch()


def encode_leaf_records(parents: List[str], fields: List[str],
                        node_ids: List[str], values: list,
                        types: Optional[List[str]] = None,
                        afters: Optional[List[Optional[str]]] = None
                        ) -> dict:
    """The FLAT wire: N single-node inserts as N ``INSERT_SOLO`` records,
    tables resolved array-natively (no per-item ``handle()`` loop). The
    id table interleaves (node, parent, after) per op — the same stream
    order the retired per-item encoder produced, so the batch is
    byte-identical to its output. Inputs must be pre-validated (the
    serving engine's ``ingest_leaves`` front door does that)."""
    n = len(node_ids)
    recs = np.zeros((n, 8), np.int32)
    recs[:, 0] = int(TreeOpKind.INSERT_SOLO)
    rec_op = np.arange(n, dtype=np.int64)
    if not n:
        return {"rec_op": rec_op, "recs": recs, "ids": [], "fields": [],
                "types": [], "values": []}
    af = np.asarray(["" if a is None else a for a in afters]
                    if afters is not None else [""] * n)
    trio = np.concatenate([np.asarray(node_ids), np.asarray(parents),
                           af])
    id_mask = trio != ""
    ids, idm = _resolve_ids(trio[id_mask].tolist())
    h3 = np.zeros(3 * n, np.int32)
    h3[id_mask] = idm[1:]
    recs[:, 1] = h3[:n]
    recs[:, 2] = h3[n:2 * n]
    recs[:, 3] = h3[2 * n:]
    fields_t, fm = _resolve_strs(list(fields))
    recs[:, 4] = fm[1:]
    v_mask = np.fromiter((v is not None for v in values), bool, count=n)
    values_t, vm = _resolve_values([v for v in values if v is not None])
    recs[v_mask, 5] = vm[1:]
    if types is not None:
        t_mask = np.fromiter((t is not None for t in types), bool,
                             count=n)
        types_t, tm = _resolve_strs([t for t in types if t is not None])
        recs[t_mask, 6] = tm[1:]
    else:
        types_t = []
    return {"rec_op": rec_op, "recs": recs, "ids": ids,
            "fields": fields_t, "types": types_t, "values": values_t}


def decode_records(rec_op, recs, ids: List[str], fields: List[str],
                   types: List[str], values: list) -> List[dict]:
    """Decode EVERY op of a record batch: the handle→table gathers run
    as ONE object-array pass per column (instead of per-record closure
    calls), then a structural walk per op over the pre-resolved columns.
    Output ops are identical to the JAX package's per-op ``decode_op``
    (parity-tested; the audit path ``TreeRecordOps.expand`` rides this)."""
    rec_op = np.asarray(rec_op, np.int64)
    recs = np.asarray(recs)
    n_ops = int(rec_op[-1]) + 1 if len(rec_op) else 0
    if not n_ops:
        return []
    idt = np.empty(len(ids) + 1, object)
    idt[0] = None
    for j, e in enumerate(ids):
        idt[j + 1] = f"#{e}" if isinstance(e, int) else e
    ft = np.empty(len(fields) + 1, object)
    ft[0] = None
    for j, e in enumerate(fields):
        ft[j + 1] = e
    tt = np.empty(len(types) + 1, object)
    tt[0] = None
    for j, e in enumerate(types):
        tt[j + 1] = e
    vt = np.empty(len(values) + 1, object)
    vt[0] = None
    for j, e in enumerate(values):
        vt[j + 1] = e
    cols = {
        "kind": recs[:, 0], "node_h": recs[:, 1], "parent_h": recs[:, 2],
        "node": idt[recs[:, 1]], "parent": idt[recs[:, 2]],
        "after": idt[recs[:, 3]], "field": ft[recs[:, 4]],
        "value": vt[recs[:, 5]], "type": tt[recs[:, 6]],
        "meta": recs[:, 7],
    }
    bounds = np.searchsorted(rec_op, np.arange(n_ops + 1))
    return [_decode_span(cols, int(bounds[i]), int(bounds[i + 1]))
            for i in range(n_ops)]


def _decode_span(c: dict, s: int, e: int) -> dict:
    """One op's structural parse over pre-resolved columns — the same
    grammar as the per-op reference decoder (parity-tested)."""
    K = TreeOpKind
    kind, meta = c["kind"], c["meta"]
    node, parent, after = c["node"], c["parent"], c["after"]
    field, value, typ = c["field"], c["value"], c["type"]
    node_h, parent_h = c["node_h"], c["parent_h"]
    if s >= e:
        raise ValueError("op with no records")

    def parse_inserts(i: int, want_tops: int, insert_kind) -> tuple:
        specs: list = []
        by_h: dict = {}
        firsti = -1
        tops = 0
        while i < e:
            if kind[i] != insert_kind:
                break
            nested = bool(meta[i] & META_NESTED)
            if not nested and tops == want_tops:
                break
            spec = {"id": node[i], "type": typ[i], "value": value[i]}
            by_h[int(node_h[i])] = spec
            if nested:
                par = by_h.get(int(parent_h[i]))
                if par is None:
                    raise ValueError("nested record without its parent")
                par.setdefault("children", {}).setdefault(
                    field[i], []).append(spec)
            else:
                if firsti < 0:
                    firsti = i
                specs.append(spec)
                tops += 1
            i += 1
        if tops != want_tops:
            raise ValueError("insert group shorter than its guard count")
        return ({"op": "insert", "parent": parent[firsti],
                 "field": field[firsti], "after": after[firsti],
                 "nodes": specs}, i)

    k0 = kind[s]
    if k0 == K.INSERT_SOLO:
        op, i = parse_inserts(s, 1, K.INSERT_SOLO)
        if i != e:
            raise ValueError("trailing records after solo insert")
        return op
    if k0 == K.REMOVE_SOLO:
        return {"op": "remove", "id": node[s]}
    if k0 == K.MOVE_SOLO:
        return {"op": "move", "id": node[s], "parent": parent[s],
                "field": field[s], "after": after[s]}
    if k0 == K.SET_SOLO:
        return {"op": "setValue", "id": node[s], "value": value[s]}
    if k0 not in (K.TXN_BEGIN, K.TXN_BEGIN_EXISTS):
        raise ValueError(f"op cannot start with record kind {k0}")

    i = s + 1
    constraints = []
    if k0 == K.TXN_BEGIN_EXISTS:
        constraints.append({"nodeExists": node[s]})
    while i < e and kind[i] == K.TXN_GUARD_EXISTS:
        constraints.append({"nodeExists": node[i]})
        i += 1
    edits = []
    while i < e:
        k = kind[i]
        if k == K.INS_BEGIN:
            i += 1
        elif k == K.INS_GUARD_ABSENT:
            g = 0
            while i < e and kind[i] == K.INS_GUARD_ABSENT:
                g += 1
                i += 1
            op, i = parse_inserts(i, g, K.INSERT)
            edits.append(op)
        elif k == K.INSERT:
            op, i = parse_inserts(i, 1, K.INSERT)
            edits.append(op)
        elif k == K.REMOVE:
            edits.append({"op": "remove", "id": node[i]})
            i += 1
        elif k == K.MOVE:
            edits.append({"op": "move", "id": node[i],
                          "parent": parent[i], "field": field[i],
                          "after": after[i]})
            i += 1
        elif k == K.SET_VALUE:
            edits.append({"op": "setValue", "id": node[i],
                          "value": value[i]})
            i += 1
        else:
            raise ValueError(f"unexpected record kind {k} in group")
    if not constraints and len(edits) == 1 and edits[0]["op"] == "insert":
        return edits[0]
    out = {"op": "transaction", "edits": edits}
    if constraints:
        out["constraints"] = constraints
    return out
