"""Host facade of the tree record scan: many SharedTree documents resident
on one device.

Port of ``fluidframework_tpu/ops/tree_store.py``. The host interns
variable-size identities (node-id strings, field names, type names, JSON
values) into int32 handles and expands each op dict into the guard +
record stream of ``tree_kernel`` (its module docstring documents the
grouping protocol); the device does all merge math. Reads rebuild the
oracle's ``to_dict`` shape by walking the sibling lists on the host.

Uploads. A dense (9, D, O) record batch goes up in one copy. The compact
wire (``pack_wire_records``) of a prepacked wave lives in one pinned
staging buffer (all five lanes, each at its shipped width) plus four
pinned int32 maps, copied ``non_blocking`` behind the previous launch; a
CUDA event is recorded after the copies, and the buffers go back to their
pools only once that event has completed, so the next wave's pack can
never overwrite bytes still on their way to the card.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from . import tree_apply
from ..parallel.sharded import (
    RowShardedStore, ShardedRows, shard_planes, sharded_tree_apply,
    store_shards,
)
from .schema import ValueInterner, positions_in_doc
from .string_store import resolve_device
from .tree_kernel import (
    META_NESTED, ROOT_HANDLE, TREE_PLANES, TreeOpKind, TreeState,
    apply_tree_planes_fused, apply_tree_wire_fused, gather_tree_rows,
    tree_state_digest, write_tree_rows,
)

ROOT = "root"

#: Floor of the numeric-id namespace: handles >= ANON_BASE are anonymous,
#: their name is ``#<handle>`` and is never interned (the id-compressor
#: role: clients reserve numeric clusters and ship ids as ints).
ANON_BASE = 1 << 20

_I32 = torch.int32


class _Interner:
    """str <-> dense int32 handle (1-based; 0 = none). Handles below
    ``ANON_BASE`` are interned strings; handles at or above it are the
    numeric-id namespace (name ``#<handle>``, no storage)."""

    def __init__(self, reserved=()):
        self._ids: Dict[str, int] = {}
        self._names: List[Optional[str]] = [None]
        self._next_anon = ANON_BASE
        for name in reserved:
            self.handle(name)

    @staticmethod
    def _anon_handle(name: str) -> Optional[int]:
        if name.startswith("#"):
            tail = name[1:]
            if tail.isdigit():
                h = int(tail)
                if h >= ANON_BASE:
                    return h
        return None

    def handle(self, name: str) -> int:
        h = self._anon_handle(name)
        if h is not None:
            return h
        if name not in self._ids:
            h = len(self._names)
            if h >= ANON_BASE:
                raise OverflowError("string-id space exhausted; use "
                                    "numeric ids (reserve/#-names)")
            self._ids[name] = h
            self._names.append(name)
        return self._ids[name]

    def peek(self, name: str) -> Optional[int]:
        """Handle if known (or anonymous), without interning."""
        h = self._anon_handle(name)
        return h if h is not None else self._ids.get(name)

    def reserve(self, count: int) -> int:
        """Allocate ``count`` anonymous numeric ids; returns the base."""
        base = self._next_anon
        self._next_anon = base + count
        return base

    def bulk(self, items) -> list:
        """Handles for a whole table at once (ints pass through: they are
        pre-compressed numeric handles)."""
        ids = self._ids
        names = self._names
        get = ids.get
        anon = self._anon_handle
        out = []
        append = out.append
        for s in items:
            if type(s) is int:
                append(s)
                continue
            v = get(s)
            if v is None:
                v = anon(s)
                if v is None:
                    v = len(names)
                    if v >= ANON_BASE:
                        raise OverflowError("string-id space exhausted")
                    ids[s] = v
                    names.append(s)
            append(v)
        return out

    def name(self, handle: int) -> Optional[str]:
        return f"#{handle}" if handle >= ANON_BASE \
            else self._names[handle]

    def __len__(self) -> int:
        return len(self._names)

    def export_from(self, base_len: int) -> list:
        """Names appended since ``base_len`` (the table is append-only)."""
        return list(self._names[base_len:])

    def extend_from(self, names: list) -> None:
        for n in names:
            self.handle(n)

    def export(self) -> dict:
        return {"names": list(self._names), "next_anon": self._next_anon}

    @classmethod
    def restore(cls, snap) -> "_Interner":
        it = cls()
        names = snap["names"] if isinstance(snap, dict) else snap
        for n in names[1:]:
            it.handle(n)
        if isinstance(snap, dict):
            it._next_anon = snap["next_anon"]
        return it


class RecordEmitter:
    """Canonical op-dict -> record encoding, shared by the store's message
    path (global interners) and the client wire encoder (batch-local
    tables); ``server.tree_wire.decode_records`` inverts it. A standalone flat
    edit is ONE solo record; the begin/guard group protocol appears only
    where atomicity needs it (multi-node inserts, transactions)."""

    def __init__(self, h_id, h_field, h_value, h_type):
        self._id = h_id
        self._field = h_field
        self._value = h_value
        self._type = h_type

    @staticmethod
    def _rec(kind, node=0, parent=0, after=0, field=0, value=0,
             type_=0, meta=0):
        return (int(kind), node, parent, after, field, value, type_, meta)

    def _vh(self, value) -> int:
        return 0 if value is None else self._value(value)

    def _th(self, type_name) -> int:
        return 0 if type_name is None else self._type(type_name)

    def _emit_specs(self, op: dict, out: list, solo: bool) -> None:
        """DFS INSERT records for every spec of an insert op (top level
        chained by ``after``; nested records carry META_NESTED)."""
        after = self._id(op["after"]) if op.get("after") else 0
        parent = self._id(op["parent"])
        field = self._field(op["field"])
        kind = TreeOpKind.INSERT_SOLO if solo else TreeOpKind.INSERT
        for spec in op["nodes"]:
            self._emit_spec(spec, parent, field, after, kind, nested=False,
                            out=out)
            after = self._id(spec["id"])

    def _emit_spec(self, spec: dict, parent: int, field: int, after: int,
                   kind, nested: bool, out: list) -> None:
        nid = self._id(spec["id"])
        out.append(self._rec(
            kind, node=nid, parent=parent, after=after,
            field=field, value=self._vh(spec.get("value")),
            type_=self._th(spec.get("type")),
            meta=META_NESTED if nested else 0))
        for fname, child_specs in (spec.get("children") or {}).items():
            fh = self._field(fname)
            prev = 0
            for child in child_specs:
                self._emit_spec(child, nid, fh, prev, kind, nested=True,
                                out=out)
                prev = self._id(child["id"])

    def emit_op(self, op: dict) -> list:
        """Record tuples for ONE standalone sequenced op."""
        kind = op["op"]
        out: list = []
        if kind == "insert":
            if len(op["nodes"]) == 1:
                # one top-level spec: the INSERT's own absent check is the
                # guard, nested specs gate on created_seq: all solo
                self._emit_specs(op, out, solo=True)
            else:
                # all-or-nothing needs the guard group; TXN_BEGIN resets
                # both flags left over from earlier ops
                out.append(self._rec(TreeOpKind.TXN_BEGIN))
                for spec in op["nodes"]:
                    out.append(self._rec(TreeOpKind.INS_GUARD_ABSENT,
                                         node=self._id(spec["id"])))
                self._emit_specs(op, out, solo=False)
        elif kind == "remove":
            out.append(self._rec(TreeOpKind.REMOVE_SOLO,
                                 node=self._id(op["id"])))
        elif kind == "move":
            out.append(self._rec(
                TreeOpKind.MOVE_SOLO, node=self._id(op["id"]),
                parent=self._id(op["parent"]),
                after=self._id(op["after"]) if op.get("after") else 0,
                field=self._field(op["field"])))
        elif kind == "setValue":
            out.append(self._rec(TreeOpKind.SET_SOLO,
                                 node=self._id(op["id"]),
                                 value=self._vh(op["value"])))
        elif kind == "transaction":
            cons = [c["nodeExists"] for c in op.get("constraints", ())
                    if "nodeExists" in c]
            if cons:
                # the first constraint rides the begin record
                out.append(self._rec(TreeOpKind.TXN_BEGIN_EXISTS,
                                     node=self._id(cons[0])))
                for cn in cons[1:]:
                    out.append(self._rec(TreeOpKind.TXN_GUARD_EXISTS,
                                         node=self._id(cn)))
            else:
                out.append(self._rec(TreeOpKind.TXN_BEGIN))
            # each edit is flag-gated (ok_txn holds the constraint gate);
            # ok_ins is reset (INS_BEGIN) only after an edit's guards may
            # have dirtied it
            dirty = False
            for sub in op["edits"]:
                dirty = self._emit_txn_edit(sub, out, dirty)
        else:
            raise ValueError(f"unknown tree op {kind!r}")
        return out

    def _emit_txn_edit(self, op: dict, out: list, dirty: bool) -> bool:
        kind = op["op"]
        if kind == "insert":
            guarded = len(op["nodes"]) > 1
            if dirty:
                out.append(self._rec(TreeOpKind.INS_BEGIN))
            if guarded:
                for spec in op["nodes"]:
                    out.append(self._rec(TreeOpKind.INS_GUARD_ABSENT,
                                         node=self._id(spec["id"])))
            self._emit_specs(op, out, solo=False)
            return guarded
        if dirty:
            out.append(self._rec(TreeOpKind.INS_BEGIN))
        if kind == "remove":
            out.append(self._rec(TreeOpKind.REMOVE,
                                 node=self._id(op["id"])))
        elif kind == "move":
            out.append(self._rec(
                TreeOpKind.MOVE, node=self._id(op["id"]),
                parent=self._id(op["parent"]),
                after=self._id(op["after"]) if op.get("after") else 0,
                field=self._field(op["field"])))
        elif kind == "setValue":
            out.append(self._rec(TreeOpKind.SET_VALUE,
                                 node=self._id(op["id"]),
                                 value=self._vh(op["value"])))
        else:
            # a nested transaction cannot share the single ok_txn gate;
            # the serving engine rejects it at ingress
            raise ValueError(f"unsupported edit inside transaction: "
                             f"{kind!r}")
        return False


def _pow2_at_least(n: int, floor: int = 1) -> int:
    o = floor
    while o < n:
        o *= 2
    return o


def pack_wire_records(recs_k: np.ndarray, rec_op_k: np.ndarray,
                      rows_r: np.ndarray, r_floor: int = 256,
                      bufs=None, id_t=np.uint16, val_t=np.uint16):
    """Width-coded wire buffers for kept records: the upload layout of
    ``tree_kernel.apply_tree_wire`` (cols: kind | meta<<4 with the
    first-of-op bit in meta bit 1, field, type; u16/u32 batch-local ids and
    values; u16 row + u8/u16 pos with the ``pos == o`` drop sentinel;
    records padded to a power of two of at least ``r_floor``). Returns
    (cols, ids, vals, row, pos, o), or None when the widest doc exceeds
    the u16 pos budget.

    ``bufs``: optional ``(rb, pos_dtype, id_dtype, val_dtype) -> (cols,
    ids, vals, row, pos)`` allocator (the store's pools). Pooled buffers
    are not zeroed: only the pos padding is filled, and a record with
    ``pos == o`` is dropped, so stale bytes in the other lanes' tails are
    never applied."""
    r = len(recs_k)
    pos, widest = positions_in_doc(rows_r)
    o = _pow2_at_least(max(widest, 1))
    if o > 0xFFFF:
        return None
    rb = _pow2_at_least(max(r, 1), floor=r_floor)
    pos_t = np.uint8 if o <= 128 else np.uint16
    if bufs is not None:
        cols, idsb, valsb, rowb, posb = bufs(rb, pos_t, id_t, val_t)
        posb[r:] = o   # the drop sentinel is the only padding that matters
    else:
        cols = np.zeros((rb, 3), np.uint8)
        idsb = np.zeros((rb, 3), id_t)
        valsb = np.zeros(rb, val_t)
        rowb = np.zeros(rb, np.uint16)
        posb = np.full(rb, o, pos_t)   # padding records drop
    if r:
        first = np.empty(r, np.uint8)
        first[0] = 1
        first[1:] = rec_op_k[1:] != rec_op_k[:-1]
        cols[:r, 0] = recs_k[:, 0] | \
            ((recs_k[:, 7] | (first << 1)) << 4)
        cols[:r, 1] = recs_k[:, 4]
        cols[:r, 2] = recs_k[:, 6]
        idsb[:r] = recs_k[:, 1:4]
        valsb[:r] = recs_k[:, 5]
        rowb[:r] = rows_r
        posb[:r] = pos
    return cols, idsb, valsb, rowb, posb, o


#: wire / map pool depth cap (bounds retained host memory)
_WIRE_POOL_DEPTH = 4
_ALIGN = 16
_TORCH_DTYPE = {np.uint8: torch.uint8, np.uint16: torch.uint16,
                np.uint32: torch.uint32}


class _WireSet:
    """One pooled staging buffer holding a wave's five wire lanes, each at
    its width (pinned when the store is on the card): numpy views for the
    packer, tensor views of the uploaded copy for the kernels."""

    __slots__ = ("key", "host", "views", "_segs")

    def __init__(self, key, pin: bool):
        rb, posb, idb, valb = key
        dtypes = (np.uint8, {2: np.uint16, 4: np.uint32}[idb],
                  {2: np.uint16, 4: np.uint32}[valb], np.uint16,
                  {1: np.uint8, 2: np.uint16}[posb])
        shapes = ((rb, 3), (rb, 3), (rb,), (rb,), (rb,))
        segs, off = [], 0
        for dt, shape in zip(dtypes, shapes):
            n = int(np.prod(shape)) * np.dtype(dt).itemsize
            segs.append((off, n, dt, shape))
            off += -(-n // _ALIGN) * _ALIGN
        self.key = key
        self.host = torch.empty(off, dtype=torch.uint8, pin_memory=pin)
        raw = self.host.numpy()
        self.views = tuple(raw[o:o + n].view(dt).reshape(shape)
                           for o, n, dt, shape in segs)
        self._segs = segs

    def device_views(self, dev_buf: torch.Tensor) -> tuple:
        """(cols, ids, vals, row, pos) as typed views of ``dev_buf``, a
        copy of ``host`` on some device."""
        out = []
        for o, n, dt, shape in self._segs:
            out.append(dev_buf[o:o + n].view(_TORCH_DTYPE[dt]).reshape(
                shape))
        return tuple(out)


class PrepackedWire:
    """One tree record wave's wire buffers and interner table maps, packed
    ahead of sequencing on the pipeline's pack worker. Every record is
    packed (nacks resolve at dispatch, which discards the prepack on a
    nacked wave and repacks inline). The buffers come from the store's
    pools and return through ``release_wire``: at once when they were
    never uploaded, else once the CUDA event recorded behind their upload
    has completed."""

    __slots__ = ("wire", "o", "id_map", "f_map", "t_map", "v_map", "event")

    def __init__(self):
        self.event = None

    @property
    def maps(self) -> tuple:
        return (self.id_map, self.f_map, self.t_map, self.v_map)


class TensorTreeStore(RowShardedStore):
    """Many SharedTree documents resident on ``device`` (default the card;
    ``device="cpu"`` runs the plain versions), or split by doc-row block
    over the devices of a 1-D ``docs`` ``mesh`` (the dense apply launched
    once a shard; the compact wire is single-device). On the card a
    capacity the apply kernel does not take is refused before any op is
    admitted. On a mesh ``state`` is a copy of the whole state on the
    first shard's device; assigning it re-shards."""

    def __init__(self, n_docs: int, capacity: int = 256, device="cuda",
                 mesh=None):
        self.mesh = mesh
        self.sharded = None
        if mesh is None:
            self.device = resolve_device(device)
            devices = [self.device]
        else:
            devices, rows_per = store_shards(mesh, n_docs)
            self.device = devices[0]
        if any(d.type == "cuda" for d in devices):
            tree_apply.check_capacity(capacity)
        self.n_docs = n_docs
        self.capacity = capacity
        if mesh is None:
            self._state = TreeState.create(n_docs, capacity, self.device)
        else:
            self.sharded = ShardedRows(
                [TreeState.create(rows_per, capacity, d) for d in devices],
                rows_per)
        self._ids = _Interner(reserved=(ROOT,))      # handle 1 == ROOT
        assert self._ids.handle(ROOT) == ROOT_HANDLE
        self._fields = _Interner()
        self._types = _Interner()
        self._values = ValueInterner()
        self._init_pools()

    def _init_pools(self) -> None:
        # pow2 wire / map pools keyed by bucket size; the pack worker pops
        # while the dispatch stage releases, so they sit behind a lock.
        # Released buffers whose upload may still be in flight wait in
        # ``_pending`` with their event.
        self._wire_pool: Dict[tuple, list] = {}
        self._map_pool: Dict[int, list] = {}
        self._pending: List[PrepackedWire] = []
        self._pool_lock = threading.Lock()

    # ----------------------------------------------------------- translation

    @property
    def emitter(self) -> RecordEmitter:
        return RecordEmitter(self._ids.handle, self._fields.handle,
                             self._values.handle, self._types.handle)

    def _records_for(self, msg) -> list:
        """Expanded records for one sequenced tree message."""
        return self.emitter.emit_op(msg.contents)

    # ----------------------------------------------------------------- apply

    def _apply_planes(self, planes: np.ndarray) -> None:
        """Dispatch a packed (9, D, O) record batch (plane order: kind,
        node, parent, after, field, value, type_, meta, seq) as one copy
        and one apply."""
        if self.sharded is not None:
            sharded_tree_apply(self.mesh)(self.sharded.shards, shard_planes(
                np.asarray(planes, np.int32), self.mesh,
                self.sharded.rows_per))
            return
        dev = torch.from_numpy(np.ascontiguousarray(planes, np.int32)).to(
            self.device, copy=True)
        apply_tree_planes_fused(self._state, dev)

    def pack_records(self, rows: np.ndarray, recs: np.ndarray,
                     seqs: np.ndarray) -> np.ndarray:
        """Scatter flat records into dense (9, D, O) planes: per-doc record
        order is flat order (the sequencer's), O the pow2 bucket of the
        widest doc."""
        pos, widest = positions_in_doc(rows)
        o = _pow2_at_least(max(widest, 1))
        planes = np.zeros((9, self.n_docs, o), np.int32)
        for p in range(8):
            planes[p, rows, pos] = recs[:, p]
        planes[8, rows, pos] = seqs
        return planes

    def _to_dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            copy=True)

    # ------------------------------------------------------- prepacked wire

    def _reclaim(self) -> None:
        """Move released buffer sets whose upload has landed into the
        pools (caller holds the lock)."""
        still = []
        for pp in self._pending:
            if pp.event is not None and not pp.event.query():
                still.append(pp)
                continue
            pp.event = None
            stack = self._wire_pool.setdefault(pp.wire.key, [])
            if len(stack) < _WIRE_POOL_DEPTH:
                stack.append(pp.wire)
            for m in pp.maps:
                s = self._map_pool.setdefault(m.shape[0], [])
                if len(s) < _WIRE_POOL_DEPTH:
                    s.append(m)
        self._pending = still

    def _wire_buffers(self, rb: int, pos_t, id_t, val_t) -> _WireSet:
        """Pop (or allocate) one staging set; its tails are not zeroed."""
        key = (rb, np.dtype(pos_t).itemsize, np.dtype(id_t).itemsize,
               np.dtype(val_t).itemsize)
        with self._pool_lock:
            self._reclaim()
            stack = self._wire_pool.get(key)
            if stack:
                return stack.pop()
        return _WireSet(key, self.device.type == "cuda")

    def _pad_map(self, items, interner) -> torch.Tensor:
        """Pooled pow2 local-index -> interner-handle map (a host int32
        tensor). Only ``[0, len(items)]`` is gathered by a validated
        record (handle 0 == none), so the stale tail needs no zeroing."""
        cap = _pow2_at_least(len(items) + 1, floor=8)
        with self._pool_lock:
            self._reclaim()
            stack = self._map_pool.get(cap)
            m = stack.pop() if stack else None
        if m is None:
            m = torch.empty(cap, dtype=_I32,
                            pin_memory=self.device.type == "cuda")
        a = m.numpy()
        a[0] = 0
        if items:
            a[1:len(items) + 1] = interner.bulk(items)
        return m

    def prepack_wire(self, recs: np.ndarray, rec_op: np.ndarray,
                     rows_r: np.ndarray, tables: dict,
                     r_floor: int = 256) -> Optional[PrepackedWire]:
        """Pack all of a wave's records and interner maps into pooled
        wire buffers ahead of sequencing. Returns None when the widest doc
        overflows the u16 pos budget (the dense path takes the wave). The
        id / value lanes widen to u32 when a table outgrows u16."""
        sets: List[_WireSet] = []

        def bufs(rb, pos_t, id_t, val_t):
            sets.append(self._wire_buffers(rb, pos_t, id_t, val_t))
            return sets[-1].views

        packed = pack_wire_records(
            recs, rec_op, rows_r, r_floor=r_floor, bufs=bufs,
            id_t=np.uint16 if len(tables["ids"]) < 0xFFFF else np.uint32,
            val_t=(np.uint16 if len(tables["values"]) < 0xFFFF
                   else np.uint32))
        if packed is None:
            return None
        pp = PrepackedWire()
        pp.wire, pp.o = sets[0], packed[5]
        pp.id_map = self._pad_map(tables["ids"], self._ids)
        pp.f_map = self._pad_map(tables["fields"], self._fields)
        pp.t_map = self._pad_map(tables["types"], self._types)
        pp.v_map = self._pad_map(tables["values"], self._values)
        return pp

    def apply_wire_prepacked(self, pp: PrepackedWire,
                             base: np.ndarray) -> None:
        """Upload a prepacked wave (``base`` arrives after sequencing),
        dispatch it, and release its buffers behind the upload's event."""
        if self.sharded is not None:
            raise ValueError("the compact wire is single-device; a sharded "
                             "store takes the dense records")
        cuda = self.device.type == "cuda"
        wire_dev = pp.wire.host.to(self.device, non_blocking=cuda)
        maps = [m.to(self.device, non_blocking=cuda) for m in pp.maps]
        if cuda:
            pp.event = torch.cuda.Event()
            pp.event.record()
        apply_tree_wire_fused(
            self._state, *pp.wire.device_views(wire_dev),
            self._to_dev(np.asarray(base, np.int32)), *maps, o=pp.o)
        self.release_wire(pp)

    def release_wire(self, pp: PrepackedWire) -> None:
        """Return a prepack's buffers (after dispatch, or when a nacked wave
        discards its prepack): they reach the pools once their upload's
        event has completed."""
        with self._pool_lock:
            self._pending.append(pp)
            self._reclaim()

    def apply_records(self, rows: np.ndarray, recs: np.ndarray,
                      seqs: np.ndarray) -> None:
        """Apply flat (R, 8) records with per-record doc rows and seqs: the
        raw path of columnar ingest, recovery replay and the message
        path."""
        if len(recs) == 0:
            return
        self._apply_planes(self.pack_records(
            np.asarray(rows, np.int64), np.asarray(recs, np.int32),
            np.asarray(seqs, np.int64)))

    def apply_messages(self, messages) -> None:
        rows: list = []
        recs_all: list = []
        seqs: list = []
        for doc, msg in messages:
            recs = self._records_for(msg)
            recs_all.extend(recs)
            rows.extend([doc] * len(recs))
            seqs.extend([msg.seq] * len(recs))
        if not recs_all:
            return
        self.apply_records(np.asarray(rows, np.int64),
                           np.array(recs_all, np.int32),
                           np.asarray(seqs, np.int64))

    # ----------------------------------------------------------------- reads

    def _pull(self, doc: int) -> dict:
        st, r = self._at(doc)
        rows = torch.stack([getattr(st, k)[r] for k in TREE_PLANES])
        host = rows.cpu().numpy()
        return {k: host[i] for i, k in enumerate(TREE_PLANES)}

    def to_dict(self, doc: int) -> dict:
        """The oracle's ``to_dict`` shape, rebuilt from the planes."""
        p = self._pull(doc)
        live = p["node_id"] != 0
        by_id = {int(p["node_id"][i]): i for i in range(self.capacity)
                 if live[i]}

        def node_dict(nid: int) -> dict:
            i = by_id[nid]
            out = {"id": self._ids.name(nid),
                   "type": self._types.name(int(p["type_"][i]))
                   if p["type_"][i] else None,
                   "value": self._values.value(int(p["value"][i]))
                   if p["value"][i] else None}
            fields: Dict[int, list] = {}
            for j in range(self.capacity):
                if live[j] and int(p["parent"][j]) == nid:
                    fields.setdefault(int(p["field"][j]), []).append(j)
            children = {}
            for fh, slots in fields.items():
                ordered = self._chain_order(p, slots)
                children[self._fields.name(fh)] = [
                    node_dict(int(p["node_id"][j])) for j in ordered]
            if children:
                out["children"] = dict(sorted(children.items()))
            return out

        return node_dict(ROOT_HANDLE)

    @staticmethod
    def _chain_order(p, slots: list) -> list:
        """Sibling slots in prev/next chain order (head: prev == 0)."""
        by_id = {int(p["node_id"][j]): j for j in slots}
        head = [j for j in slots if int(p["prev_sib"][j]) == 0]
        assert len(head) == 1, "broken sibling chain"
        order = [head[0]]
        while True:
            nxt = int(p["next_sib"][order[-1]])
            if nxt == 0:
                break
            order.append(by_id[nxt])
        assert len(order) == len(slots), "sibling chain mismatch"
        return order

    def node_value(self, doc: int, node_id: str):
        p = self._pull(doc)
        nh = self._ids.peek(node_id)
        if nh is None:
            raise KeyError(node_id)
        sel = p["node_id"] == nh
        if not sel.any():
            raise KeyError(node_id)
        return self._values.value(int(p["value"][sel][0])) \
            if p["value"][sel][0] else None

    def has_node(self, doc: int, node_id: str) -> bool:
        nh = self._ids.peek(node_id)
        if nh is None:
            return False
        st, r = self._at(doc)
        return bool((st.node_id[r] == nh).any())

    def node_count(self, doc: int) -> int:
        st, r = self._at(doc)
        return int((st.node_id[r] != 0).sum())

    def overflowed(self) -> np.ndarray:
        return self._per_shard(lambda st: st.overflow)

    # -------------------------------------------------- overflow recovery ops

    def share_interners(self, other: "TensorTreeStore") -> None:
        """Alias ``other``'s (append-only) interner tables, so handles here
        mean the same strings and values: the precondition for
        ``other.adopt_doc`` copying these planes verbatim."""
        self._ids = other._ids
        self._fields = other._fields
        self._types = other._types
        self._values = other._values

    def clear_doc(self, row: int) -> None:
        """Reset one row to the empty tree (root only, overflow cleared)."""
        st, r = self._at(row)
        for k in TREE_PLANES:
            getattr(st, k)[r] = 0
        st.node_id[r, 0] = ROOT_HANDLE
        st.overflow[r] = 0

    def high_water(self, doc: int = 0) -> int:
        """1 + the highest live slot index (root counts), for fit checks."""
        st, r = self._at(doc)
        live = torch.nonzero(st.node_id[r] != 0)
        return int(live.max()) + 1 if live.numel() else 0

    def repack(self, doc: int = 0) -> None:
        """Compact a doc's live slots to the lowest indices: a pure
        permutation (slot position carries no meaning), so a rebuilt doc
        whose history churned through many slots fits a small tier."""
        st, r = self._at(doc)
        live = torch.nonzero(st.node_id[r] != 0)[:, 0]
        for k in TREE_PLANES:
            plane = getattr(st, k)
            row = torch.zeros(self.capacity, dtype=_I32, device=plane.device)
            row[:len(live)] = plane[r, live]
            plane[r] = row

    def adopt_doc(self, row: int, tmp: "TensorTreeStore") -> None:
        """Copy single-doc store ``tmp`` (which shares this store's
        interners, see ``share_interners``) into ``row``. The caller checks
        ``tmp.high_water() <= self.capacity`` first."""
        hw = tmp.high_water()
        assert hw <= self.capacity, "doc does not fit this tier"
        st, r = self._at(row)
        src = tmp._state
        for k in TREE_PLANES:
            plane = getattr(st, k)
            plane[r] = 0
            plane[r, :hw] = getattr(src, k)[0, :hw].to(plane.device)
        st.overflow[r] = 0

    def digests(self) -> np.ndarray:
        return self._per_shard(tree_state_digest)

    # ----------------------------------------------------- snapshot / resume
    # The JAX store's formats: numpy planes plus the interner exports.

    def snapshot(self) -> dict:
        st = self._state if self.sharded is None \
            else self.sharded.full("cpu")
        return {
            "planes": {k: getattr(st, k).cpu().numpy().copy()
                       for k in TREE_PLANES},
            "overflow": st.overflow.cpu().numpy().copy(),
            "capacity": self.capacity,
            "ids": self._ids.export(),
            "fields": self._fields.export(),
            "types": self._types.export(),
            "values": self._values.export(),
        }

    def interner_bases(self) -> dict:
        """Append-only table lengths (incremental-summary baselines)."""
        return {"ids": len(self._ids), "fields": len(self._fields),
                "types": len(self._types), "values": len(self._values)}

    def snapshot_rows(self, rows, bases: dict) -> dict:
        """Incremental snapshot: the given doc rows' planes (one gather)
        plus the interner entries appended since ``bases``."""
        rows = np.ascontiguousarray(rows, np.int32)
        if len(rows):
            g = gather_tree_rows(self._state, torch.from_numpy(rows)) \
                if self.sharded is None else tuple(self.sharded.gather(
                    rows, TREE_PLANES + ("overflow",), "cpu").values())
            planes = {k: g[i].cpu().numpy() for i, k in
                      enumerate(TREE_PLANES)}
            overflow = g[-1].cpu().numpy()
        else:
            planes = {k: np.zeros((0, self.capacity), np.int32)
                      for k in TREE_PLANES}
            overflow = np.zeros((0,), np.int32)
        return {
            "rows": rows, "planes": planes, "overflow": overflow,
            "ids_delta": self._ids.export_from(bases["ids"]),
            "next_anon": self._ids._next_anon,
            "fields_delta": self._fields.export_from(bases["fields"]),
            "types_delta": self._types.export_from(bases["types"]),
            "values_delta": self._values.export_from(bases["values"]),
        }

    def apply_row_snapshot(self, delta: dict) -> None:
        """Fold one ``snapshot_rows`` delta (this package's or the JAX
        store's) into this restored-base store: extend the interner tables,
        overwrite the dirty rows."""
        self._ids.extend_from(delta["ids_delta"])
        self._ids._next_anon = max(self._ids._next_anon,
                                   delta["next_anon"])
        self._fields.extend_from(delta["fields_delta"])
        self._types.extend_from(delta["types_delta"])
        self._values.extend_from(delta["values_delta"])
        rows = np.asarray(delta["rows"], np.int64)
        if not len(rows):
            return
        if self.sharded is not None:
            vals = {k: torch.from_numpy(np.asarray(delta["planes"][k],
                                                   np.int32))
                    for k in TREE_PLANES}
            vals["overflow"] = torch.from_numpy(
                np.asarray(delta["overflow"], np.int32))
            self.sharded.scatter(rows, vals)
            return
        write_tree_rows(
            self._state, torch.from_numpy(rows),
            *(torch.from_numpy(np.asarray(delta["planes"][k], np.int32))
              for k in TREE_PLANES),
            torch.from_numpy(np.asarray(delta["overflow"], np.int32)))

    @classmethod
    def restore(cls, snap: dict, device="cuda",
                mesh=None) -> "TensorTreeStore":
        """Rebuild a store from a ``snapshot()`` (this package's or the JAX
        store's numpy planes and interner exports) on ``device``, or
        sharded over ``mesh``: both packages compute the same thing from
        there on. On the card a capacity the kernel does not take is
        refused."""
        overflow = np.asarray(snap["overflow"], np.int32)
        store = cls(overflow.shape[0], int(snap["capacity"]), device, mesh)
        home = store.device if mesh is None else "cpu"
        store.state = TreeState(
            **{k: torch.from_numpy(np.array(snap["planes"][k], np.int32)).to(
                home) for k in TREE_PLANES},
            overflow=torch.from_numpy(overflow.copy()).to(home))
        store._ids = _Interner.restore(snap["ids"])
        store._fields = _Interner.restore(snap["fields"])
        store._types = _Interner.restore(snap["types"])
        store._values = ValueInterner.restore(snap["values"])
        return store

    from_jax_snapshot = restore
