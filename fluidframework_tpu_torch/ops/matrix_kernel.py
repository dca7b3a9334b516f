"""SharedMatrix cell storage: a sorted sparse cell table on the card.

Port of ``fluidframework_tpu/ops/matrix_kernel.py`` (the cell table; the
doc-sharded ``ShardedMatrixStore`` is ROADMAP B9). The state is a table of
capacity T of (cell key, seq, value) rows, key-sorted with unique live
keys; free slots carry ``EMPTY_KEY`` and sort to the tail. A batch of
sequenced set-cell ops (key, seq, value; pads carry ``EMPTY_KEY``) is
merged into it under last-writer-wins (the reference's default) or
first-writer-wins (after ``switchSetCellPolicy``):

    sort the batch by (key, seq) → merge it with the table → keep the
    winner of each key (LWW: the last; FWW: the first) → compact

Prefix mode (``apply_cells_prefix``) merges only ``table[:L]``: keys are
dense interned ids, so live cells fit in the first L slots when L exceeds
the identity count; equal keys put the table first (batch seqs are newer
than any stored one). Full mode (``apply_cells_batch``) merges the whole
table by (key, seq). A live cell that would fall past L (or T) sets the
sticky ``overflow`` flag.

``merge_cells`` (and its two forms ``apply_cells_prefix`` /
``apply_cells_batch``, the JAX names) is the plain PyTorch version;
``merge_cells_fused`` is the entry point: on a CUDA state it
launches the hand kernel ``csrc/cell_merge.cu`` (``cell_merge``) and writes
the state IN PLACE, on a CPU state it runs the plain version and copies it
into the state. It never falls back.

Parity contract:
- prefix merge: all planes, count and overflow bit-identical, JAX vs the
  plain version (CPU) and the plain version vs the kernel (card);
- full merge: ``[0, count)`` of key / seq / value, the whole key plane,
  count, overflow and digest equal to JAX. The JAX table's tail past
  ``count`` holds demoted losers' seq / value in the order an unstable
  sort left them, so it is not compared; the plain version and the kernel
  both zero it and match each other bit for bit.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cell_merge
from .merge_tree import _wrap_i32
from .schema import ValueInterner
from .string_store import resolve_device
from ..parallel.sharded import sharded_cells_apply, store_shards

EMPTY_KEY = np.int32(2**31 - 1)
_I32 = torch.int32
_EMPTY = int(EMPTY_KEY)
PLANES = ("key", "seq", "value")


@dataclasses.dataclass
class MatrixCellState:
    """A sorted sparse cell table of capacity T on one device."""

    key: torch.Tensor       # (T,) int32 cell id, EMPTY_KEY in free slots
    seq: torch.Tensor       # (T,) int32 seq of the winning write
    value: torch.Tensor     # (T,) int32 payload handle
    count: torch.Tensor     # ()   int32 live entries
    overflow: torch.Tensor  # ()   int32 sticky overflow flag

    @staticmethod
    def create(capacity: int, device="cuda") -> "MatrixCellState":
        return MatrixCellState(
            key=torch.full((capacity,), _EMPTY, dtype=_I32, device=device),
            seq=torch.zeros((capacity,), dtype=_I32, device=device),
            value=torch.zeros((capacity,), dtype=_I32, device=device),
            count=torch.zeros((), dtype=_I32, device=device),
            overflow=torch.zeros((), dtype=_I32, device=device))

    def fields(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k)
                for k in PLANES + ("count", "overflow")}


def _sort_batch(key, seq, value):
    """The batch ordered by (key, seq, value); value only makes the order
    total (the kernel's sort uses the same one)."""
    order = torch.argsort(value, stable=True)
    for col in (seq, key):
        order = order[torch.argsort(col[order], stable=True)]
    return key[order], seq[order], value[order]


def _composite(key, seq, seq_if_empty):
    """int64 (key, seq) sort key; an EMPTY key takes ``seq_if_empty``."""
    s = torch.where(key == _EMPTY, seq_if_empty, seq).long()
    return (key.long() << 32) + (s + 2**31)


def merge_cells(state: MatrixCellState, op_key, op_seq, op_value,
                L: Optional[int] = None, fww: bool = False
                ) -> MatrixCellState:
    """Plain version of both merges: a new state after merging the (O,)
    batch into ``table[:L]`` (prefix mode) or the whole table (``L`` None:
    full mode)."""
    T = state.key.shape[0]
    Lt = T if L is None else L
    tk, ts, tv = state.key[:Lt], state.seq[:Lt], state.value[:Lt]
    ok, os_, ov = _sort_batch(op_key, op_seq, op_value)
    O, dev = ok.shape[0], ok.device
    # merge order: a table element goes before a batch element iff its key
    # is smaller, or the keys are equal and (prefix mode, or the key is
    # EMPTY, or its seq is not greater)
    if L is None:
        ca = _composite(tk, ts, -2**31)
        cb = _composite(ok, os_, 2**31 - 1)
    else:
        ca, cb = tk, ok
    pos_b = torch.arange(O, device=dev) + torch.searchsorted(ca, cb,
                                                             right=True)
    pos_a = torch.arange(Lt, device=dev) + torch.searchsorted(cb, ca)
    merged = []
    for a, b in ((tk, ok), (ts, os_), (tv, ov)):
        m = torch.empty(Lt + O, dtype=_I32, device=dev)
        m[pos_a] = a
        m[pos_b] = b
        merged.append(m)
    mk, ms, mv = merged
    same = mk[1:] == mk[:-1]
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    if fww:
        win = ~torch.cat([no, same])
    else:
        win = ~torch.cat([same, no])
    win &= mk != _EMPTY
    live = win.sum(dtype=_I32)
    n = min(int(live), Lt)
    out = []
    for m, fill, full in ((mk, _EMPTY, state.key), (ms, 0, state.seq),
                          (mv, 0, state.value)):
        o = full.clone()
        o[:Lt] = fill
        o[:n] = m[win][:n]
        out.append(o)
    return MatrixCellState(
        key=out[0], seq=out[1], value=out[2],
        count=torch.clamp(live, max=T),
        overflow=torch.where(live > Lt, 1, state.overflow).to(_I32))


def apply_cells_batch(state: MatrixCellState, op_key, op_seq, op_value,
                      fww: bool = False) -> MatrixCellState:
    """Plain version of the full merge (the whole table)."""
    return merge_cells(state, op_key, op_seq, op_value, None, fww)


def apply_cells_prefix(state: MatrixCellState, op_key, op_seq, op_value,
                       L: int, fww: bool = False) -> MatrixCellState:
    """Plain version of the prefix merge (``table[:L]``; the rest passes
    through)."""
    return merge_cells(state, op_key, op_seq, op_value, L, fww)


def merge_cells_fused(state: MatrixCellState, op_key, op_seq, op_value,
                      L: Optional[int] = None,
                      fww: bool = False) -> MatrixCellState:
    """Merge a (O,) int32 batch into ``state`` IN PLACE and return it:
    prefix mode on ``table[:L]``, or full mode when ``L`` is None. The
    kernel on a CUDA state, the plain version on a CPU state."""
    if state.key.device.type == "cpu":
        out = merge_cells(state, op_key, op_seq, op_value, L, fww)
        for k, v in state.fields().items():
            v.copy_(getattr(out, k))
        return state
    cell_merge.launch(state, op_key, op_seq, op_value, L, fww)
    return state


def matrix_cells_digest(state: MatrixCellState) -> torch.Tensor:
    """() int32 order-invariant digest of the live cell set, wrapping like
    int32 as the JAX digest does."""
    live = state.key != _EMPTY
    mix = state.key.long() * 1000003 + state.value.long() * 8191 \
        + state.seq.long()
    return _wrap_i32(torch.where(live, mix, 0).sum() + state.count.long())


def _intern_values_column(interner: ValueInterner, values) -> np.ndarray:
    """Value handles for a whole cell column. A column of Python ints
    interns one handle per unique value and gathers (``bool`` is not an
    int here: ``True`` and ``1`` encode differently); anything else takes
    the general path."""
    if set(map(type, values)) == {int}:
        u, inv = np.unique(np.asarray(values, np.int64),
                           return_inverse=True)
        return np.asarray(interner.bulk_ints(u.tolist()), np.int32)[inv]
    return np.asarray(interner.bulk(values), np.int32)


def tuple_key(k):
    """Re-tuple a cell identity (a snapshot's transport may have turned
    nested tuples into lists)."""
    return tuple(tuple_key(x) if isinstance(x, (list, tuple)) else x
                 for x in k)


def live_cells(snap: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """(key, seq, value, overflow flags) of the live cells of a table
    snapshot or delta, either package's, of one pool ((T,) planes, scalar
    count) or of a doc-sharded one ((S, T/S) planes, (S,) counts): the
    pools' live prefixes concatenated, sorted by key."""
    key = np.asarray(snap["key"], np.int32)
    count = np.atleast_1d(np.asarray(snap["count"], np.int64))
    if key.ndim == 1:
        key = key[None]
    seq = np.asarray(snap["seq"], np.int32).reshape(key.shape)
    val = np.asarray(snap["value"], np.int32).reshape(key.shape)
    parts = [(key[i, :n], seq[i, :n], val[i, :n])
             for i, n in enumerate(count.tolist())]
    k, q, v = (np.concatenate([p[j] for p in parts]) for j in range(3))
    order = np.argsort(k, kind="stable")
    return (k[order], q[order], v[order],
            np.atleast_1d(np.asarray(snap["overflow"], np.int32)))


class TensorMatrixStore:
    """One SharedMatrix document's cells resident on one device (default
    the card; ``device="cpu"`` runs the plain versions).

    Interns (rowKey, colKey) identities and JSON values to int32 handles,
    packs sequenced set-cell records into (batch,) chunks and merges each
    in one launch; reads back cells."""

    def __init__(self, capacity: int, batch_size: int = 4096,
                 device="cuda"):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.batch = batch_size
        self.state = MatrixCellState.create(capacity, self.device)
        self._cell_ids: Dict[Tuple, int] = {}
        self._interner = ValueInterner()
        self.fww = False

    def cell_id(self, row_key, col_key) -> int:
        k = (row_key, col_key)
        if k not in self._cell_ids:
            self._cell_ids[k] = len(self._cell_ids)
        return self._cell_ids[k]

    def value_handle(self, value) -> int:
        return self._interner.handle(value)

    def conservative_room(self, extra: int) -> bool:
        """Can ``extra`` more distinct identities still fit the table?"""
        return len(self._cell_ids) + extra < self.capacity

    def switch_set_cell_policy(self) -> None:
        """One-way LWW → FWW switch (the reference's
        ``switchSetCellPolicy``)."""
        self.fww = True

    def _merge_chunk(self, key, seq, val) -> None:
        """One padded chunk: prefix mode on the smallest power of two
        L >= 8 above the identity count while L < capacity (live cells are
        at most the identities), full mode after that."""
        L = 8
        need = min(len(self._cell_ids) + 1, self.capacity)
        while L < need:
            L *= 2
        planes = torch.from_numpy(np.stack([key, seq, val]).astype(
            np.int32)).to(self.device, copy=True)   # one host→device copy
        merge_cells_fused(self.state, planes[0], planes[1], planes[2],
                          None if L >= self.capacity else L, self.fww)

    def _pad(self, key, seq, val):
        pad = self.batch - len(key)
        if pad:
            key = np.concatenate([key, np.full(pad, EMPTY_KEY, np.int32)])
            seq = np.concatenate([seq, np.zeros(pad, np.int32)])
            val = np.concatenate([val, np.zeros(pad, np.int32)])
        return key, seq, val

    def apply_batch(self, records) -> None:
        """records: iterable of (row_key, col_key, value, seq), seq
        ascending."""
        recs = [(self.cell_id(r, c), int(s), self.value_handle(v))
                for r, c, v, s in records]
        for i in range(0, len(recs), self.batch):
            chunk = np.asarray(recs[i:i + self.batch], np.int32)
            self._merge_chunk(*self._pad(chunk[:, 0], chunk[:, 1],
                                         chunk[:, 2]))

    def apply_batch_columnar(self, row_keys, col_keys, values,
                             seqs) -> None:
        """Columnar twin of ``apply_batch``: identity and value columns
        interned in one pass each, chunks sliced from arrays."""
        n = len(row_keys)
        if not n:
            return
        ids = self._cell_ids
        get = ids.get
        key = np.empty(n, np.int32)
        for i, k in enumerate(zip(row_keys, col_keys)):
            h = get(k)
            if h is None:
                h = ids[k] = len(ids)
            key[i] = h
        val = _intern_values_column(self._interner, values)
        seqs = np.ascontiguousarray(seqs, np.int32)
        for i in range(0, n, self.batch):
            self._merge_chunk(*self._pad(key[i:i + self.batch],
                                         seqs[i:i + self.batch],
                                         val[i:i + self.batch]))

    # ----------------------------------------------------------------- reads

    def read_cell(self, cell: Tuple):
        """One cell's value: a searchsorted probe of the key-sorted table
        on the device and one two-int read, not a table copy."""
        cid = self._cell_ids.get(cell)
        if cid is None:
            return None
        probe = torch.tensor([cid], dtype=_I32, device=self.device)
        idx = torch.searchsorted(self.state.key, probe).clamp(
            max=self.capacity - 1)
        k, v = torch.stack([self.state.key[idx],
                            self.state.value[idx]]).cpu().view(-1).tolist()
        return self._interner.value(v) if k == cid else None

    def read_cells(self) -> dict:
        """{(rowKey, colKey): value} for all live cells."""
        keys = self.state.key.cpu().numpy()
        vals = self.state.value.cpu().numpy()
        live = keys != EMPTY_KEY
        by_id = dict(zip(keys[live].tolist(), vals[live].tolist()))
        return {cell: self._interner.value(by_id[cid])
                for cell, cid in self._cell_ids.items() if cid in by_id}

    def overflowed(self) -> bool:
        return bool(self.state.overflow.item())

    def digest(self) -> int:
        return int(matrix_cells_digest(self.state))

    # ----------------------------------------------------- snapshot / resume

    def snapshot(self) -> dict:
        """Device→host copy of the table plus the host tables, in the JAX
        store's snapshot format."""
        st = self.state
        return {
            "key": st.key.cpu().numpy().copy(),
            "seq": st.seq.cpu().numpy().copy(),
            "value": st.value.cpu().numpy().copy(),
            "count": int(st.count), "overflow": int(st.overflow),
            "batch": self.batch,
            "cell_ids": list(self._cell_ids.items()),
            "values": self._interner.export(),
            "fww": self.fww,
        }

    def table_bases(self) -> dict:
        """Append-only table lengths (incremental-summary baselines)."""
        return {"cell_ids": len(self._cell_ids),
                "values": len(self._interner)}

    def snapshot_delta(self, bases: dict) -> dict:
        """Incremental snapshot: the live prefix of the table (every merge
        rewrites the table, so the cell delta is the whole live set) plus
        the identity / value table entries since ``bases``."""
        n = max(int(self.state.count), 0)
        return {
            "key": self.state.key[:n].cpu().numpy().copy(),
            "seq": self.state.seq[:n].cpu().numpy().copy(),
            "value": self.state.value[:n].cpu().numpy().copy(),
            "count": n, "overflow": int(self.state.overflow),
            "fww": self.fww,
            "cell_ids_delta": list(itertools.islice(
                self._cell_ids.items(), bases["cell_ids"], None)),
            "values_delta": self._interner.export_from(bases["values"]),
        }

    def _set_table(self, key, seq, val, count: int, overflow: int) -> None:
        """Upload a table. Free slots get seq / value 0: the kernel reads
        only the live extent and relies on an EMPTY / 0 / 0 tail (a JAX
        full merge leaves losers' seq / value there, outside the parity
        contract)."""
        planes = np.stack([key, seq, val]).astype(np.int32)
        planes[1:, planes[0] == EMPTY_KEY] = 0
        planes = torch.from_numpy(planes).to(self.device, copy=True)
        scalars = torch.tensor([count, overflow], dtype=_I32,
                               device=self.device)
        self.state = MatrixCellState(key=planes[0], seq=planes[1],
                                     value=planes[2], count=scalars[0],
                                     overflow=scalars[1])

    def _set_live(self, snap: dict) -> None:
        """Upload the live cells of a table snapshot or delta, of one pool
        or of a doc-sharded one (its pools merged by key)."""
        k, q, v, ov = live_cells(snap)
        n = len(k)
        if n > self.capacity:
            raise ValueError(f"{n} live cells do not fit capacity "
                             f"{self.capacity}")
        key = np.full((self.capacity,), EMPTY_KEY, np.int32)
        seq = np.zeros((self.capacity,), np.int32)
        val = np.zeros((self.capacity,), np.int32)
        key[:n], seq[:n], val[:n] = k, q, v
        self._set_table(key, seq, val, n, int(ov.any()))

    def apply_delta(self, delta: dict) -> None:
        """Fold one ``snapshot_delta`` (this package's or the JAX store's,
        of one pool or a doc-sharded one) into this restored-base store:
        replace the table, extend the append-only tables."""
        self._set_live(delta)
        for k, v in delta["cell_ids_delta"]:
            self._cell_ids[tuple_key(k)] = v
        self._interner.extend_from(delta["values_delta"])
        self.fww = delta["fww"]

    @classmethod
    def restore(cls, snap: dict, device="cuda") -> "TensorMatrixStore":
        """Rebuild a store from a ``snapshot()`` — this package's or the
        JAX store's — on ``device``. A doc-sharded pool's snapshot
        (``"sharded_docs"``) restores as one pool of the same total
        capacity, its shards' live cells merged by key."""
        store = cls(int(np.asarray(snap["key"]).size), snap["batch"], device)
        if "sharded_docs" in snap:
            store._set_live(snap)
        else:
            store._set_table(snap["key"], snap["seq"], snap["value"],
                             int(snap["count"]), int(snap["overflow"]))
        store._cell_ids = {tuple_key(k): v for k, v in snap["cell_ids"]}
        store._interner = ValueInterner.restore(snap["values"])
        store.fww = snap["fww"]
        return store

    from_jax_snapshot = restore


class ShardedMatrixStore:
    """Doc-sharded cell pools (mesh mode): shard s owns the cells of doc
    rows [s·D/S, (s+1)·D/S) in a pool of ``capacity / S`` slots on its
    device. Cells are doc-scoped (the doc row is the first component of
    every cell identity ``((row, rowKey), colKey)``), so routing by owning
    doc keeps the sort-merge shard-local: each chunk launches the merge
    once a shard. Same host API as ``TensorMatrixStore``; the snapshot is
    the JAX sharded store's (``"sharded_docs"``)."""

    def __init__(self, capacity: int, mesh, n_docs: int,
                 batch_size: int = 4096):
        devices, _ = store_shards(mesh, n_docs)
        ns = len(devices)
        if capacity % ns:
            raise ValueError(f"cell capacity {capacity} not divisible by "
                             f"mesh size {ns}")
        self.capacity = capacity          # total across shards
        self.shard_capacity = capacity // ns
        self.n_shards = ns
        self.n_docs = n_docs
        self.mesh = mesh
        self.devices = devices
        self.device = devices[0]
        self.batch = batch_size
        self.shards = [MatrixCellState.create(self.shard_capacity, d)
                       for d in devices]
        self._cell_ids: Dict[Tuple, int] = {}
        self._shard_counts = [0] * ns    # interned identities per shard
        self._interner = ValueInterner()
        self.fww = False

    def shard_of_row(self, row: int) -> int:
        return row * self.n_shards // self.n_docs

    def cell_id(self, row_key, col_key) -> int:
        k = (row_key, col_key)
        if k not in self._cell_ids:
            self._cell_ids[k] = len(self._cell_ids)
            self._shard_counts[self.shard_of_row(row_key[0])] += 1
        return self._cell_ids[k]

    def value_handle(self, value) -> int:
        return self._interner.handle(value)

    def conservative_room(self, extra: int) -> bool:
        """Worst case: every pending cell mints on the fullest shard."""
        return max(self._shard_counts) + extra < self.shard_capacity

    def switch_set_cell_policy(self) -> None:
        self.fww = True

    def _merge_shards(self, per_shard: list) -> None:
        """Merge each shard's (key, seq, value) stream into its pool in
        chunks of ``batch``: chunk i launches once on every shard, padded
        to the pow2 (>= 8) of the widest shard's chunk; prefix mode on the
        pow2 above the shard's identity count while it is below the
        shard's capacity (as ``TensorMatrixStore``)."""
        widest = max((len(p[0]) for p in per_shard), default=0)
        for base in range(0, widest, self.batch):
            o = min(self.batch, widest - base)
            o2 = 8
            while o2 < o:
                o2 *= 2
            batches = []
            for s, dev in enumerate(self.devices):
                k, q, v = (a[base:base + self.batch] for a in per_shard[s])
                planes = np.zeros((3, o2), np.int32)
                planes[0] = EMPTY_KEY
                planes[0, :len(k)], planes[1, :len(k)] = k, q
                planes[2, :len(k)] = v
                L = 8
                need = min(self._shard_counts[s] + 1, self.shard_capacity)
                while L < need:
                    L *= 2
                dp = torch.from_numpy(planes).to(dev, copy=True)
                batches.append((dp[0], dp[1], dp[2],
                                None if L >= self.shard_capacity else L))
            sharded_cells_apply(self.mesh, self.fww)(self.shards, batches)

    def apply_batch(self, records) -> None:
        """records: iterable of (row_key, col_key, value, seq), seq
        ascending; row_key = (doc_row, resolved key) — the doc row routes
        the write to its owning shard's pool."""
        per: list = [[] for _ in range(self.n_shards)]
        for r, c, v, q in records:
            per[self.shard_of_row(r[0])].append(
                (self.cell_id(r, c), int(q), self.value_handle(v)))
        self._merge_shards([tuple(np.asarray(p, np.int32).reshape(-1, 3).T)
                            for p in per])

    def apply_batch_columnar(self, row_keys, col_keys, values,
                             seqs) -> None:
        """Columnar twin of ``apply_batch`` with the same doc-row routing;
        a stable partition keeps each shard's stream seq-ascending."""
        n = len(row_keys)
        if not n:
            return
        ids = self._cell_ids
        counts = self._shard_counts
        ns, nd = self.n_shards, self.n_docs
        key = np.empty(n, np.int32)
        shard = np.empty(n, np.int32)
        for i, k in enumerate(zip(row_keys, col_keys)):
            sh = k[0][0] * ns // nd
            h = ids.get(k)
            if h is None:
                h = ids[k] = len(ids)
                counts[sh] += 1
            key[i] = h
            shard[i] = sh
        val = _intern_values_column(self._interner, values)
        seqs = np.ascontiguousarray(seqs, np.int32)
        order = np.argsort(shard, kind="stable")
        bounds = np.searchsorted(shard[order], np.arange(ns + 1))
        self._merge_shards([
            tuple(a[order[bounds[s]:bounds[s + 1]]] for a in (key, seqs, val))
            for s in range(ns)])

    # ----------------------------------------------------------------- reads

    def read_cell(self, cell: Tuple):
        cid = self._cell_ids.get(cell)
        if cid is None:
            return None
        st = self.shards[self.shard_of_row(cell[0][0])]
        probe = torch.tensor([cid], dtype=_I32, device=st.key.device)
        idx = torch.searchsorted(st.key, probe).clamp(
            max=self.shard_capacity - 1)
        k, v = torch.stack([st.key[idx], st.value[idx]]).cpu().view(
            -1).tolist()
        return self._interner.value(v) if k == cid else None

    def _host(self) -> dict:
        return {k: np.stack([getattr(st, k).cpu().numpy()
                             for st in self.shards])
                for k in PLANES + ("count", "overflow")}

    def read_cells(self) -> dict:
        h = self._host()
        keys, vals = h["key"].reshape(-1), h["value"].reshape(-1)
        live = keys != EMPTY_KEY
        by_id = dict(zip(keys[live].tolist(), vals[live].tolist()))
        return {cell: self._interner.value(by_id[cid])
                for cell, cid in self._cell_ids.items() if cid in by_id}

    def overflowed(self) -> bool:
        return bool(self._host()["overflow"].any())

    def digest(self) -> int:
        """The digest of the pools' live cells as one table (equal to the
        unsharded store's on the same cells)."""
        h = self._host()
        live = h["key"] != EMPTY_KEY
        mix = h["key"].astype(np.int64) * 1000003 + \
            h["value"].astype(np.int64) * 8191 + h["seq"].astype(np.int64)
        total = int(np.where(live, mix, 0).sum() + h["count"].sum())
        return int(np.int64(total).astype(np.int32))

    # ----------------------------------------------------- snapshot / resume

    def snapshot(self) -> dict:
        h = self._host()
        return {**h, "batch": self.batch,
                "cell_ids": list(self._cell_ids.items()),
                "values": self._interner.export(), "fww": self.fww,
                "sharded_docs": self.n_docs}

    def table_bases(self) -> dict:
        return {"cell_ids": len(self._cell_ids),
                "values": len(self._interner)}

    def snapshot_delta(self, bases: dict) -> dict:
        """Per-shard live-trimmed pools plus the append-only table deltas
        (the JAX sharded store's layout)."""
        h = self._host()
        w = max(int(h["count"].max()), 1)
        return {
            "key": h["key"][:, :w].copy(), "seq": h["seq"][:, :w].copy(),
            "value": h["value"][:, :w].copy(),
            "count": h["count"].copy(), "overflow": h["overflow"].copy(),
            "fww": self.fww,
            "cell_ids_delta": list(itertools.islice(
                self._cell_ids.items(), bases["cell_ids"], None)),
            "values_delta": self._interner.export_from(bases["values"]),
        }

    def _set_live(self, snap: dict) -> None:
        """Deal the live cells of a table snapshot or delta (one pool or a
        sharded one, of any shard count) to their owning shards' pools by
        the doc row of each cell's identity (needs ``_cell_ids``)."""
        k, q, v, ov = live_cells(snap)
        row_of = {cid: cell[0][0] for cell, cid in self._cell_ids.items()}
        owner = np.fromiter((self.shard_of_row(row_of[int(c)]) for c in k),
                            np.int64, count=len(k))
        same = len(ov) == self.n_shards
        for s, (st, dev) in enumerate(zip(self.shards, self.devices)):
            mine = owner == s
            n = int(mine.sum())
            if n > self.shard_capacity:
                raise ValueError(f"shard {s}: {n} live cells do not fit "
                                 f"{self.shard_capacity}")
            planes = np.zeros((3, self.shard_capacity), np.int32)
            planes[0] = EMPTY_KEY
            planes[0, :n], planes[1, :n], planes[2, :n] = \
                k[mine], q[mine], v[mine]
            dp = torch.from_numpy(planes).to(dev, copy=True)
            flag = int(ov[s]) if same else int(ov.any())
            sc = torch.tensor([n, flag], dtype=_I32, device=dev)
            self.shards[s] = MatrixCellState(key=dp[0], seq=dp[1],
                                             value=dp[2], count=sc[0],
                                             overflow=sc[1])

    def _add_ids(self, items) -> None:
        for k, v in items:
            ck = tuple_key(k)
            if ck not in self._cell_ids:
                self._shard_counts[self.shard_of_row(ck[0][0])] += 1
            self._cell_ids[ck] = v

    def apply_delta(self, delta: dict) -> None:
        self._add_ids(delta["cell_ids_delta"])
        self._set_live(delta)
        self._interner.extend_from(delta["values_delta"])
        self.fww = delta["fww"]

    @classmethod
    def restore(cls, snap: dict, mesh,
                n_docs: Optional[int] = None) -> "ShardedMatrixStore":
        """Rebuild from a snapshot — this package's or the JAX store's, of
        a sharded pool (``"sharded_docs"``) or of one pool, whose cells
        are then dealt to their docs' shards (``n_docs`` needed) — over
        ``mesh``, at the snapshot's total capacity."""
        n_docs = snap.get("sharded_docs", n_docs)
        if n_docs is None:
            raise ValueError("an unsharded cell pool needs n_docs to shard")
        store = cls(int(np.asarray(snap["key"]).size), mesh, n_docs,
                    batch_size=snap["batch"])
        store._add_ids(snap["cell_ids"])
        store._set_live(snap)
        store._interner = ValueInterner.restore(snap["values"])
        store.fww = snap["fww"]
        return store
