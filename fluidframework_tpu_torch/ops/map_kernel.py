"""Batched SharedMap apply: the (doc × key slot) LWW state on the card.

Port of ``fluidframework_tpu/ops/map_kernel.py``. State per document: K
dense key slots (the host interns string keys to slot ids per doc), three
(D, K) int32 planes:

    present  — 1 if the key currently has a value
    value    — payload handle (the host's value table holds the JSON value)
    last_seq — seq of the write that set it

An op batch is (D, O) int32 planes (kind / a0 = key slot / a1 = value
handle / seq), each doc's ops in op-index order, NOOP-padded. Map semantics
are last-writer-wins with ``clear`` barriers, so for each (doc, key) the
result depends only on the LAST set/delete after the LAST clear: a
reduction over the op axis.

``apply_map_batch`` / ``map_unpack`` / ``map_columnar_apply`` are the plain
PyTorch versions (the CPU tests hold them against the JAX functions);
``apply_map_batch_fused`` / ``map_columnar_apply_fused`` are the entry
points: on a CUDA state they launch the hand kernel ``csrc/map_apply.cu``
(``map_apply``) and write the state IN PLACE, on a CPU state they run the
plain version and copy it into the state. They never fall back.

Parity contract: all three planes bit-identical — JAX vs the plain
version (CPU), and the plain version vs the kernel (card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from . import map_apply
from .merge_tree import _wrap_i32
from .schema import OpKind, ValueInterner, bucket_rows, pad_rows_pow2
from .string_store import resolve_device
from ..parallel.sharded import (
    RowShardedStore, ShardedRows, shard_planes, sharded_map_merge,
    store_shards,
)

_I32 = torch.int32
_SET = int(OpKind.MAP_SET)
_DEL = int(OpKind.MAP_DELETE)
_CLEAR = int(OpKind.MAP_CLEAR)
_NOOP = int(OpKind.NOOP)

PLANES = ("present", "value", "last_seq")


@dataclasses.dataclass
class MapState:
    """D documents × K key slots, three int32 planes on one device."""

    present: torch.Tensor   # (D, K) 0/1
    value: torch.Tensor     # (D, K) payload handle
    last_seq: torch.Tensor  # (D, K)

    @staticmethod
    def create(n_docs: int, n_keys: int, device="cuda") -> "MapState":
        z = lambda: torch.zeros((n_docs, n_keys), dtype=_I32, device=device)
        return MapState(present=z(), value=z(), last_seq=z())

    def fields(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PLANES}


def apply_map_batch(state: MapState, kind, a0, a1, seq) -> MapState:
    """Plain version: a new state after a dense (D, O) batch (OpKind, key
    slot, value handle, seq). Materialises a (D, O, K) one-hot."""
    K = state.present.shape[1]
    dev = kind.device
    o_idx = torch.arange(kind.shape[1], dtype=_I32, device=dev)
    is_clear = kind == _CLEAR
    keyed = (kind == _SET) | (kind == _DEL)
    # index of the last clear per doc (-1 if none)
    last_clear = torch.where(is_clear, o_idx, -1).max(dim=1).values
    # last set/delete per (doc, key) after the last clear
    onehot = a0[:, :, None] == torch.arange(K, dtype=_I32, device=dev)
    relevant = keyed & (o_idx[None, :] > last_clear[:, None])
    cand = torch.where(relevant[:, :, None] & onehot, o_idx[None, :, None],
                       -1)
    last_op = cand.max(dim=1).values                        # (D, K)
    had_clear = (last_clear >= 0)[:, None]
    touched = last_op >= 0
    idx = last_op.clamp(min=0).long()
    op_is_set = torch.gather(kind, 1, idx) == _SET
    op_value = torch.gather(a1, 1, idx)
    op_seq = torch.gather(seq, 1, idx)
    base = {k: torch.where(had_clear, 0, v)
            for k, v in state.fields().items()}
    return MapState(
        present=torch.where(touched, op_is_set.to(_I32), base["present"]),
        value=torch.where(touched & op_is_set, op_value, base["value"]),
        last_seq=torch.where(touched, torch.where(op_is_set, op_seq, 0),
                             base["last_seq"]))


def pack_map_batch(kind, a0, a1, seq_base, rows):
    """Host side of the wire: (R, O) kind / key-slot / value-handle planes
    plus (R,) seq bases and row ids → (int32 word buffer, wide_vals). The
    value lane is u16 unless a handle needs more (then i32)."""
    def seg_u8(arr):
        b = np.ascontiguousarray(arr, np.uint8).reshape(-1)
        if len(b) % 4:
            b = np.concatenate([b, np.zeros((-len(b)) % 4, np.uint8)])
        return b.view("<i4")

    def seg_u16(arr):
        b = np.ascontiguousarray(arr, "<u2").reshape(-1)
        if len(b) % 2:
            b = np.concatenate([b, np.zeros(1, "<u2")])
        return b.view("<i4")

    a1 = np.asarray(a1, np.int32)
    wide_vals = bool(int(a1.max(initial=0)) >= (1 << 16))
    buf = np.concatenate([
        seg_u8(kind), seg_u8(a0),
        (np.ascontiguousarray(a1, "<i4").reshape(-1) if wide_vals
         else seg_u16(a1)),
        np.asarray(seq_base).astype("<i4"), np.asarray(rows).astype("<i4")])
    return buf, wide_vals


def map_unpack(buf: torch.Tensor, R: int, O: int, n_docs: int,
               scatter_rows: bool, wide_vals: bool):
    """Plain version of the wire unpack: one int32 word buffer → dense
    (kind, a0, a1, seq) planes, (R, O), or (n_docs, O) with NOOP planes on
    rows the batch does not carry when ``scatter_rows`` (the apply always
    scatters; the unscattered form is JAX's, kept for the parity tests).

    Buffer: R·O kind bytes, R·O key-slot bytes, R·O values (u16, or i32
    when ``wide_vals``), R seq bases, R row ids, each section padded to
    whole words; bytes and u16s are little-endian inside a word (``>>`` on
    int32 is arithmetic, so every lane is masked). Per-op seqs are rebuilt
    as base + the running count of non-NOOP slots (nacked slots were
    masked to NOOP and consumed no seq)."""
    N = R * O

    def take_u8(off, n):
        w = -(-n // 4)
        words = buf[off:off + w]
        v = torch.stack([words & 0xFF, (words >> 8) & 0xFF,
                         (words >> 16) & 0xFF, (words >> 24) & 0xFF],
                        dim=1).reshape(4 * w)[:n]
        return v, off + w

    def take_u16(off, n):
        w = -(-n // 2)
        words = buf[off:off + w]
        v = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF],
                        dim=1).reshape(2 * w)[:n]
        return v, off + w

    def take_i32(off, n):
        return buf[off:off + n], off + n

    kind, off = take_u8(0, N)
    a0, off = take_u8(off, N)
    a1, off = (take_i32 if wide_vals else take_u16)(off, N)
    base, off = take_i32(off, R)
    rows, off = take_i32(off, R)
    kind, a0, a1 = (p.reshape(R, O) for p in (kind, a0, a1))
    valid = (kind != _NOOP).to(_I32)
    seq = base[:, None] + torch.cumsum(valid, dim=1, dtype=_I32)
    planes = (kind, a0, a1, seq)
    if scatter_rows:
        idx = rows.long()

        def full(p, fill):
            out = torch.full((n_docs, O), fill, dtype=_I32, device=buf.device)
            out[idx] = p
            return out

        planes = (full(kind, _NOOP), full(a0, 0), full(a1, 0), full(seq, 0))
    return planes


def map_columnar_apply(state: MapState, buf, R: int, O: int,
                       wide_vals: bool) -> MapState:
    """Plain version of the fused unpack + apply of one packed batch:
    plane row i lands on state row ``rows[i]`` (the buffer's row ids), as
    in the kernel; rows the batch does not carry are untouched."""
    return apply_map_batch(state, *map_unpack(
        buf, R, O, state.present.shape[0], True, wide_vals))


def map_state_digest(state: MapState) -> torch.Tensor:
    """(D,) int32 digest of the converged state (cross-replica checks);
    wraps like int32, as the JAX digest does."""
    k = torch.arange(state.present.shape[1], dtype=torch.int64,
                     device=state.present.device)
    mix = state.present.long() * (k[None, :] * 1103515245 + 12345) \
        + state.value.long() * 40503 + state.last_seq.long()
    return _wrap_i32(torch.where(state.present > 0, mix, 0).sum(dim=1))


def _copy_into(state: MapState, out: MapState) -> MapState:
    for k, v in state.fields().items():
        v.copy_(getattr(out, k))
    return state


def apply_map_batch_fused(state: MapState, kind, a0, a1, seq) -> MapState:
    """Apply a dense (D, O) int32 batch to ``state`` IN PLACE and return
    it: the kernel on a CUDA state, the plain version on a CPU state."""
    if state.present.device.type == "cpu":
        return _copy_into(state, apply_map_batch(state, kind, a0, a1, seq))
    map_apply.launch_dense(state, kind, a0, a1, seq)
    return state


def map_columnar_apply_fused(state: MapState, buf, R: int, O: int,
                             wide_vals: bool) -> MapState:
    """Apply one packed batch to ``state`` IN PLACE and return it: plane
    row i lands on state row ``rows[i]`` (the buffer's row ids)."""
    if state.present.device.type == "cpu":
        return _copy_into(state, map_columnar_apply(state, buf, R, O,
                                                    wide_vals))
    map_apply.launch_packed(state, buf, R, O, wide_vals)
    return state


class TensorMapStore(RowShardedStore):
    """Many SharedMap documents resident on one device (default the card;
    ``device="cpu"`` runs the plain versions), or split by doc-row block
    over the devices of a 1-D ``docs`` ``mesh`` (one launch a shard).

    Interns string keys to per-doc slots and JSON values to int32 handles,
    packs sequenced ops into dense (D, O) batches, applies them in one
    launch, and reads back per-doc dicts. On a mesh ``state`` is a copy of
    the whole state on the first shard's device; assigning it re-shards."""

    def __init__(self, n_docs: int, n_keys: int = 64, device="cuda",
                 mesh=None):
        self.n_docs = n_docs
        self.n_keys = n_keys
        self.mesh = mesh
        self.sharded = None
        if mesh is None:
            self.device = resolve_device(device)
            self._state = MapState.create(n_docs, n_keys, self.device)
        else:
            devices, rows_per = store_shards(mesh, n_docs)
            self.device = devices[0]
            self.sharded = ShardedRows(
                [MapState.create(rows_per, n_keys, d) for d in devices],
                rows_per)
        self._key_ids: List[Dict[str, int]] = [dict() for _ in range(n_docs)]
        self._interner = ValueInterner()

    # ------------------------------------------------------------- interning

    def key_slot(self, doc: int, key: str) -> int:
        ids = self._key_ids[doc]
        if key not in ids:
            if len(ids) >= self.n_keys:
                raise KeyError(f"doc {doc}: key capacity {self.n_keys} "
                               "exhausted")
            ids[key] = len(ids)
        return ids[key]

    def value_handle(self, value) -> int:
        return self._interner.handle(value)

    # ----------------------------------------------------------------- apply

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A copy of ``a`` as an int32 tensor on the store's device (never
        a view of the caller's array)."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device, copy=True)

    def apply_batch(self, records) -> None:
        """records: iterable of (doc, kind, key, value, seq) with key=str,
        value=JSON for sets (None otherwise), seq ascending."""
        per_doc: Dict[int, list] = {}
        for doc, kind, key, value, seq in records:
            slot = self.key_slot(doc, key) if key is not None else 0
            handle = self.value_handle(value) if kind == OpKind.MAP_SET \
                else 0
            per_doc.setdefault(doc, []).append((int(kind), slot, handle, seq))
        if not per_doc:
            return
        # the op axis is padded to a power of two, as the JAX store does,
        # so the planes are the same
        widest = max(len(v) for v in per_doc.values())
        o = 8
        while o < widest:
            o *= 2
        kind = np.full((self.n_docs, o), _NOOP, dtype=np.int32)
        a0 = np.zeros((self.n_docs, o), dtype=np.int32)
        a1 = np.zeros((self.n_docs, o), dtype=np.int32)
        seq = np.zeros((self.n_docs, o), dtype=np.int32)
        for doc, ops in per_doc.items():
            for j, (k_, s_, h_, q_) in enumerate(ops):
                kind[doc, j] = k_
                a0[doc, j] = s_
                a1[doc, j] = h_
                seq[doc, j] = q_
        if self.sharded is None:
            apply_map_batch_fused(self._state, *(
                self._dev(p) for p in (kind, a0, a1, seq)))
            return
        per = shard_planes(np.stack([kind, a0, a1, seq]), self.mesh,
                           self.sharded.rows_per)
        sharded_map_merge(self.mesh, packed=False)(
            self.sharded.shards, [tuple(p) for p in per])

    def apply_columnar(self, buf: np.ndarray, R: int, O: int,
                       wide_vals: bool) -> None:
        """One packed batch: one host→device copy, one launch."""
        map_columnar_apply_fused(self._state, self._dev(buf), R, O,
                                 wide_vals)

    def apply_rows(self, kind, a0, a1, seq_base, rows) -> None:
        """Sequenced (R, O) kind / key-slot / value-handle planes of doc
        rows ``rows`` with their (R,) seq bases: packed into one buffer
        and applied in one launch, or on a mesh one buffer and one launch
        a shard (its own rows, renumbered to its block)."""
        if self.sharded is None:
            buf, wide_vals = pack_map_batch(kind, a0, a1, seq_base, rows)
            self.apply_columnar(buf, len(rows), kind.shape[1], wide_vals)
            return
        rows = np.asarray(rows, np.int64)
        rp = self.sharded.rows_per
        args = []
        for s, dev in enumerate(self.mesh.doc_devices()):
            mine = np.flatnonzero(rows // rp == s)
            buf, wide_vals = pack_map_batch(
                kind[mine], a0[mine], a1[mine], np.asarray(seq_base)[mine],
                rows[mine] - s * rp)
            args.append((torch.from_numpy(buf).to(dev, copy=True), len(mine),
                         kind.shape[1], wide_vals))
        sharded_map_merge(self.mesh, packed=True)(self.sharded.shards, args)

    # ----------------------------------------------------------------- reads

    def read_doc(self, doc: int) -> dict:
        st, r = self._at(doc)
        present, value = torch.stack(
            [st.present[r], st.value[r]]).cpu().numpy()
        return {key: self._interner.value(value[slot])
                for key, slot in self._key_ids[doc].items() if present[slot]}

    def digests(self) -> np.ndarray:
        return self._per_shard(map_state_digest)

    # ----------------------------------------------------- snapshot / resume

    def snapshot(self) -> dict:
        """Device→host copy of the planes plus the host tables, in the JAX
        store's snapshot format."""
        st = self._state if self.sharded is None \
            else self.sharded.full("cpu")
        out = {k: v.cpu().numpy().copy() for k, v in st.fields().items()}
        out.update(n_keys=self.n_keys,
                   key_ids=[dict(m) for m in self._key_ids],
                   values=self._interner.export())
        return out

    def snapshot_rows(self, rows, values_base: int) -> dict:
        """Incremental snapshot: the given doc rows' planes (one gather)
        plus the value table's entries since ``values_base``."""
        rows = np.ascontiguousarray(rows, np.int32)
        if len(rows) and self.sharded is not None:
            planes = {k: v.numpy() for k, v in
                      self.sharded.gather(rows, PLANES, "cpu").items()}
        elif len(rows):
            idx = torch.from_numpy(rows).to(self.device).long()
            planes = {k: v[idx].cpu().numpy()
                      for k, v in self._state.fields().items()}
        else:
            planes = {k: np.zeros((0, self.n_keys), np.int32)
                      for k in PLANES}
        return {"rows": rows, **planes,
                "key_ids": {int(r): dict(self._key_ids[int(r)])
                            for r in rows},
                "values_delta": self._interner.export_from(values_base)}

    def apply_row_snapshot(self, delta: dict) -> None:
        """Fold one ``snapshot_rows`` delta (this package's or the JAX
        store's) into this restored-base store: overwrite the rows' planes
        in one write per plane, extend the value table, replace the rows'
        key maps."""
        self._interner.extend_from(delta["values_delta"])
        rows = np.asarray(delta["rows"], np.int32)
        if not len(rows):
            return
        for r, m in delta["key_ids"].items():
            self._key_ids[int(r)] = dict(m)
        if self.sharded is not None:
            self.sharded.scatter(rows, {
                k: torch.from_numpy(np.asarray(delta[k], np.int32))
                for k in PLANES})
            return
        rows_p, p2, n = pad_rows_pow2(rows)
        idx = self._dev(rows_p).long()
        for k, v in self._state.fields().items():
            v[idx] = self._dev(bucket_rows(delta[k], p2, n))

    @classmethod
    def restore(cls, snap: dict, device="cuda", mesh=None
                ) -> "TensorMapStore":
        """Rebuild a store from a ``snapshot()`` — this package's or the
        JAX store's (numpy planes, key maps, value table) — on ``device``,
        or sharded over ``mesh``."""
        present = np.asarray(snap["present"], np.int32)
        store = cls(present.shape[0], snap["n_keys"], device, mesh)
        store.state = MapState(**{
            k: torch.from_numpy(np.array(snap[k], np.int32)).to(
                store.device if mesh is None else "cpu")
            for k in PLANES})
        store._key_ids = [dict(m) for m in snap["key_ids"]]
        store._interner = ValueInterner.restore(snap["values"])
        return store

    from_jax_snapshot = restore
