"""Host facade of the mega tier: long documents whose slot axis is split
into shards (``megadoc_kernel``), all on one device.

Reference counterpart: ``fluidframework_tpu/ops/megadoc_store.py``. It
mirrors ``TensorStringStore`` — payload interning, client indexes, text
and property reads, shared through ``StringOpInterner`` — and runs the
mega tier's host side: batches apply in op windows sized so that a shard
below the rebalance threshold cannot overflow within one window, with a
preemptive rebalance between windows. An overflow means dropped ops and a
rebuild from the log (the engine's recovery), never a rebalance.

On the card every apply is one launch of K7 (``csrc/megadoc_apply.cu``);
a shard count or ``capacity_per_shard`` that K7 does not take is refused
with ``ValueError`` when the store (or its ``restore``) is built. CPU
tensors run the plain version.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.constants import NOT_REMOVED
from .megadoc_kernel import (
    apply_megadoc_batch, compact_megadoc, create_megadoc_state,
    megadoc_digest, rebalance_megadoc, refuse_mesh, visible_runs,
)
from .merge_tree import PLANES, StringState
from .schema import OpKind, ValueInterner
from .string_store import _TEXT, StringOpInterner, resolve_device

N_PROPS = 4   # property planes a new store has (the JAX store's default)


def _check_layout(device: torch.device, n_shards: int, capacity: int,
                  n_props: int) -> None:
    if device.type == "cuda":
        from . import megadoc_apply
        megadoc_apply.check_layout(n_shards, capacity, n_props)


def live_slots(state: StringState, doc: int = 0) -> Dict[str, np.ndarray]:
    """Doc ``doc``'s live slots in document order as host arrays: every
    plane (m,) and ``prop_val`` (m, K). Takes both layouts: flat (count
    (D,)) and mega (count (D, n_shards), shard-major: [0, count) of each
    shard in shard order)."""
    count = state.count[doc].reshape(-1).cpu().numpy()
    S = state.seq.shape[1] // count.shape[0]
    idx = np.concatenate([np.arange(s * S, s * S + c, dtype=np.int64)
                          for s, c in enumerate(count.tolist())])
    out = {k: getattr(state, k)[doc].cpu().numpy()[idx] for k in PLANES}
    out["prop_val"] = state.prop_val[doc].cpu().numpy()[idx]
    return out


class MegaDocStringStore(StringOpInterner):
    """D mega-docs of ``n_shards`` × ``capacity_per_shard`` slots on
    ``device``. The state is updated in place by every apply; compaction
    and rebalancing replace it."""

    def __init__(self, n_docs: int, capacity_per_shard: int = 256,
                 n_shards: int = 8, rebalance_headroom: float = 0.25,
                 device="cuda", mesh=None):
        refuse_mesh(mesh)
        self.device = resolve_device(device)
        _check_layout(self.device, n_shards, capacity_per_shard, N_PROPS)
        self.n_docs = n_docs
        self.n_shards = n_shards
        self.capacity_per_shard = capacity_per_shard
        self.rebalance_headroom = rebalance_headroom
        self.state = create_megadoc_state(n_docs, capacity_per_shard,
                                          n_shards, N_PROPS, self.device)
        self._init_interner(n_docs, N_PROPS)
        # bumped whenever the state changes: the read cache's key
        self._version = 0
        self._runs_cache = None
        self._runs_version = -1

    # ----------------------------------------------------------------- apply

    def apply_messages(self, messages) -> None:
        """messages: iterable of (doc, SequencedDocumentMessage) carrying
        merge-tree op contents; the contract of TensorStringStore."""
        per_doc: Dict[int, list] = {}
        for doc, msg in messages:
            recs = self._records_for(doc, msg)
            if recs:
                per_doc.setdefault(doc, []).extend(recs)
        if not per_doc:
            return
        # a fresh mega-doc concentrates inserts on one shard and an op adds
        # at most 2 slots there, so a window of headroom / 2 ops cannot push
        # a shard below the threshold past its capacity before the next
        # rebalance check
        window = max(1, int(self.capacity_per_shard *
                            self.rebalance_headroom) // 2)
        widest = max(len(v) for v in per_doc.values())
        for off in range(0, widest, window):
            chunk = {d: recs[off:off + window]
                     for d, recs in per_doc.items() if len(recs) > off}
            self._maybe_rebalance()
            self._apply_chunk(chunk)

    def _apply_chunk(self, per_doc: Dict[int, list]) -> None:
        widest = max(len(v) for v in per_doc.values())
        o = 8
        while o < widest:
            o *= 2
        planes = np.zeros((7, self.n_docs, o), np.int32)
        planes[0] = int(OpKind.NOOP)
        for doc, recs in per_doc.items():
            planes[:, doc, :len(recs)] = np.asarray(recs, np.int32).T
        ops = torch.from_numpy(planes).to(self.device)
        apply_megadoc_batch(self.state, *(ops[i] for i in range(7)))
        self._version += 1

    def _maybe_rebalance(self) -> None:
        """Spread a doc's slots over its shards when any shard is within
        ``rebalance_headroom`` of its capacity. Overflowed state is left as
        it is (the sticky flag is the recovery's evidence)."""
        if bool(self.state.overflow.any()):
            return
        threshold = self.capacity_per_shard * (1 - self.rebalance_headroom)
        if int(self.state.count.max()) > threshold:
            self.state = rebalance_megadoc(self.state)
            self._version += 1

    def compact(self, min_seq) -> None:
        ms = np.full((self.n_docs,), int(min_seq), np.int32) \
            if np.isscalar(min_seq) else np.asarray(min_seq, np.int32)
        self.state = compact_megadoc(self.state,
                                     torch.from_numpy(ms).to(self.device))
        self._version += 1

    # ----------------------------------------------------------------- reads

    def _runs(self):
        """``visible_runs`` pulled to the host once per state version."""
        if self._runs_version != self._version:
            self._runs_cache = visible_runs(self.state)
            self._runs_version = self._version
        return self._runs_cache

    def read_text(self, doc: int) -> str:
        parts = []
        for op, off, ln, _props in self._runs()[doc]:
            kind, text = self._payloads[op]
            if kind == _TEXT:
                parts.append(text[off:off + ln])
        return "".join(parts)

    def visible_length(self, doc: int) -> int:
        return sum(ln for _op, _off, ln, _p in self._runs()[doc])

    def seq_at(self, doc: int, pos: int) -> int:
        """Insert seq of the slot holding visible position ``pos``, walked
        shard-major over the doc's planes."""
        st = self.state
        count = st.count[doc].cpu().numpy()
        rem, ln, sq = (getattr(st, k)[doc].cpu().numpy()
                       for k in ("removed_seq", "length", "seq"))
        at = 0
        for s in range(self.n_shards):
            lo = s * self.capacity_per_shard
            for i in range(lo, lo + count[s]):
                if rem[i] != NOT_REMOVED:
                    continue
                if at <= pos < at + ln[i]:
                    return int(sq[i])
                at += ln[i]
        raise IndexError(f"doc {doc}: position {pos} beyond length {at}")

    def get_properties(self, doc: int, pos: int) -> dict:
        """Properties of the character at visible position ``pos``."""
        at = 0
        for _op, _off, ln, props in self._runs()[doc]:
            if at <= pos < at + ln:
                return {key: self._prop_values.value(int(props[plane]))
                        for key, plane in self._prop_planes.items()
                        if props[plane] != 0}
            at += ln
        raise IndexError(f"doc {doc}: position {pos} beyond length {at}")

    # ----------------------------------------------------- overflow recovery

    def adopt_doc(self, row: int, tmp) -> "MegaDocStringStore":
        """Adopt a rebuilt single-doc store's state (``tmp``, doc 0: a flat
        ``TensorStringStore`` or a one-doc ``MegaDocStringStore``) into
        mega-doc ``row``: the re-upload step of overflow recovery. Its
        live slots in document order (``live_slots``) are dealt evenly
        over the shards (ceil quota, in order), payloads and props
        re-intern into this store's tables and the doc's client map moves
        over whole. Goes through a snapshot → restore round trip and
        returns the NEW store."""
        live = live_slots(tmp.state)
        n = len(live["seq"])
        S = self.capacity_per_shard
        if n > self.n_shards * S:
            raise ValueError(
                f"rebuilt doc needs {n} slots > mega capacity "
                f"{self.n_shards}×{S}; graduate it instead")
        # intern into this store's tables first; the snapshot takes them
        live["handle_op"] = self.remap_payload_handles(tmp,
                                                       live["handle_op"])
        prop = np.zeros((self.n_shards * S, self.n_props), np.int32)
        if tmp._has_props:
            self._has_props = True
            self.remap_props(tmp, live["prop_val"], prop)
        self._client_idx[row] = dict(tmp._client_idx[0])
        snap = self.snapshot()

        quota = -(-n // self.n_shards)
        counts = np.zeros(self.n_shards, np.int32)
        for k in PLANES:
            fill = NOT_REMOVED if k == "removed_seq" else 0
            rowvals = np.full(self.n_shards * S, fill, np.int32)
            for s in range(self.n_shards):
                chunk = live[k][s * quota:(s + 1) * quota]
                rowvals[s * S:s * S + len(chunk)] = chunk
                counts[s] = len(chunk)
            snap["planes"][k][row] = rowvals
        pv = snap["planes"]["prop_val"]
        pv[row] = 0
        for s in range(self.n_shards):
            chunk = prop[s * quota:(s + 1) * quota]
            pv[row, s * S:s * S + len(chunk), :chunk.shape[1]] = chunk
        snap["count"][row] = counts
        snap["overflow"][row] = 0
        return MegaDocStringStore.restore(snap, device=self.device)

    def overflowed(self) -> np.ndarray:
        """(D, n_shards) sticky overflow flags."""
        return self.state.overflow.cpu().numpy()

    def digests(self) -> np.ndarray:
        return megadoc_digest(self.state).cpu().numpy()

    def slot_usage(self) -> np.ndarray:
        """(D, n_shards) active slot counts."""
        return self.state.count.cpu().numpy()

    # ----------------------------------------------------- snapshot / resume

    def snapshot(self) -> dict:
        """The planes (full width) and the interner tables as host data,
        in the JAX store's snapshot format (``MegaDocStringStore.restore``
        of either package loads it)."""
        st = self.state
        return {
            "planes": {k: getattr(st, k).cpu().numpy().copy()
                       for k in self.SNAP_PLANES},
            "count": st.count.cpu().numpy().copy(),
            "overflow": st.overflow.cpu().numpy().copy(),
            "capacity_per_shard": self.capacity_per_shard,
            "n_shards": self.n_shards,
            "rebalance_headroom": self.rebalance_headroom,
            "payloads": list(self._payloads),
            "client_idx": [dict(m) for m in self._client_idx],
            "prop_planes": dict(self._prop_planes),
            "prop_values": self._prop_values.export(),
            "has_props": self._has_props,
        }

    @classmethod
    def restore(cls, snap: dict, device="cuda",
                mesh=None) -> "MegaDocStringStore":
        """Rebuild from a ``snapshot()`` of this store or of the JAX one
        (numpy planes plus interner tables, ``n_shards`` from the
        snapshot). On the card a layout K7 does not take is refused."""
        refuse_mesh(mesh)
        n_docs, n_shards = np.asarray(snap["count"]).shape
        if n_shards != snap["n_shards"]:
            raise ValueError(f"snapshot of {snap['n_shards']} shards holds "
                             f"counts for {n_shards}")
        n_props = np.asarray(snap["planes"]["prop_val"]).shape[2]
        store = cls.__new__(cls)
        store.device = resolve_device(device)
        _check_layout(store.device, n_shards, snap["capacity_per_shard"],
                      n_props)
        store.n_docs = n_docs
        store.n_shards = n_shards
        store.capacity_per_shard = snap["capacity_per_shard"]
        store.rebalance_headroom = snap["rebalance_headroom"]
        store._init_interner(n_docs, n_props)
        store._version = 0
        store._runs_cache = None
        store._runs_version = -1
        arrays = dict(snap["planes"], count=snap["count"],
                      overflow=snap["overflow"])
        # copies: the state is updated in place and must not write
        # through to the snapshot's arrays
        store.state = StringState(**{
            k: torch.as_tensor(np.asarray(v, np.int32)).to(store.device,
                                                            copy=True)
            for k, v in arrays.items()})
        store._payloads = [tuple(p) for p in snap["payloads"]]
        store._client_idx = [dict(m) for m in snap["client_idx"]]
        store._prop_planes = dict(snap["prop_planes"])
        store._prop_values = ValueInterner.restore(snap["prop_values"])
        store._has_props = bool(snap["has_props"])
        return store
