"""The replica serving engines: sequencer + partitioned log + batched device
merge, for many SharedString documents (``StringServingEngine``), SharedMap
documents (``MapServingEngine``), SharedMatrix documents
(``MatrixServingEngine``) or SharedTree documents (``TreeServingEngine``).

Reference counterpart: the Routerlicious pipeline around the op-merge hot
path — Alfred ingress → Deli sequencing → Kafka → broadcast — with the
merge itself done by the batched device kernel, so the service *is* the
replica: raw client ops are stamped by Deli, appended to the
``PartitionedLog`` (the Kafka role), queued into a batch window, and merged
for every resident document at once by ``TensorStringStore``. The sequenced
message returned from ``submit`` is the broadcast/ack.

Two ingest routes: the per-op ``submit`` (→ ``flush`` →
``TensorStringStore.apply_messages``) and the columnar ``ingest_planes``,
a serial walk of four stage methods (prepare → sequence → dispatch → log)
that ``server.ingest_pipeline.PipelinedIngestExecutor`` also runs from its
worker threads.

Three tiers: the flat store (one row per doc, capacity S), the mega tier
(documents declared long with ``mark_mega``, each split into shards of a
``MegaDocStringStore``) and the graduated tier (a doc whose compacted state
outgrew its tier gets a store of its own). A doc whose row overflows (the
kernel drops the op and sets a sticky flag) is healed by
``recover_overflowed``: its whole history is replayed from the log into a
rebuild store at doubled capacity, compacted at the doc's window floor,
then re-uploaded into its row or graduated. Every store recovery builds
sits on the engine's device.

Recovery of the whole engine is one primitive: ``summarize`` (full, or an
incremental delta over the last summary) captures the compacted stores,
the sequencer checkpoint, the log offsets and the dedup ledger; ``load``
restores them and replays the log tail through the same apply path.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..ops import string_kernel
from ..ops.axis_kernel import TensorAxisStore
from ..ops.map_kernel import TensorMapStore
from ..ops.megadoc_kernel import MegaCapacityError
from ..ops.megadoc_store import MegaDocStringStore
from ..ops.matrix_kernel import (
    ShardedMatrixStore, TensorMatrixStore, tuple_key,
)
from ..ops.schema import OpKind, positions_in_doc
from ..ops.string_store import TensorStringStore
from ..ops import tree_apply
from ..ops.tree_kernel import TreeOpKind
from ..ops.tree_store import ANON_BASE, TensorTreeStore
from ..utils.telemetry import REGISTRY
from .deli import DeliSequencer, Nack, NackReason
from .oplog import OplogCorruptionError, PartitionedLog, partition_of
from .tree_wire import decode_records, encode_leaf_records, encode_tree_batch


class DedupLedger:
    """Per ``(doc, client)`` the recent ``clientSeq → seq`` acks, recorded
    only after the op's log append: a resubmitted op whose ack was lost is
    re-acked with its original seq instead of nacked. ``last()`` is the
    highest clientSeq durably accepted (a reconnecting client's resync
    cursor). Bounded per key; snapshots ride the engine summary."""

    def __init__(self, window: int = 512):
        self.window = window
        self._led: Dict[Tuple[str, int], "collections.OrderedDict"] = {}
        self._last: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()

    def _record(self, doc_id: str, client_id: int, client_seq: int,
                seq: int) -> None:
        key = (doc_id, int(client_id))
        led = self._led.get(key)
        if led is None:
            led = self._led[key] = collections.OrderedDict()
        led[int(client_seq)] = int(seq)
        while len(led) > self.window:
            led.popitem(last=False)
        if client_seq > self._last.get(key, 0):
            self._last[key] = int(client_seq)

    def record(self, doc_id: str, client_id: int, client_seq: int,
               seq: int) -> None:
        with self._lock:
            self._record(doc_id, client_id, client_seq, seq)

    def record_many(self, items) -> None:
        """Record ``(doc, client, client_seq, seq)`` tuples under one lock
        acquisition (a whole ack window)."""
        with self._lock:
            for item in items:
                self._record(*item)

    def lookup(self, doc_id: str, client_id: int,
               client_seq: int) -> Optional[int]:
        with self._lock:
            led = self._led.get((doc_id, int(client_id)))
            return None if led is None else led.get(int(client_seq))

    def last(self, doc_id: str, client_id: int) -> int:
        with self._lock:
            return self._last.get((doc_id, int(client_id)), 0)

    def snapshot(self, docs=None) -> dict:
        """Full snapshot, or (``docs`` given) only those docs' entries: the
        slice an incremental summary carries."""
        out: Dict[str, Dict[str, dict]] = {}
        with self._lock:
            for (doc, cid), led in self._led.items():
                if docs is not None and doc not in docs:
                    continue
                out.setdefault(doc, {})[str(cid)] = {
                    "last": self._last.get((doc, cid), 0),
                    "acked": [[cs, sq] for cs, sq in led.items()]}
        return out

    def merge(self, partial: Optional[dict]) -> None:
        """Overlay a delta summary's slice: each ``(doc, client)`` entry
        replaces the ledger's (it is that key's whole current window)."""
        for doc, clients in (partial or {}).items():
            for cid, ent in clients.items():
                key = (doc, int(cid))
                with self._lock:
                    self._last[key] = max(self._last.get(key, 0),
                                          int(ent.get("last", 0)))
                    self._led[key] = collections.OrderedDict(
                        (int(cs), int(sq)) for cs, sq in ent.get("acked", []))

    @classmethod
    def load(cls, snapshot: Optional[dict],
             window: int = 512) -> "DedupLedger":
        self = cls(window=window)
        for doc, clients in (snapshot or {}).items():
            for cid, ent in clients.items():
                key = (doc, int(cid))
                self._last[key] = int(ent.get("last", 0))
                self._led[key] = collections.OrderedDict(
                    (int(cs), int(sq)) for cs, sq in ent.get("acked", []))
        return self


def make_sequencer(kind: str = "python", clock=None):
    """"python" = the reference-semantics DeliSequencer; "native" = the C++
    sequencer behind the same surface (raises when it cannot be built)."""
    if kind == "native":
        from .native_deli import NativeDeliAdapter
        return NativeDeliAdapter(clock=clock)
    if kind != "python":
        raise ValueError(f"unknown sequencer {kind!r}")
    return DeliSequencer(clock=clock)


def restore_sequencer(snapshot: dict, clock=None):
    """Checkpoint-format dispatch: native blobs (``{"native": ...}``)
    restore into the native sequencer, dicts into the Python one."""
    if "native" in snapshot:
        from .native_deli import NativeDeliAdapter
        return NativeDeliAdapter.restore(snapshot, clock=clock)
    return DeliSequencer.restore(snapshot, clock=clock)


@dataclasses.dataclass
class ColumnarOps:
    """A columnar run of sequenced ops in the log — ONE record per ingest
    batch (or per partition when some string ops were nacked) instead of
    one object per op. ``family`` names the op dialect ``expand`` rebuilds:
    "str" (merge-tree ops; payloads are the broadcast ``text``, or per-op
    ``texts`` + ``tidx``, and annotate slots index the single-key ``props``
    table through ``tidx``), "map" (set/delete/clear: ``a0`` indexes the
    ``keys`` table, ``a1`` the ``values`` table) or "ops" (generic op dicts:
    ``a0`` indexes the ``values`` table, which holds each op's contents)."""

    doc_ids: List[str]          # row-local doc-id table
    doc: np.ndarray             # (N,) index into doc_ids
    client: np.ndarray          # (N,)
    client_seq: np.ndarray      # (N,)
    ref_seq: np.ndarray         # (N,)
    seq: np.ndarray             # (N,)
    min_seq: np.ndarray         # (N,)
    kind: np.ndarray            # (N,) OpKind
    a0: np.ndarray              # (N,) str: pos / start; map: key index
    a1: np.ndarray              # (N,) str: len / end; map: value index
    text: str                   # broadcast insert payload
    timestamp: float = 0.0
    texts: Optional[List[str]] = None
    props: Optional[List[dict]] = None
    tidx: Optional[np.ndarray] = None
    family: str = "str"
    keys: Optional[List[str]] = None
    values: Optional[list] = None

    def expand(self, only_doc: Optional[str] = None
               ) -> List[SequencedDocumentMessage]:
        """The per-op message stream this record stands for, or only the
        slice of ``only_doc``."""
        if only_doc is None:
            return self.messages(range(len(self.seq)))
        if only_doc not in self.doc_ids:
            return []
        return self.messages(np.flatnonzero(
            np.asarray(self.doc) == self.doc_ids.index(only_doc)))

    def messages(self, idxs) -> List[SequencedDocumentMessage]:
        """Messages of the slots ``idxs``, in that order."""
        idxs = np.asarray(idxs, np.int64)
        cols = [np.asarray(f)[idxs].tolist() for f in (
            self.doc, self.client, self.client_seq, self.ref_seq, self.seq,
            self.min_seq, self.kind, self.a0, self.a1)]
        cols.append([0] * len(idxs) if self.tidx is None
                    else np.asarray(self.tidx)[idxs].tolist())
        out = []
        for doc, cl, cs, rs, sq, ms, k, a0, a1, ti in zip(*cols):
            if self.family == "ops":
                # generic op-dict batch: contents ride the values table
                contents = self.values[a0]
            elif self.family == "map":
                if k == OpKind.MAP_CLEAR:
                    contents = {"op": "clear"}
                elif k == OpKind.MAP_DELETE:
                    contents = {"op": "delete", "key": self.keys[a0]}
                else:
                    contents = {"op": "set", "key": self.keys[a0],
                                "value": self.values[a1]}
            elif k == OpKind.STR_INSERT:
                text = self.text if self.texts is None else self.texts[ti]
                contents = {"mt": "insert", "kind": 0, "pos": a0,
                            "text": text, "clientSeq": cs}
            elif k == OpKind.STR_ANNOTATE:
                contents = {"mt": "annotate", "start": a0, "end": a1,
                            "props": self.props[ti]}
            else:
                contents = {"mt": "remove", "start": a0, "end": a1}
            out.append(SequencedDocumentMessage(
                doc_id=self.doc_ids[doc], client_id=cl, client_seq=cs,
                ref_seq=rs, seq=sq, min_seq=ms, type=MessageType.OP,
                contents=contents, timestamp=self.timestamp))
        return out


class ServingEngineBase:
    """The DDS-agnostic half of a serving engine: Deli sequencing, the
    partitioned log, doc-row membership, window-floor tracking and the
    batch window, and the summary half of recovery (sequencer checkpoint,
    log offsets, dedup ledger and member set; tail replay). Subclasses own
    the device store."""

    def __init__(self, n_docs: int, batch_window: int = 64,
                 n_partitions: int = 8, compact_every: int = 16,
                 log: Optional[PartitionedLog] = None,
                 sequencer: str = "python"):
        self.deli = make_sequencer(sequencer)
        self.log = log if log is not None else PartitionedLog(n_partitions)
        # the epoch this engine stamps on its appends: the log's CURRENT
        # fence word. Constructing or loading an engine never bumps the
        # fence (a reader must not depose the writer); takeover goes
        # through acquire_write_authority()
        self.writer_epoch: int = self.log.fence_epoch
        self.deli.epoch = self.writer_epoch
        self.n_docs = n_docs
        self.batch_window = batch_window
        self.compact_every = compact_every
        self._doc_rows: Dict[str, int] = {}
        # row allocator: rows freed by graduated docs are reused first
        self._free_rows: List[int] = []
        self._next_row = 0
        self._queue: List[Tuple[int, SequencedDocumentMessage]] = []
        self._flushes_since_compact = 0
        self._min_seq: Dict[str, int] = {}
        # durable dedup and the member set: persisted in summaries and
        # rebuilt by the tail replay (a rejoin resets the native
        # sequencer's dedup window, so a resuming client must not rejoin)
        self._dedup = DedupLedger()
        self._members: Set[Tuple[str, int]] = set()
        self._dup_acked_last = 0
        # set by the log stage when a pipelined wave's deferred flag read
        # shows an overflow; the executor's drain recovers
        self._ov_recover_due = False
        # incremental summaries: the last summary and its dirty-detection
        # baselines; docs whose device state was rewritten outside the op
        # stream (re-upload), which a doc-seq comparison would miss; the
        # delta chain's depth bound (past it a summary is full)
        self._summ_bookkeeping: Optional[dict] = None
        self._dirty_outside_ops: Set[str] = set()
        self.max_incremental_chain = 8
        self._chain_depth = 0
        # set while the device state may be AHEAD of the log (a wave was
        # sequenced but its append has not committed); counter-backed
        # because the pipelined executor keeps several waves in flight
        self._poisoned: Optional[str] = None
        self._poison_lock = threading.Lock()
        self._seq_unlogged = 0
        # doc id / native sequencer handle / log partition by row
        self._row_doc_id: List[Optional[str]] = [None] * n_docs
        self._row_handle = np.full(n_docs, -1, np.int32)
        self._row_part = np.zeros(n_docs, np.int32)
        # round-robin partition cursor for whole-batch columnar records
        self._col_part = 0
        # the read plane (``server/read_plane.py``): attach_read_plane()
        # hangs a pump here, and every flush or columnar wave that applied
        # ops pumps one encoded observer window
        self._read_plane = None

    def _check_poisoned(self) -> None:
        if self._poisoned:
            raise RuntimeError(
                f"engine poisoned ({self._poisoned}): device state may be "
                "ahead of the log")

    # ------------------------------------------------------------ membership

    def doc_row(self, doc_id: str) -> int:
        row = self._doc_rows.get(doc_id)
        if row is None:
            if self._free_rows:
                row = self._free_rows.pop()
            elif self._next_row < self.n_docs:
                row = self._next_row
                self._next_row += 1
            else:
                raise KeyError(f"document capacity {self.n_docs} exhausted")
            self._doc_rows[doc_id] = row
            self._note_row(doc_id, row)
        return row

    def _note_row(self, doc_id: str, row: int) -> None:
        self._row_doc_id[row] = doc_id
        self._row_part[row] = partition_of(doc_id, self.log.n_partitions)

    def _fill_row_handles(self, rows: np.ndarray, raw) -> None:
        if (self._row_handle[rows] < 0).any():
            for r in rows:
                if self._row_handle[r] < 0:
                    if self._row_doc_id[r] is None:
                        raise KeyError(
                            f"row {int(r)} has no document (allocate via "
                            "doc_row before columnar ingest)")
                    self._row_handle[r] = raw.doc_handle(self._row_doc_id[r])

    def connect(self, doc_id: str, client_id: int
                ) -> SequencedDocumentMessage:
        msg = self.deli.client_join(doc_id, client_id)
        self._log_append(doc_id, msg)
        self._members.add((doc_id, int(client_id)))
        return msg

    def disconnect(self, doc_id: str, client_id: int
                   ) -> Optional[SequencedDocumentMessage]:
        msg = self.deli.client_leave(doc_id, client_id)
        if msg is not None:
            self._log_append(doc_id, msg)
        self._members.discard((doc_id, int(client_id)))
        return msg

    def is_member(self, doc_id: str, client_id: int) -> bool:
        """Whether this identity already holds a seat. A resuming client
        must NOT re-join: ``client_join`` resets the sequencer's dedup
        window, re-opening it to already-sequenced resubmits."""
        return (doc_id, int(client_id)) in self._members

    def last_client_seq(self, doc_id: str, client_id: int) -> int:
        """Resync cursor: the highest clientSeq durably accepted from this
        identity (the dedup ledger's view; the native sequencer does not
        expose its live counter)."""
        return self._dedup.last(doc_id, client_id)

    def note_acked_planes(self, docs, clients, client_seqs, seqs) -> None:
        """Ledger one acked columnar wave (the ack path's hook, after the
        log append): ``docs`` holds the wave's doc ids, one per plane row
        (ids, not rows: a recovery inside the wave may have released a
        row), the rest are its (R, O) planes and ``ingest_planes``'s
        ``seq``. Entries with ``seq <= 0`` are nacks, never recorded."""
        seqs = np.asarray(seqs)
        ok = seqs > 0
        self._dedup.record_many(zip(
            np.broadcast_to(np.asarray(docs, object)[:, None],
                            seqs.shape)[ok].tolist(),
            np.asarray(clients)[ok].tolist(),
            np.asarray(client_seqs)[ok].tolist(), seqs[ok].tolist()))

    # ------------------------------------------ shared columnar protocol

    def _sequence_columnar(self, raw, handles, client, client_seq,
                           ref_seq, doc_of=None):
        """One native sequencing call, then POISON the engine until the
        batch's log record is appended. Returns (out_seq, out_min, nacked
        mask, n_ok). With ``doc_of`` (a flat slot → its doc id),
        DUPLICATE-nacked slots found in the dedup ledger get their ORIGINAL
        seq patched into ``out_seq`` (so the ack fan re-acks them) while
        staying in the ``nacked`` mask (never re-applied or re-logged)."""
        out_seq, out_min = raw.sequence_batch_rows(
            handles, client, client_seq, ref_seq)
        with self._poison_lock:
            self._seq_unlogged += 1
            self._poisoned = "columnar batch failed after sequencing"
        nacked = out_seq < 0
        n_ok = int((~nacked).sum())
        n_dup = 0
        if doc_of is not None and nacked.any():
            # -3 = the native DUPLICATE nack code
            for i in np.flatnonzero(out_seq == -3):
                orig = self._dedup.lookup(doc_of(int(i)), int(client[i]),
                                          int(client_seq[i]))
                if orig is not None:
                    out_seq[i] = orig
                    n_dup += 1
        self._dup_acked_last = n_dup
        return out_seq, out_min, nacked, n_ok

    @staticmethod
    def _clamped_ref(ref_flat: np.ndarray, out_seq: np.ndarray):
        """The logged ref_seq is the CLAMPED one (min(ref, seq-1), what the
        sequencer recorded)."""
        return np.minimum(ref_flat.astype(np.int64),
                          np.maximum(out_seq - 1, 0))

    def _fenced_append(self, partition: int, record: Any) -> int:
        """Every append of the engine: stamped with its writer epoch, so a
        deposed engine (the fence bumped by another engine's
        ``acquire_write_authority``, in this process or another on the
        same directory) gets ``FencedWriterError`` here instead of
        interleaving seqs into a stream it no longer owns."""
        return self.log.append(partition, record, epoch=self.writer_epoch)

    def acquire_write_authority(self) -> int:
        """Takeover edge: bump the log's fence and adopt the new epoch;
        every other live engine on this log becomes a fenced zombie."""
        self.writer_epoch = self.log.bump_fence()
        self.deli.epoch = self.writer_epoch
        return self.writer_epoch

    def _append_columnar(self, record: ColumnarOps) -> None:
        """Whole-batch append (round-robin partition) + poison clear."""
        p = self._col_part
        self._col_part = (p + 1) % self.log.n_partitions
        self._fenced_append(p, record)
        self._ingest_mark_logged()

    def _ingest_mark_logged(self) -> None:
        """One sequenced wave's append committed: poison clears only when
        no older sequenced-but-unlogged wave remains."""
        with self._poison_lock:
            if self._seq_unlogged > 0:
                self._seq_unlogged -= 1
            if self._seq_unlogged == 0:
                self._poisoned = None

    def _ingest_inflight(self) -> int:
        with self._poison_lock:
            return self._seq_unlogged

    # --------------------------------------------------------------- ingress

    def submit(self, doc_id: str, client_id: int, client_seq: int,
               ref_seq: int, contents: Any
               ) -> Tuple[Optional[SequencedDocumentMessage], Optional[Nack]]:
        """Ingest one raw op. Returns (sequenced message, None) — the
        broadcast/ack — or (None, nack). Malformed contents and capacity
        overflows are nacked BEFORE sequencing and logging."""
        self._check_poisoned()
        if not self._valid_op(contents):
            return None, Nack(doc_id, client_id, client_seq,
                              NackReason.MALFORMED)
        try:
            self._admit(doc_id, contents, client_id)
        except KeyError:
            return None, Nack(doc_id, client_id, client_seq,
                              NackReason.CAPACITY)
        msg, nack = self.deli.sequence(
            doc_id, client_id, client_seq, ref_seq, MessageType.OP, contents)
        if nack is not None:
            self._unadmit()
            if nack.reason == NackReason.DUPLICATE:
                orig = self._dedup.lookup(doc_id, client_id, client_seq)
                if orig is not None:
                    nack.seq = orig  # idempotent dup-ack
            return None, nack
        self._log_append(doc_id, msg)
        self._dedup.record(doc_id, client_id, client_seq, msg.seq)
        self._enqueue(doc_id, msg)
        self._min_seq[doc_id] = msg.min_seq
        if self._queued() >= self.batch_window:
            self.flush()
        return msg, None

    def _enqueue(self, doc_id: str, msg: SequencedDocumentMessage) -> None:
        self._queue.append((self.doc_row(doc_id), msg))

    def _queued(self) -> int:
        return len(self._queue)

    def _valid_op(self, contents: Any) -> bool:
        return True

    @staticmethod
    def _is_nat(v, lo: int = 0) -> bool:
        return isinstance(v, int) and not isinstance(v, bool) and v >= lo

    def _admit(self, doc_id: str, contents: Any,
               client_id: int = -1) -> None:
        """Reserve the capacity the op will need at flush; KeyError → the
        op is nacked before it is logged."""
        self.doc_row(doc_id)

    def _unadmit(self) -> None:
        """Undo ``_admit`` when the sequencer nacks after admission."""

    def _log_append(self, doc_id: str, msg: SequencedDocumentMessage) -> None:
        self._fenced_append(partition_of(doc_id, self.log.n_partitions), msg)

    def flush(self) -> int:
        """Apply the queued window on the device; drives the compaction
        cadence, then pumps the attached read plane. Returns the number of
        messages applied."""
        n = self._flush_impl()
        if n:
            self._flushes_since_compact += 1
            if self._flushes_since_compact >= self.compact_every:
                self.compact()
            plane = self._read_plane
            if plane is not None:
                plane.pump()
        return n

    def attach_read_plane(self, plane) -> None:
        """Hang a ``read_plane.ReadPlane`` on this engine: every flush
        (and every string columnar wave) that applied ops pumps one
        encoded observer window. ``attach_read_plane(None)`` detaches."""
        self._read_plane = plane

    def _flush_impl(self) -> int:
        raise NotImplementedError

    def compact(self) -> None:
        self._flushes_since_compact = 0

    # ------------------------------------------------ incremental summaries
    # A row is dirty when its doc sequenced an op since the last summary
    # (host-side, no device read), when its doc↔row mapping changed
    # (graduation, row reuse), or when its device state was rewritten
    # outside the op stream (``_dirty_outside_ops``).

    def _incremental_ok(self, incremental: bool) -> bool:
        return (incremental and self._summ_bookkeeping is not None
                and self._chain_depth < self.max_incremental_chain)

    def _dirty_rows_since(self, prev: dict):
        """(dirty row set, current doc seqs) against the last summary."""
        cur_seqs = {d: self.deli.doc_seq(d) for d in self._doc_rows}
        dirty = {row for d, row in self._doc_rows.items()
                 if cur_seqs[d] != prev["doc_seqs"].get(d)}
        dirty |= {row for d, row in prev["row_of"].items()
                  if self._doc_rows.get(d) != row}
        dirty |= {self._doc_rows[d] for d in self._dirty_outside_ops
                  if d in self._doc_rows}
        return dirty, cur_seqs

    def _note_summary(self, summary: dict, cur_seqs: dict,
                      **extra) -> None:
        self._dirty_outside_ops.clear()
        self._summ_bookkeeping = {
            "summary": summary, "doc_seqs": cur_seqs,
            "row_of": dict(self._doc_rows),
            "members": frozenset(self._members), **extra}

    def _mark_delta(self, summary: dict, prev: dict,
                    cur_seqs: dict) -> None:
        """Stamp a ``_base_summary()`` as a delta over ``prev``: the dedup
        ledger rides only for docs that sequenced an op since the base, the
        member set as a join/leave diff."""
        summary["kind"] = "delta"
        summary["base"] = prev["summary"]
        changed = {d for d, s in cur_seqs.items()
                   if s != prev["doc_seqs"].get(d)}
        summary["dedup"] = self._dedup.snapshot(docs=changed)
        cur = frozenset(self._members)
        base_members = prev.get("members", frozenset())
        del summary["members"]
        summary["members_delta"] = {
            "join": sorted([d, c] for d, c in cur - base_members),
            "leave": sorted([d, c] for d, c in base_members - cur)}

    @staticmethod
    def resolve_summary_chain(summary: dict):
        """(newest full summary, deltas oldest→newest) of an incremental
        chain (a full summary resolves to itself)."""
        chain: List[dict] = []
        full = summary
        while full.get("kind") == "delta":
            chain.append(full)
            full = full["base"]
        return full, chain[::-1]

    # ----------------------------------------------------- summary / recovery
    # Subclasses' summarize() merges _base_summary() with their store
    # snapshots; their load() calls _restore_base() then _replay_tail().

    def _base_summary(self) -> dict:
        self._check_poisoned()
        sizes = [self.log.size(p) for p in range(self.log.n_partitions)]
        return {
            "deli": self.deli.checkpoint(),
            "log_offsets": sizes,
            # the chain word at each partition's summary offset: a load
            # checks that the log still carries these exact bytes before
            # it replays the tail. None on a memory-only log (no chain)
            "chain_heads": [self.log.chain_at(p, s)
                            for p, s in enumerate(sizes)],
            "doc_rows": dict(self._doc_rows),
            "min_seq": dict(self._min_seq),
            "dedup": self._dedup.snapshot(),
            "members": [[d, c] for d, c in sorted(self._members)],
        }

    def _restore_base(self, summary: dict) -> None:
        # keep this engine's clock (a test may have injected one)
        self.deli = restore_sequencer(summary["deli"], clock=self.deli.clock)
        self.deli.epoch = self.writer_epoch
        self._doc_rows = dict(summary["doc_rows"])
        used = set(self._doc_rows.values())
        self._next_row = max(used) + 1 if used else 0
        self._free_rows = [r for r in range(self._next_row) if r not in used]
        for d, row in self._doc_rows.items():
            self._note_row(d, row)
        self._min_seq = dict(summary["min_seq"])
        # the chain carries the whole ledger and roster only in its full
        # base, then an O(changed) slice per delta: resolve oldest→newest
        full, deltas = self.resolve_summary_chain(summary)
        self._dedup = DedupLedger.load(full.get("dedup"))
        members = {(d, int(c)) for d, c in full.get("members") or []}
        for d_sum in deltas:
            self._dedup.merge(d_sum.get("dedup"))
            md = d_sum.get("members_delta") or {}
            members |= {(d, int(c)) for d, c in md.get("join", [])}
            members -= {(d, int(c)) for d, c in md.get("leave", [])}
        self._members = members

    def _verify_tail_anchor(self, summary: dict) -> None:
        """Anchor the tail replay against the summary's chain heads: the
        log must (a) still reach every partition's summary offset — a
        shorter log was truncated at a record boundary, which no scan of
        the file alone can see — and (b) carry the exact chain word the
        summary recorded there, so a spliced or regrown prefix fails
        before a single record is replayed. (b) is skipped for a
        partition whose head is None (the summary's log was memory-only)."""
        offsets = summary.get("log_offsets")
        if offsets is None:
            return
        heads = summary.get("chain_heads")
        for p in range(self.log.n_partitions):
            off = int(offsets[p])
            if self.log.size(p) < off:
                REGISTRY.inc("oplog_chain_verify_failures_total")
                raise OplogCorruptionError(
                    f"log p{p} holds {self.log.size(p)} records but the "
                    f"summary was cut at offset {off}: durable stream "
                    f"truncated behind the summary", index=off,
                    reason="log shorter than summary anchor")
            if heads is None or heads[p] is None:
                continue
            have = self.log.chain_at(p, off)
            if have != int(heads[p]):
                REGISTRY.inc("oplog_chain_verify_failures_total")
                raise OplogCorruptionError(
                    f"log p{p} chain word at offset {off} is "
                    f"{'absent' if have is None else hex(have)}, summary "
                    f"anchored {int(heads[p]):#010x}: log bytes diverged "
                    f"from the summarized history", index=off,
                    reason="chain anchor mismatch")

    def _replay_tail(self, summary: dict, control_hook=None) -> None:
        """Replay every tail message through the sequencer (so sequencing
        resumes past the tail), the member set and the dedup ledger; OPs
        queue for the device merge. A ``control_hook(msg) -> True``
        consumes an engine's own control records (the string engine's
        ``markMega``) before they reach the stores. Columnar records of
        any family ("str", "map" or "ops") expand to their per-op
        messages, which the engine's own ``_flush_impl`` applies. The tail is sorted by (doc,
        seq): columnar records round-robin across partitions while
        JOIN/LEAVE stay in the doc's own partition, so the scan order is
        not the order of events."""
        self._verify_tail_anchor(summary)
        tail: List[SequencedDocumentMessage] = []
        for p in range(self.log.n_partitions):
            for rec in self.log.read(p,
                                     from_offset=summary["log_offsets"][p]):
                tail.extend(rec.expand() if hasattr(rec, "expand")
                            else (rec,))
        tail.sort(key=lambda m: (m.doc_id, m.seq))
        for msg in tail:
            self.deli.replay(msg)
            self._absorb_resilience(msg)
            if control_hook is not None and control_hook(msg):
                continue
            if msg.type == MessageType.OP:
                self._enqueue(msg.doc_id, msg)
                self._min_seq[msg.doc_id] = max(
                    self._min_seq.get(msg.doc_id, 0), msg.min_seq)
        self._queue.sort(key=lambda dm: dm[1].seq)

    def _absorb_resilience(self, msg: SequencedDocumentMessage) -> None:
        """Fold one replayed message into the member set and the dedup
        ledger: a rebuilt engine must refuse (and re-ack) the clientSeqs
        it accepted in its previous life."""
        if msg.type == MessageType.CLIENT_JOIN:
            self._members.add((msg.doc_id, int(msg.client_id)))
        elif msg.type == MessageType.CLIENT_LEAVE:
            self._members.discard((msg.doc_id, int(msg.client_id)))
        elif msg.type == MessageType.OP and msg.client_id >= 0:
            self._dedup.record(msg.doc_id, msg.client_id,
                               msg.client_seq, msg.seq)


class _IngestWave:
    """Per-wave carrier threaded through the four columnar-ingest stages."""
    __slots__ = (
        "rows", "R", "O", "kind", "a0", "a1", "client", "ref_seq", "text",
        "texts", "tidx", "props", "flat_client", "flat_client_seq",
        "flat_ref_seq", "handles", "prepacked", "pipelined", "out_seq",
        "out_min", "nacked", "n_ok", "kind_eff", "seq_rs", "seq_base",
        "min_rs", "compact_due", "ms_arr", "ov_prev", "dup_acked", "marks")

    def __init__(self):
        self.prepacked = None
        self.pipelined = False
        self.ov_prev = None
        # perf_counter() when each stage finished (pack1, seq1, disp1,
        # log1): the columnar front door's latency timeline reads them
        self.marks: dict = {}


def mega_rebuild_layouts(doc_id: str, n: int, S: int, grow_limit: int,
                         limits: Optional[Tuple[int, int]] = None):
    """The layouts (shards, slots a shard) a mega rebuild tries, each past
    the tier's (n, S) and the last: the capacity a shard doubles, then the
    shard count. ``limits`` (the card's: what K7 takes) caps the capacity
    a shard, then the shard count. MemoryError past ``grow_limit`` total
    slots, or past the widest layout within ``limits``."""
    while True:
        if limits is None:
            S *= 2
        elif S < limits[0]:
            S = min(2 * S, limits[0])
        elif n < limits[1]:
            n = min(2 * n, limits[1])
        else:
            raise MemoryError(
                f"{doc_id}: a mega rebuild past {n} shards × {S} slots is "
                "past what the megadoc_apply kernel takes on this card")
        if n * S > grow_limit:
            raise MemoryError(
                f"{doc_id}: rebuild exceeds grow limit {grow_limit}")
        yield n, S


def check_store_mesh(store, mesh) -> None:
    """An engine given both a store and a mesh needs the store sharded
    over that mesh (build it with ``mesh=`` or restore it with one)."""
    if store is not None and mesh is not None \
            and getattr(store, "mesh", None) is not mesh:
        raise ValueError("mesh given with a store that is not sharded over "
                         "it; build the store with mesh= or restore it with "
                         "mesh=")


class StringServingEngine(ServingEngineBase):
    """Sequencer + log + batched device merge for many documents, on
    ``device`` (default the card; ``device="cpu"`` runs the plain
    versions). ``store`` adopts an existing flat store (``load``).

    ``mega_docs`` > 0 gives the engine a mega tier: a
    ``MegaDocStringStore`` of that many documents, 8 shards of
    ``mega_capacity_per_shard`` slots each (or the caller's own
    ``mega_store``), on the flat store's device. ``mark_mega`` routes a
    document there before its first op.

    ``mesh`` (a 1-D ``docs`` mesh, ``parallel.sharded.make_doc_mesh``)
    shards the flat store's planes by doc row over its devices; each wave
    launches the apply once a shard. The mega tier refuses a mesh (K7
    holds a doc inside one card's cluster: ROADMAP B9)."""

    def __init__(self, n_docs: int, capacity: int = 256, n_props: int = 4,
                 batch_window: int = 64, n_partitions: int = 8,
                 compact_every: int = 16,
                 log: Optional[PartitionedLog] = None,
                 sequencer: str = "python", device="cuda",
                 store: Optional[TensorStringStore] = None,
                 mega_docs: int = 0, mega_capacity_per_shard: int = 256,
                 mega_store: Optional[MegaDocStringStore] = None,
                 mesh=None):
        check_store_mesh(store, mesh)
        if mesh is not None and (mega_docs > 0 or mega_store is not None):
            raise ValueError("the mega tier does not shard over a mesh "
                             "(K7 holds a doc inside one card's cluster): "
                             "ROADMAP B9")
        self.store = store if store is not None \
            else TensorStringStore(n_docs, capacity, n_props, device, mesh)
        self.mesh = self.store.mesh
        self.mega_store = mega_store
        if mega_store is None and mega_docs > 0:
            self.mega_store = MegaDocStringStore(
                mega_docs, mega_capacity_per_shard, device=self.store.device)
        super().__init__(n_docs, batch_window, n_partitions, compact_every,
                         log, sequencer=sequencer)
        # mega tier: doc → mega row, rows freed by graduation, the queue
        self._mega_rows: Dict[str, int] = {}
        self._free_mega_rows: List[int] = []
        self._mega_queue: List[Tuple[int, SequencedDocumentMessage]] = []
        # in-flight async copy of the overflow flags (deferred read)
        self._ov_pending = None
        self._admit_token = None
        # graduated tier: docs whose compacted state outgrew the flat
        # capacity, each served from a store of its own (row 0)
        self._graduated: Dict[str, TensorStringStore] = {}
        self._grad_queue: List[Tuple[str, SequencedDocumentMessage]] = []
        #: overflow flags are read and recovery runs on the compaction
        #: cadence
        self.auto_recover = True
        #: time split and shapes of the last flat-tier recovery
        self.last_recovery: dict = {}
        #: layout and history size of the last mega rebuild
        self.last_mega_rebuild: dict = {}

    # ------------------------------------------------------------ membership

    def doc_row(self, doc_id: str) -> int:
        """The doc's row in its tier's store (a mega row for a mega doc);
        allocates a flat row for a doc that has none yet."""
        if doc_id in self._mega_rows:
            return self._mega_rows[doc_id]
        return super().doc_row(doc_id)

    def mark_mega(self, doc_id: str) -> None:
        """Route ``doc_id`` to the mega tier; before its first op (a JOIN
        does not pin a doc to the flat tier). The mark is appended to the
        log, so a load replays it before the doc's ops."""
        if self.mega_store is None:
            raise ValueError("engine created without a mega tier")
        if doc_id in self._doc_rows:
            raise ValueError(f"{doc_id} already has ops on the flat tier")
        if doc_id not in self._mega_rows:
            self._register_mega(doc_id)
            self._log_append(doc_id, SequencedDocumentMessage(
                doc_id=doc_id, client_id=-1, client_seq=0, ref_seq=0,
                seq=0, min_seq=0, type=MessageType.PROPOSAL,
                contents={"markMega": True}))

    def _register_mega(self, doc_id: str) -> None:
        if self._free_mega_rows:
            self._mega_rows[doc_id] = self._free_mega_rows.pop()
            return
        nxt = len(self._mega_rows) + len(self._free_mega_rows)
        if nxt >= self.mega_store.n_docs:
            raise KeyError("mega-doc capacity exhausted")
        self._mega_rows[doc_id] = nxt

    def _mega_min_seq(self) -> np.ndarray:
        """(mega docs,) window floors of the mega rows (0 where free)."""
        ms = np.zeros((self.mega_store.n_docs,), np.int32)
        for doc_id, row in self._mega_rows.items():
            ms[row] = self._min_seq.get(doc_id, 0)
        return ms

    # --------------------------------------------------------------- ingress

    @classmethod
    def _valid_props(cls, props, required: bool) -> bool:
        if props is None:
            return not required
        if not (isinstance(props, dict) and
                all(isinstance(k, str) for k in props)):
            return False
        if required and not props:
            return False
        try:  # flush JSON-interns values: reject unserialisable now
            json.dumps(props)
        except (TypeError, ValueError):
            return False
        return True

    def _valid_op(self, contents: Any) -> bool:
        """Full structural validation BEFORE sequencing/logging: a logged
        op the flush path cannot turn into device records would poison the
        engine."""
        if not isinstance(contents, dict):
            return False
        mt = contents.get("mt")
        if mt == "insert":
            kind = contents.get("kind")
            if not (self._is_nat(kind) and kind in (0, 1)
                    and self._is_nat(contents.get("pos"))):
                return False
            if contents["kind"] == 0 and \
                    not isinstance(contents.get("text"), str):
                return False
            return self._valid_props(contents.get("props"), required=False)
        if mt in ("remove", "annotate"):
            return (self._is_nat(contents.get("start"))
                    and self._is_nat(contents.get("end"))
                    and contents["start"] < contents["end"]
                    and (mt == "remove" or self._valid_props(
                        contents.get("props"), required=True)))
        return False

    def _admit(self, doc_id: str, contents: Any,
               client_id: int = -1) -> None:
        """Row + property-plane reservation (in the doc's own store once
        it graduated), refunded by ``_unadmit``."""
        if doc_id not in self._graduated:  # a graduated doc holds no row
            self.doc_row(doc_id)
        self._admit_token = None
        props = contents.get("props")
        if props:
            store, _ = self._store_of(doc_id)
            self._admit_token = (store, store.reserve_props(props))

    def _unadmit(self) -> None:
        if self._admit_token is not None:
            store, minted = self._admit_token
            store.release_props(minted)
        self._admit_token = None

    def _enqueue(self, doc_id: str, msg: SequencedDocumentMessage) -> None:
        if doc_id in self._graduated:
            self._grad_queue.append((doc_id, msg))
        elif doc_id in self._mega_rows:
            self._mega_queue.append((self._mega_rows[doc_id], msg))
        else:
            self._queue.append((self.doc_row(doc_id), msg))

    def _queued(self) -> int:
        return len(self._queue) + len(self._mega_queue) + \
            len(self._grad_queue)

    def heartbeat(self, doc_id: str, client_id: int, ref_seq: int) -> None:
        """NOOP: advances the client's refSeq (and the doc's MSN) so zamboni
        can reclaim tombstones; consumes no clientSeq."""
        msg, _ = self.deli.sequence(
            doc_id, client_id, 0, ref_seq, MessageType.NOOP, None)
        if msg is not None:
            self._min_seq[doc_id] = msg.min_seq
            # the op stream will not carry this floor advance: slide the
            # doc's interval anchors at the crossing now. Only a doc that
            # holds a row can hold intervals (a lookup through _store_of
            # would allocate a row and pin a heartbeat-only doc)
            if doc_id in self._doc_rows or doc_id in self._mega_rows \
                    or doc_id in self._graduated:
                store, row = self._store_of(doc_id)
                if getattr(store, "_intervals", None) \
                        and store._intervals[row]:
                    self.flush()
                    store.advance_min_seq(row, msg.min_seq)

    # ------------------------------------------------------- columnar ingest

    def ingest_planes(self, rows, client, client_seq, ref_seq, kind, a0, a1,
                      text: str = "", texts=None, tidx=None,
                      props=None) -> dict:
        """The high-throughput ingest path: a dense (R, O) columnar batch of
        RAW client string ops — sequenced in ONE native call, merged in ONE
        kernel launch, appended to the log as ``ColumnarOps``.

        rows: (R,) doc rows (allocate via ``doc_row``; clients must have
        joined via ``connect``). client/client_seq/ref_seq/kind/a0/a1:
        (R, O) int32 planes, each doc's ops in submission order. Removes use
        a0=start, a1=end. Payloads: the broadcast ``text`` or per-op
        ``texts`` + ``tidx``; single-key annotates need ``props``.

        Requires ``sequencer="native"``. Returns {"seq": (R, O) int64
        (negative = nack code), "nacked": int, "dup_acked": int, "marks":
        the perf_counter() end of each stage}."""
        self._check_poisoned()
        w = self._ingest_prepare(rows, client, client_seq, ref_seq, kind,
                                 a0, a1, text, texts, tidx, props)
        self._ingest_sequence(w)
        self._ingest_dispatch(w)
        return self._ingest_log(w)

    # Thread contract (pipelined executor): prepare runs on the pack
    # worker; sequence + dispatch run on one thread (they share the
    # sequencer and the compaction cursor); log runs on the log worker.

    def _ingest_prepare(self, rows, client, client_seq, ref_seq, kind,
                        a0, a1, text="", texts=None, tidx=None,
                        props=None, prepack=False) -> _IngestWave:
        """Stage 1 — validation, row handles, plane flattening and (when
        ``prepack``) the payload/table pack, all independent of sequencing."""
        raw = getattr(self.deli, "raw", None)
        if raw is None:
            raise RuntimeError("columnar ingest requires sequencer='native'")
        w = _IngestWave()
        rows = np.ascontiguousarray(rows, np.int32)
        R, O = kind.shape
        if len(rows) != R or len(np.unique(rows)) != R:
            raise ValueError("rows must be exactly one UNIQUE row per "
                             "plane row (duplicates would silently drop "
                             "ops in the device scatter)")
        if self._graduated and any(self._row_doc_id[r] in self._graduated
                                   for r in rows):
            raise ValueError("a targeted doc has graduated off the flat "
                             "tier; route its ops through submit()")
        kind = np.asarray(kind, np.int32)
        top = int(OpKind.STR_REMOVE)
        if props is not None:
            top = int(OpKind.STR_ANNOTATE)
            if any(len(p) != 1 for p in props):
                raise ValueError("columnar annotates are single-key; "
                                 "multi-key props go through submit()")
            # reserve planes/values BEFORE sequencing
            self.store.reserve_prop_tables(
                {k for p in props for k in p},
                [v for p in props for v in p.values()])
        if not bool(((kind >= int(OpKind.STR_INSERT))
                     & (kind <= top)).all()):
            raise ValueError("columnar planes must be dense insert/remove"
                             + ("/annotate" if props is not None else ""))
        # tidx is validated BEFORE sequencing: a bad index found later
        # would leave doc.seq ahead of the log
        if tidx is not None:
            tidx_arr = np.asarray(tidx, np.int32)
            if tidx_arr.shape != kind.shape:
                raise ValueError("tidx shape must match the op planes")
            if (tidx_arr < 0).any():
                raise ValueError("negative tidx in columnar batch")
            if texts is not None and int(np.max(
                    tidx_arr, initial=-1,
                    where=kind == int(OpKind.STR_INSERT))) >= len(texts):
                raise ValueError("insert tidx beyond the payload table")
            if props is not None and int(np.max(
                    tidx_arr, initial=-1,
                    where=kind == int(OpKind.STR_ANNOTATE))) >= len(props):
                raise ValueError("annotate tidx beyond the props table")
        elif texts is not None or props is not None:
            raise ValueError("payload/props tables require the tidx plane")

        self._fill_row_handles(rows, raw)
        w.rows, w.R, w.O = rows, R, O
        w.kind = kind
        w.a0 = np.ascontiguousarray(np.asarray(a0, np.int32))
        w.a1 = np.ascontiguousarray(np.asarray(a1, np.int32))
        w.client = np.ascontiguousarray(np.asarray(client, np.int32))
        w.ref_seq = np.ascontiguousarray(np.asarray(ref_seq, np.int32))
        w.text, w.texts, w.tidx, w.props = text, texts, tidx, props
        w.flat_client = w.client.reshape(-1)
        w.flat_client_seq = np.ascontiguousarray(
            np.asarray(client_seq, np.int32).reshape(-1))
        w.flat_ref_seq = w.ref_seq.reshape(-1)
        w.handles = np.repeat(self._row_handle[rows], O)
        if prepack:
            w.pipelined = True
            # None for a wave inserting on interval rows: the executor
            # holds the next pack and the dispatch stage packs inline
            w.prepacked = self.store.prepack_planes(
                rows, kind, w.a0, w.a1, text, texts, tidx, props)
        w.marks["pack1"] = time.perf_counter()
        return w

    def _ingest_sequence(self, w: _IngestWave) -> None:
        """Stage 2 — ONE native sequencing call + the post-seq plane math
        (nack masking, per-row seq bases, window-floor fold)."""
        self.flush()  # per-op queue first: per-doc seq order must hold
        out_seq, out_min, nacked, n_ok = self._sequence_columnar(
            self.deli.raw, w.handles, w.flat_client, w.flat_client_seq,
            w.flat_ref_seq,
            doc_of=lambda i: self._row_doc_id[w.rows[i // w.O]])
        w.out_seq, w.out_min, w.nacked, w.n_ok = out_seq, out_min, \
            nacked, n_ok
        w.dup_acked = self._dup_acked_last
        R, O = w.R, w.O
        # nacked slots become NOOP (they consumed no seq); the device
        # rebuilds per-op seqs from each row's base
        valid_rs = (~nacked).reshape(R, O)
        w.kind_eff = np.where(valid_rs, w.kind, int(OpKind.NOOP))
        w.seq_rs = out_seq.reshape(R, O)
        n_valid = valid_rs.sum(axis=1)
        w.seq_base = (np.max(np.where(valid_rs, w.seq_rs, 0), axis=1)
                      - n_valid).astype(np.int32)
        # fold this batch's MSN advance in BEFORE building the fused
        # compaction floor (a compaction-due batch zambonis at the
        # post-batch floor)
        w.min_rs = out_min.reshape(R, O)
        rdi = self._row_doc_id
        self._min_seq.update(zip((rdi[r] for r in w.rows.tolist()),
                                 w.min_rs[:, -1].tolist()))
        w.compact_due = \
            self._flushes_since_compact + 1 >= self.compact_every
        w.ms_arr = None
        if w.compact_due:
            ms_arr = np.zeros((self.n_docs,), np.int32)
            dr = self._doc_rows
            if dr:
                g = self._min_seq.get
                ms_arr[np.fromiter(dr.values(), np.int32, count=len(dr))] \
                    = np.fromiter((g(d, 0) for d in dr), np.int64,
                                  count=len(dr))
            w.ms_arr = ms_arr
        w.marks["seq1"] = time.perf_counter()

    def _ingest_dispatch(self, w: _IngestWave) -> None:
        """Stage 3 — the asynchronous device merge (zamboni fused into the
        same kernel launch on a compaction-due wave) on the calling
        thread's current stream, plus the deferred overflow-flag read.
        Rows holding intervals get the per-op floors (``min_ops``), where
        the store cuts the wave into segments."""
        pp = w.prepacked
        if pp is not None and self.store._iv_docs \
                and not self.store._iv_docs.isdisjoint(w.rows.tolist()):
            # intervals appeared on a targeted row between prepack and
            # dispatch: pack inline, which mints the per-op anchor handles
            self.store._tab_release(pp)
            pp = w.prepacked = None
        self.store.apply_planes(
            w.rows, w.kind_eff, w.a0, w.a1, w.seq_base, w.client,
            w.ref_seq, w.text, min_seq=w.ms_arr, texts=w.texts,
            tidx=w.tidx, props=w.props, min_ops=w.min_rs, prepacked=pp)
        if w.compact_due:
            self._flushes_since_compact = 0
            if self.mega_store is not None and self._mega_rows:
                self.mega_store.compact(self._mega_min_seq())
            for doc_id, store in self._graduated.items():
                store.compact(self._min_seq.get(doc_id, 0))
            if self.auto_recover:
                # DEFERRED overflow read: a synchronous flag read here
                # would stall the dispatch pipeline. Start an async
                # device→host copy of the flags now and inspect the
                # PREVIOUS compaction's copy (already landed): detection
                # is one compaction late, which only delays recovery (the
                # log holds every acked op).
                w.ov_prev = self._ov_pending
                self._ov_pending = self._async_flags()
        else:
            self._flushes_since_compact += 1
        w.marks["disp1"] = time.perf_counter()

    def _async_flags(self):
        """(host tensor, event): a clone of the overflow flags — the live
        buffer is overwritten by the next merge — copied non-blocking into
        pinned host memory; the event marks the copy's completion."""
        flags = self.store.overflow_flags()
        if flags.device.type != "cuda":
            return flags, None
        host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        host.copy_(flags, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(flags.device))
        return host, event

    def _ingest_log(self, w: _IngestWave) -> dict:
        """Stage 4 — the whole-batch log append (the ack barrier: poison
        clears and callers may ack only after it commits), then the
        overflow harvest. Recovery replays the log, so it runs after the
        append: inline on the serial path; on the pipelined path (other
        waves may still be in flight) the wave only marks it due, and the
        executor's ``drain`` recovers once nothing is in flight."""
        ts = self.deli.clock()
        R, O = w.R, w.O
        rows, kind, nacked = w.rows, w.kind, w.nacked
        out_seq, out_min = w.out_seq, w.out_min
        rowidx = np.repeat(np.arange(R, dtype=np.int32), O)
        ids = [self._row_doc_id[r] for r in rows]
        ref_clamped = self._clamped_ref(w.flat_ref_seq, out_seq)
        flat_tidx = None if w.tidx is None else np.ascontiguousarray(
            np.asarray(w.tidx, np.int32).reshape(-1))
        fields = (w.flat_client, w.flat_client_seq, ref_clamped, out_seq,
                  out_min, kind.reshape(-1), w.a0.reshape(-1),
                  w.a1.reshape(-1))
        if not nacked.any():
            # hot path: the whole batch is ONE record (copies detach the
            # log from caller-owned planes)
            self._append_columnar(ColumnarOps(
                ids, rowidx, *(f.copy() for f in fields),
                text=w.text, timestamp=ts, texts=w.texts, props=w.props,
                tidx=None if flat_tidx is None else flat_tidx.copy()))
        else:
            # nacked slots present: the survivors grouped by doc partition
            # with ONE stable sort, one record per partition
            parts = np.repeat(self._row_part[rows], O)
            ok_idx = np.flatnonzero(~nacked)
            order = ok_idx[np.argsort(parts[ok_idx], kind="stable")]
            bounds = np.searchsorted(
                parts[order], np.arange(self.log.n_partitions + 1))
            gathered = tuple(f[order] for f in fields)
            row_sorted = rowidx[order]
            tidx_sorted = None if flat_tidx is None else flat_tidx[order]
            for p in range(self.log.n_partitions):
                sl = slice(bounds[p], bounds[p + 1])
                if sl.start == sl.stop:
                    continue
                self._fenced_append(p, ColumnarOps(
                    ids, row_sorted[sl], *(g[sl] for g in gathered),
                    text=w.text, timestamp=ts, texts=w.texts, props=w.props,
                    tidx=None if tidx_sorted is None else tidx_sorted[sl]))
            self._ingest_mark_logged()
        if w.ov_prev is not None:
            host, event = w.ov_prev
            if event is not None:
                event.synchronize()
            if bool(host.numpy().any()):
                if w.pipelined:
                    self._ov_recover_due = True
                else:
                    self.recover_overflowed()
        n_dup = int(w.dup_acked or 0)
        # the wave is durable: pump one observer window at ingest pace
        # (this path never passes through flush()); on the pipelined
        # path this runs on the executor's log thread
        plane = self._read_plane
        if plane is not None and w.n_ok:
            plane.pump()
        w.marks["log1"] = time.perf_counter()
        return {"seq": w.seq_rs, "nacked": int(nacked.sum()) - n_dup,
                "dup_acked": n_dup, "marks": w.marks}

    # ----------------------------------------------------------- device side

    def _flush_impl(self) -> int:
        """Merge the queued window on the device: one batched apply for the
        flat tier, one for the mega tier, one per graduated doc."""
        n = self._queued()
        if self._queue:
            self.store.apply_messages(self._queue)
            self._queue.clear()
        if self._mega_queue:
            self.mega_store.apply_messages(self._mega_queue)
            self._mega_queue.clear()
        if self._grad_queue:
            per_doc: Dict[str, list] = {}
            for doc_id, msg in self._grad_queue:
                per_doc.setdefault(doc_id, []).append((0, msg))
            for doc_id, msgs in per_doc.items():
                self._graduated[doc_id].apply_messages(msgs)
            self._grad_queue.clear()
        return n

    def compact(self) -> None:
        """Zamboni at each doc's MSN (collaboration-window floor); reads
        the overflow flags and recovers on the same cadence."""
        min_seq = np.zeros((self.n_docs,), np.int32)
        for doc_id, row in self._doc_rows.items():
            min_seq[row] = self._min_seq.get(doc_id, 0)
        self.store.compact(min_seq)
        if self.mega_store is not None and self._mega_rows:
            self.mega_store.compact(self._mega_min_seq())
        for doc_id, store in self._graduated.items():
            store.compact(self._min_seq.get(doc_id, 0))
        super().compact()
        if self.auto_recover:
            self.recover_overflowed()

    # ----------------------------------------------------------------- reads

    def _store_of(self, doc_id: str):
        """(store, row) serving ``doc_id``; allocates a flat row for a doc
        that has none yet."""
        if doc_id in self._graduated:
            return self._graduated[doc_id], 0
        if doc_id in self._mega_rows:
            return self.mega_store, self._mega_rows[doc_id]
        return self.store, self.doc_row(doc_id)

    def read_text(self, doc_id: str) -> str:
        self.flush()
        store, row = self._store_of(doc_id)
        return store.read_text(row)

    def get_properties(self, doc_id: str, pos: int) -> dict:
        self.flush()
        store, row = self._store_of(doc_id)
        return store.get_properties(row, pos)

    def overflowed_docs(self) -> List[str]:
        """Flat-tier and mega docs whose device capacity overflowed (ops
        dropped until ``recover_overflowed`` rebuilds them)."""
        flags = self.store.overflowed()
        out = [d for d, row in self._doc_rows.items() if flags[row]]
        if self.mega_store is not None and self._mega_rows:
            mflags = self.mega_store.overflowed()
            out += [d for d, row in self._mega_rows.items()
                    if mflags[row].any()]
        return out

    # ----------------------------------------------------- overflow recovery

    def recover_overflowed(self, grow_limit: int = 1 << 20
                           ) -> Dict[str, str]:
        """Heal every doc whose row overflowed (the kernel dropped an op
        and set the sticky flag): replay the doc's whole history from the
        log into a rebuild store at doubled capacity (the same apply path),
        compact it at the doc's window floor, then re-upload it into its
        row when it fits again, or graduate it to a store of its own. The
        log holds every sequenced op, so no acked op is lost. A mega doc is
        rebuilt into a one-doc mega store through the mega tier's own
        apply (K7 on the card), its layout grown from the tier's, then
        dealt back over its shards, or graduated. A graduated store that
        overflows is rebuilt at doubled capacity ("regrown"). Returns
        {doc_id: "reuploaded" | "graduated" | "regrown"}.

        Rebuild stores sit on the engine's device. On the card a rebuild
        past what the kernel takes raises MemoryError, as does one past
        ``grow_limit``."""
        # logged-but-queued ops must not apply twice: the rebuild replays
        # the whole log, so the queues must be empty
        self.flush()
        report: Dict[str, str] = {}
        flags = self.store.overflowed()
        flat = [d for d, r in self._doc_rows.items() if flags[r]]
        if flat:
            report.update(self._recover_flat_batch(flat, grow_limit))
        if self.mega_store is not None and self._mega_rows:
            mflags = self.mega_store.overflowed()
            for doc_id in [d for d, r in self._mega_rows.items()
                           if mflags[r].any()]:
                report[doc_id] = self._recover_mega(doc_id, grow_limit)
        for doc_id, store in list(self._graduated.items()):
            if store.overflowed().any():
                ivs = store.intervals(0) if store._intervals[0] else {}
                tmp = self._rebuild_doc(doc_id, store, grow_limit)
                self._graduated[doc_id] = tmp
                self._readd_intervals(tmp, 0, ivs)
                report[doc_id] = "regrown"
        return report

    @staticmethod
    def _readd_intervals(store: TensorStringStore, row: int,
                         ivs: dict) -> None:
        """Anchor a rebuilt row's intervals again at the positions they
        resolved to before the rebuild (``ivs``: id → (start, end,
        props)), clamped to its visible length, under their old ids, and
        register the row as an interval row, so that its anchors go on
        sliding (the JAX engine leaves a graduated or regrown store's set
        of interval rows empty: ROADMAP C8)."""
        if not ivs:
            return
        store._iv_docs.add(row)
        slots = store._doc_slots(row)
        vis = int(slots[2][slots[3]].sum())
        for iid, (start, end, props) in ivs.items():
            clamp = lambda p: max(0, min(int(p), max(vis - 1, 0)))
            store._intervals[row][iid] = (
                store._anchor_in(slots, clamp(start)),
                store._anchor_in(slots, clamp(end)), dict(props))
        store._seed_tombs(row)

    def _check_rebuild_capacity(self, doc_id: str, cap: int,
                                grow_limit: int, src) -> None:
        """Refuse a rebuild of ``src``'s doc (a flat, graduated or mega
        store) at capacity ``cap`` past ``grow_limit``, or, on the card,
        past what the string kernel takes."""
        if cap > grow_limit:
            raise MemoryError(
                f"{doc_id}: rebuild exceeds grow limit {grow_limit}")
        K = src.n_props if src._has_props else 0
        if src.device.type == "cuda" and \
                not string_kernel.takes_capacity(cap, K):
            raise MemoryError(
                f"{doc_id}: a rebuild at capacity {cap} (K={K}) is past "
                "what the string_apply kernel takes (S <= "
                f"{string_kernel.MAX_S} slots and "
                f"{string_kernel.MAX_SMEM} B of shared memory per doc)")

    def _docs_log_messages(self, doc_ids: List[str]) -> Dict[str, list]:
        """Per doc, every sequenced OP message of ``doc_ids`` in seq order,
        in one pass over the log. Whole-batch columnar records round-robin
        across partitions, so every partition is scanned; a record's
        wanted slots are picked with numpy before any message is built."""
        want = set(doc_ids)
        buckets: Dict[str, list] = {d: [] for d in doc_ids}
        for p in range(self.log.n_partitions):
            for rec in self.log.read(p):
                if isinstance(rec, ColumnarOps):
                    local = [i for i, d in enumerate(rec.doc_ids)
                             if d in want]
                    if not local:
                        continue
                    for m in rec.messages(np.flatnonzero(
                            np.isin(rec.doc, local))):
                        buckets[m.doc_id].append(m)
                elif rec.doc_id in want and rec.type == MessageType.OP:
                    buckets[rec.doc_id].append(rec)
        for msgs in buckets.values():
            msgs.sort(key=lambda m: m.seq)
        return buckets

    def _rebuild_doc(self, doc_id: str, src, grow_limit: int,
                     capacity: Optional[int] = None) -> TensorStringStore:
        """Replay one doc's whole history into a fresh single-doc store,
        from twice ``capacity`` (``src``'s by default), doubling until it
        fits, compacted at the window floor."""
        msgs = self._docs_log_messages([doc_id])[doc_id]
        cap = max(src.capacity if capacity is None else capacity, 128)
        while True:
            cap *= 2
            self._check_rebuild_capacity(doc_id, cap, grow_limit, src)
            tmp = TensorStringStore(1, cap, src.n_props, src.device)
            tmp.apply_messages((0, m) for m in msgs)
            if not tmp.overflowed().any():
                break
        tmp.compact(self._min_seq.get(doc_id, 0))
        return tmp

    def _sync(self) -> None:
        """Wait for the card (recovery's time split only)."""
        if self.store.device.type == "cuda":
            torch.cuda.synchronize(self.store.device)

    def _recover_flat_batch(self, doc_ids: List[str],
                            grow_limit: int) -> Dict[str, str]:
        """Rebuild every overflowed flat-tier doc together: one store of
        all of them per capacity doubling, one batched apply, one compact,
        two flag/count reads. Docs that fit re-upload into their rows;
        docs still too big graduate to stores of their own."""
        t0 = time.perf_counter()
        stats = {"docs": len(doc_ids), "scan_s": 0.0, "apply_s": 0.0,
                 "compact_s": 0.0, "adopt_s": 0.0, "rebuilds": []}
        report: Dict[str, str] = {}
        msgs = self._docs_log_messages(doc_ids)
        stats["messages"] = sum(len(v) for v in msgs.values())
        t1 = time.perf_counter()
        stats["scan_s"] = t1 - t0
        pending = list(doc_ids)
        cap = max(self.store.capacity, 128)
        n_props = self.store.n_props
        while pending:
            cap *= 2
            self._check_rebuild_capacity(pending[0], cap, grow_limit,
                                         self.store)
            tmp = TensorStringStore(len(pending), cap, n_props,
                                    self.store.device)
            tmp.apply_messages([(i, m) for i, d in enumerate(pending)
                                for m in msgs[d]])
            self._sync()
            t2 = time.perf_counter()
            tmp.compact(np.fromiter(
                (self._min_seq.get(d, 0) for d in pending), np.int32,
                count=len(pending)))
            ov = tmp.overflowed()
            counts = tmp.slot_usage()
            t3 = time.perf_counter()
            stats["rebuilds"].append({"D": len(pending), "S": cap,
                                      "op_windows": tmp.last_op_windows})
            nxt = []
            for i, d in enumerate(pending):
                if ov[i]:
                    nxt.append(d)  # even doubled it did not fit: grow again
                    continue
                row = self._doc_rows[d]
                ivs = self.store.intervals(row) \
                    if self.store._intervals[row] else {}
                if int(counts[i]) <= self.store.capacity:
                    self.store.adopt_doc(row, tmp, src_row=i)
                    self._readd_intervals(self.store, row, ivs)
                    self._dirty_outside_ops.add(d)
                    report[d] = "reuploaded"
                else:
                    single = TensorStringStore(1, cap, n_props,
                                               self.store.device)
                    single.adopt_doc(0, tmp, src_row=i)
                    self.store.clear_doc(row)
                    self._graduated[d] = single
                    self._readd_intervals(single, 0, ivs)
                    self._release_flat_row(d)
                    report[d] = "graduated"
            pending = nxt
            self._sync()
            t4 = time.perf_counter()
            stats["apply_s"] += t2 - t1
            stats["compact_s"] += t3 - t2
            stats["adopt_s"] += t4 - t3
            t1 = t4
        self.last_recovery = stats
        return report

    def _recover_mega(self, doc_id: str, grow_limit: int) -> str:
        """Rebuild an overflowed mega doc through K7 (``_rebuild_mega``),
        then deal its compacted live slots back over its shards, or, when
        they outgrew the tier, graduate it to a flat store rebuilt from
        the log (``_rebuild_doc``, doubling from the tier's capacity a
        shard). A graduated doc's mega row is emptied (an empty rebuild
        adopted) and freed."""
        mega = self.mega_store
        row = self._mega_rows[doc_id]
        tmp = self._rebuild_mega(doc_id, mega, grow_limit)
        if int(tmp.state.count.sum()) <= mega.capacity_per_shard * \
                mega.n_shards:
            self.mega_store = mega.adopt_doc(row, tmp)
            return "reuploaded"
        self._graduated[doc_id] = self._rebuild_doc(
            doc_id, mega, grow_limit, capacity=mega.capacity_per_shard)
        self.mega_store = mega.adopt_doc(
            row, TensorStringStore(1, 128, mega.n_props, mega.device))
        del self._mega_rows[doc_id]
        self._free_mega_rows.append(row)
        return "graduated"

    def _rebuild_mega(self, doc_id: str, mega: MegaDocStringStore,
                      grow_limit: int) -> MegaDocStringStore:
        """Replay a mega doc's whole history into a one-doc mega store on
        the tier's device (K7 on the card, the plain version on the CPU),
        growing its layout (``mega_rebuild_layouts``) while the replay
        overflows or a rebalance refuses, compacted at the window floor; its
        layout and history size go to ``last_mega_rebuild``. A history
        that the JAX engine's flat rebuild, doubling from the tier's
        capacity a shard, would only hold past ``grow_limit`` is refused
        with MemoryError, as that rebuild refuses it."""
        msgs = self._docs_log_messages([doc_id])[doc_id]
        for tries, (n, S) in enumerate(mega_rebuild_layouts(
                doc_id, mega.n_shards, mega.capacity_per_shard, grow_limit,
                self._mega_limits(mega)), 1):
            tmp = MegaDocStringStore(
                1, S, n_shards=n, rebalance_headroom=mega.rebalance_headroom,
                device=mega.device)
            try:
                tmp.apply_messages((0, m) for m in msgs)
            except MegaCapacityError:
                continue
            if not tmp.overflowed().any():
                break
        slots = int(tmp.state.count.sum())
        self.last_mega_rebuild = {"shards": tmp.n_shards,
                                  "slots_a_shard": tmp.capacity_per_shard,
                                  "layouts_tried": tries,
                                  "history_slots": slots}
        cap = max(mega.capacity_per_shard, 128) * 2
        while cap < slots:
            cap *= 2
        if cap > grow_limit:
            raise MemoryError(
                f"{doc_id}: rebuild exceeds grow limit {grow_limit}")
        tmp.compact(self._min_seq.get(doc_id, 0))
        return tmp

    @staticmethod
    def _mega_limits(mega: MegaDocStringStore) -> Optional[Tuple[int, int]]:
        """(slots a shard, shards) K7 takes at the tier's K on the card;
        None on the CPU, where no kernel limit applies."""
        if mega.device.type != "cuda":
            return None
        from ..ops import megadoc_apply
        top_s = megadoc_apply.max_slots_per_shard(mega.n_props)
        return top_s, megadoc_apply.max_shards(top_s, mega.n_props)

    def _release_flat_row(self, doc_id: str) -> None:
        """Return a graduated doc's row to the allocator and forget its
        doc id and native handle, so a reused row cannot hit them."""
        row = self._doc_rows.pop(doc_id)
        self._free_rows.append(row)
        self._row_doc_id[row] = None
        self._row_handle[row] = -1

    # ----------------------------------------------------- summary / load

    def summarize(self, incremental: bool = False) -> dict:
        """Flush + compact (which recovers), then capture the recovery
        summary: store snapshot, graduated stores, sequencer checkpoint,
        per-partition log offsets, doc rows, window floors, dedup ledger
        and members.

        ``incremental=True`` (after a summary of this engine) captures a
        delta instead: only rows whose doc sequenced an op since the last
        summary, rows whose doc↔row mapping changed and rows rewritten by
        recovery, plus the interner tables' appended entries; the rest is
        carried by reference to the previous summary (``base``). Past
        ``max_incremental_chain`` deltas the summary is full again."""
        self.flush()
        self.compact()
        prev = self._summ_bookkeeping
        summary = self._base_summary()
        if self._incremental_ok(incremental):
            dirty_rows, cur_seqs = self._dirty_rows_since(prev)
            self._mark_delta(summary, prev, cur_seqs)
            summary["store_delta"] = self.store.snapshot_rows(
                sorted(dirty_rows), prev["payloads_len"],
                prev["prop_values_len"])
            self._chain_depth += 1
        else:
            summary["kind"] = "full"
            summary["store"] = self.store.snapshot()
            self._chain_depth = 0
            cur_seqs = {d: self.deli.doc_seq(d) for d in self._doc_rows}
        # the mega and graduated stores hold few docs: they ride in full
        # every time
        summary["mega_store"] = self.mega_store.snapshot() \
            if self.mega_store is not None else None
        summary["mega_rows"] = dict(self._mega_rows)
        # the free list in its order, so a load hands out the rows this
        # engine would (ROADMAP C6); the JAX load does not read it
        summary["free_mega_rows"] = list(self._free_mega_rows)
        summary["graduated"] = {d: s.snapshot()
                                for d, s in self._graduated.items()}
        self._note_summary(summary, cur_seqs,
                           payloads_len=len(self.store._payloads),
                           prop_values_len=len(self.store._prop_values))
        return summary

    @classmethod
    def load(cls, summary: dict, log: PartitionedLog, device="cuda",
             mesh=None, **kwargs) -> "StringServingEngine":
        """Resume from a summary (this package's or the JAX engine's, full
        or incremental, of a sharded engine or not) and the log: restore
        the flat store (the newest full summary, then each delta's rows),
        the mega and graduated stores, the sequencer and the dedup state,
        then replay the log tail through the same apply path (a
        ``markMega`` record in the tail routes its doc to the mega tier
        again). Every store is built on ``device``, the flat store sharded
        over ``mesh`` when one is given; the flat and graduated stores
        carry their intervals. A summary holding attribution is
        refused."""
        full, deltas = cls.resolve_summary_chain(summary)
        for s in [full] + deltas:
            if s.get("attribution") is not None:
                raise ValueError("summary holds attribution, which is not "
                                 "ported")
        store = TensorStringStore.from_jax_snapshot(full["store"], device,
                                                    mesh)
        for delta in deltas:
            store.apply_row_snapshot(delta["store_delta"])
        mega = None
        if summary.get("mega_store") is not None:
            mega = MegaDocStringStore.restore(summary["mega_store"], device)
        elif summary.get("mega_rows"):
            raise ValueError("summary routes docs to a mega tier but holds "
                             "no mega store")
        engine = cls(store.n_docs, store.capacity, store.n_props, log=log,
                     store=store, mega_store=mega, mesh=mesh, **kwargs)
        engine._restore_base(summary)
        engine._mega_rows = dict(summary.get("mega_rows") or {})
        if "free_mega_rows" in summary:
            engine._free_mega_rows = list(summary["free_mega_rows"])
        else:   # a JAX summary: the rows below the highest used one
            used = set(engine._mega_rows.values())
            engine._free_mega_rows = [r for r in range(max(used, default=-1))
                                      if r not in used]
        engine._graduated = {
            d: TensorStringStore.from_jax_snapshot(s, device)
            for d, s in summary.get("graduated", {}).items()}

        def mark_mega_hook(msg):
            if msg.type == MessageType.PROPOSAL and \
                    isinstance(msg.contents, dict) and \
                    msg.contents.get("markMega"):
                if msg.doc_id not in engine._mega_rows:
                    engine._register_mega(msg.doc_id)  # not logged again
                return True
            return False

        engine._replay_tail(summary, control_hook=mark_mega_hook)
        engine._mega_queue.sort(key=lambda dm: dm[1].seq)
        engine._grad_queue.sort(key=lambda dm: dm[1].seq)
        engine.flush()
        return engine


class MapServingEngine(ServingEngineBase):
    """Sequencer + log + batched device merge for SharedMap documents, on
    ``device`` (default the card; ``device="cpu"`` runs the plain
    versions). Ops are the SharedMap wire dicts {"op": "set" | "delete" |
    "clear", "key", "value"}; every apply is one launch of the map kernel
    (``ops/map_kernel.py``), one a shard when ``mesh`` (a 1-D ``docs``
    mesh) shards the planes by doc row. ``store`` adopts an existing store
    (``load``)."""

    _KINDS = {"set": OpKind.MAP_SET, "delete": OpKind.MAP_DELETE,
              "clear": OpKind.MAP_CLEAR}

    def __init__(self, n_docs: int, n_keys: int = 64,
                 batch_window: int = 64, n_partitions: int = 8,
                 log: Optional[PartitionedLog] = None,
                 store: Optional[TensorMapStore] = None,
                 sequencer: str = "python", device="cuda", mesh=None):
        check_store_mesh(store, mesh)
        self.store = store if store is not None \
            else TensorMapStore(n_docs, n_keys, device, mesh)
        self.mesh = self.store.mesh
        super().__init__(n_docs, batch_window, n_partitions, log=log,
                         sequencer=sequencer)
        # per-(rows, key vocabulary) key-slot table: steady-state ingest
        # with a stable vocabulary does no interning
        self._lut_cache: Optional[tuple] = None

    # ------------------------------------------------------- columnar ingest

    def _key_lut(self, rows: np.ndarray, keys: List[str]) -> np.ndarray:
        """(R, len(keys)) key → slot table of this batch's rows; mints
        slots, so a key-capacity KeyError comes before any sequencing."""
        ck = (tuple(keys), rows.tobytes())
        if self._lut_cache is not None and self._lut_cache[0] == ck:
            return self._lut_cache[1]
        lut = np.empty((len(rows), len(keys)), np.int32)
        for i, r in enumerate(rows):
            for j, k in enumerate(keys):
                lut[i, j] = self.store.key_slot(int(r), k)
        self._lut_cache = (ck, lut)
        return lut

    def ingest_planes(self, rows, client, client_seq, ref_seq, kind,
                      kidx, keys: List[str], values: Optional[list] = None,
                      vidx=None) -> dict:
        """The high-throughput map ingest: a dense (R, O) columnar batch of
        RAW set/delete/clear ops — sequenced in ONE native call, copied to
        the device as ONE packed buffer (~4-7 B/op) and merged in ONE kernel
        launch, logged as ONE ``ColumnarOps(family="map")`` record.

        rows: (R,) unique doc rows (allocate via ``doc_row``). kidx: (R, O)
        indices into ``keys`` (ignored at clears); values / vidx: the value
        table and (R, O) indices for sets. Everything is validated, and
        key slots and value handles minted, before sequencing. Nacked slots
        are skipped everywhere. Requires ``sequencer="native"``. Returns
        {"seq": (R, O) int64 (negative = nack code), "nacked": int}."""
        self._check_poisoned()
        raw = getattr(self.deli, "raw", None)
        if raw is None:
            raise RuntimeError("columnar ingest requires sequencer='native'")
        self.flush()
        rows = np.ascontiguousarray(rows, np.int32)
        R, O = kind.shape
        if len(rows) != R or len(np.unique(rows)) != R:
            raise ValueError("rows must be exactly one UNIQUE row per "
                             "plane row")
        kind = np.asarray(kind, np.int32)
        if not np.isin(kind, [int(k) for k in self._KINDS.values()]).all():
            raise ValueError("columnar map planes must be dense "
                             "set/delete/clear")
        if self.store.n_keys > 256:
            raise ValueError("columnar map ingest packs key slots as u8 "
                             "(store n_keys must be <= 256)")
        kidx = np.asarray(kidx, np.int32)
        keyed = kind != int(OpKind.MAP_CLEAR)
        if keyed.any() and (int(kidx[keyed].min()) < 0
                            or int(kidx[keyed].max()) >= len(keys)):
            raise ValueError("kidx beyond the keys table")
        sets = kind == int(OpKind.MAP_SET)
        if sets.any():
            if values is None or vidx is None:
                raise ValueError("set slots require values + vidx")
            vidx = np.asarray(vidx, np.int32)
            if int(vidx[sets].min()) < 0 or \
                    int(vidx[sets].max()) >= len(values):
                raise ValueError("vidx beyond the values table")
        lut = self._key_lut(rows, keys)
        a0 = np.where(keyed, lut[np.arange(R)[:, None],
                                 np.where(keyed, kidx, 0)], 0)
        if sets.any():
            handles_tab = np.fromiter(
                (self.store.value_handle(v) for v in values), np.int32,
                count=len(values))
            a1 = np.where(sets, handles_tab[np.where(sets, vidx, 0)], 0)
        else:
            a1 = np.zeros((R, O), np.int32)

        self._fill_row_handles(rows, raw)
        flat = lambda p: np.ascontiguousarray(np.asarray(p, np.int32)
                                              .reshape(-1))
        out_seq, out_min, nacked, n_ok = self._sequence_columnar(
            raw, np.repeat(self._row_handle[rows], O), flat(client),
            flat(client_seq), flat(ref_seq))
        valid_rs = (~nacked).reshape(R, O)
        kind_eff = np.where(valid_rs, kind, int(OpKind.NOOP))
        seq_rs = out_seq.reshape(R, O)
        seq_base = (np.max(np.where(valid_rs, seq_rs, 0), axis=1)
                    - valid_rs.sum(axis=1)).astype(np.int32)

        self.store.apply_rows(kind_eff, a0, a1, seq_base, rows)

        ok = ~nacked
        self._append_columnar(ColumnarOps(
            [self._row_doc_id[r] for r in rows],
            np.repeat(np.arange(R, dtype=np.int32), O)[ok],
            flat(client)[ok], flat(client_seq)[ok],
            self._clamped_ref(flat(ref_seq), out_seq)[ok], out_seq[ok],
            out_min[ok], kind.reshape(-1)[ok], flat(kidx)[ok],
            (flat(vidx) if vidx is not None
             else np.zeros(R * O, np.int32))[ok],
            text="", timestamp=self.deli.clock(), family="map",
            keys=list(keys),
            values=list(values) if values is not None else []))
        last_min = out_min.reshape(R, O)[:, -1]
        for i, r in enumerate(rows):
            self._min_seq[self._row_doc_id[r]] = int(last_min[i])
        return {"seq": seq_rs, "nacked": int(nacked.sum())}

    # ------------------------------------------------------ per-op route

    def _valid_op(self, contents: Any) -> bool:
        if not (isinstance(contents, dict)
                and contents.get("op") in self._KINDS
                and (contents["op"] == "clear" or
                     isinstance(contents.get("key"), str))):
            return False
        if contents["op"] == "set":
            try:  # the flush JSON-interns values: reject unserialisable now
                json.dumps(contents.get("value"))
            except (TypeError, ValueError):
                return False
        return True

    def _admit(self, doc_id: str, contents: Any,
               client_id: int = -1) -> None:
        """Row and key-slot reservation: a key-capacity KeyError becomes a
        CAPACITY nack before the op is logged."""
        row = self.doc_row(doc_id)
        if contents["op"] != "clear":
            self.store.key_slot(row, contents["key"])

    def _flush_impl(self) -> int:
        n = len(self._queue)
        if self._queue:
            self.store.apply_batch(
                (row, self._KINDS[m.contents["op"]],
                 m.contents.get("key"), m.contents.get("value"), m.seq)
                for row, m in self._queue)
            self._queue.clear()
        return n

    # ----------------------------------------------------------------- reads

    def read_doc(self, doc_id: str) -> dict:
        self.flush()
        return self.store.read_doc(self.doc_row(doc_id))

    def get(self, doc_id: str, key: str, default=None):
        return self.read_doc(doc_id).get(key, default)

    # ----------------------------------------------------- summary / load

    def summarize(self, incremental: bool = False) -> dict:
        """The store snapshot plus the base summary (sequencer checkpoint,
        log offsets, rows, window floors, dedup ledger, members).
        ``incremental=True`` (after a summary of this engine) captures a
        delta: only rows whose doc sequenced an op since the last summary
        or whose mapping changed, plus the value table's new entries; the
        rest rides by reference to ``base``. Past
        ``max_incremental_chain`` deltas the summary is full again."""
        self.flush()
        prev = self._summ_bookkeeping
        summary = self._base_summary()
        if self._incremental_ok(incremental):
            dirty_rows, cur_seqs = self._dirty_rows_since(prev)
            self._mark_delta(summary, prev, cur_seqs)
            summary["store_delta"] = self.store.snapshot_rows(
                sorted(dirty_rows), prev["values_len"])
            self._chain_depth += 1
        else:
            summary["kind"] = "full"
            self._chain_depth = 0
            summary["store"] = self.store.snapshot()
            cur_seqs = {d: self.deli.doc_seq(d) for d in self._doc_rows}
        self._note_summary(summary, cur_seqs,
                           values_len=len(self.store._interner))
        return summary

    @classmethod
    def load(cls, summary: dict, log: PartitionedLog, device="cuda",
             mesh=None, **kwargs) -> "MapServingEngine":
        """Resume from a summary (this package's or the JAX engine's, full
        or incremental, sharded or not) and the log: the newest full
        summary's store, each delta's rows over it, the sequencer and
        dedup state, then the log tail replayed through the same apply
        path. The store is built on ``device``, or sharded over ``mesh``."""
        full, deltas = cls.resolve_summary_chain(summary)
        store = TensorMapStore.from_jax_snapshot(full["store"], device, mesh)
        for delta in deltas:
            store.apply_row_snapshot(delta["store_delta"])
        engine = cls(store.n_docs, store.n_keys, log=log, store=store,
                     mesh=mesh, **kwargs)
        engine._restore_base(summary)
        engine._replay_tail(summary)
        engine.flush()
        return engine


class MatrixServingEngine(ServingEngineBase):
    """Sequencer + log + device merge for SharedMatrix documents, on
    ``device`` (default the card; ``device="cpu"`` runs the plain
    versions). Ops are the matrix wire dicts {"mx": "insRow" | "insCol" |
    "rmRow" | "rmCol" | "setCell" | "policy", ...}.

    The permutation state (row / col axes) lives in ``TensorAxisStore`` (2
    axis rows per doc) and position→key resolution at each op's (ref_seq,
    client) perspective happens inside the device scan that applies the
    axis mutations (the ``AXIS_RESOLVE`` op): one dispatch and one
    device→host read per flush. Cell writes merge into the sort-based
    cell table (``TensorMatrixStore``), shared across documents by
    interning (doc, rowKey, colKey) identities.

    FWW fidelity: the DDS's first-writer-wins rejects a write only when
    the writer had NOT seen the current value and is not its author. The
    engine tracks per-cell (seq, writer) host-side and filters FWW losers
    on the resolved key stream before the cell apply; the device always
    merges LWW, and the surviving stream's latest write is the DDS's
    answer. ``store`` / ``axis_store`` adopt existing stores (``load``).

    ``mesh`` (a 1-D ``docs`` mesh) shards BOTH stores by doc block: the
    axis rows (a doc's two adjacent) and the cell pool
    (``ShardedMatrixStore``: cells are doc-scoped, so each shard
    sort-merges its own docs' cells); every apply launches once a
    shard."""

    _MX = {"insRow", "insCol", "rmRow", "rmCol", "setCell", "policy"}

    #: latest-view perspective for reads (every acked op visible)
    _READ_REF = 1 << 30

    # structural bound on one axis op (an insert allocates count slots on
    # the axis: an unbounded count is a memory-exhaustion vector)
    MAX_AXIS_COUNT = 1 << 20

    def __init__(self, n_docs: int, cell_capacity: int = 1 << 16,
                 batch_window: int = 64, n_partitions: int = 8,
                 log: Optional[PartitionedLog] = None,
                 store: Optional[TensorMatrixStore] = None,
                 axis_capacity: int = 256,
                 axis_store: Optional[TensorAxisStore] = None,
                 sequencer: str = "python", device="cuda", mesh=None):
        check_store_mesh(store, mesh)
        check_store_mesh(axis_store, mesh)
        if store is not None:
            self.store = store
        elif mesh is not None:
            self.store = ShardedMatrixStore(cell_capacity, mesh, n_docs)
        else:
            self.store = TensorMatrixStore(cell_capacity, device=device)
        self.axis_store = axis_store if axis_store is not None \
            else TensorAxisStore(n_docs, axis_capacity, device, mesh)
        self.mesh = mesh
        super().__init__(n_docs, batch_window, n_partitions, log=log,
                         sequencer=sequencer)
        self._fww: Dict[int, bool] = {}
        # per-doc {cell: (seq, writer)}: the FWW visibility metadata
        self._cell_meta: Dict[int, Dict] = {}
        self._pending_setcells = 0  # queued setCells (capacity reservation)
        # deferred cell-ingest batches awaiting their resolve harvest
        self._pending_cells: List[dict] = []
        self._pending_cell_count = 0
        # conservative per-axis slot usage bound (each admitted axis op
        # adds at most 2 slots: an insert, or a remove's two splits);
        # re-based to the measured device counts at every compact()
        self._axis_used = np.zeros(2 * n_docs, np.int64)

    def _valid_op(self, contents: Any) -> bool:
        """Full structural validation BEFORE sequencing and logging: every
        field the flush path touches must have the type and range it
        assumes (a logged op that raises in flush poisons the engine and
        its recovery replay)."""
        if not (isinstance(contents, dict)
                and contents.get("mx") in self._MX):
            return False
        mx = contents["mx"]
        if mx in ("insRow", "insCol"):
            key = contents.get("opKey")
            return (self._is_nat(contents.get("pos"))
                    and self._is_nat(contents.get("count"), 1)
                    and contents["count"] <= self.MAX_AXIS_COUNT
                    and isinstance(key, (list, tuple)) and len(key) == 2
                    and all(self._is_nat(k, -(1 << 62)) for k in key)
                    and self._is_nat(contents.get("off", 0)))
        if mx in ("rmRow", "rmCol"):
            return (self._is_nat(contents.get("start"))
                    and self._is_nat(contents.get("count"), 1))
        if mx == "setCell":
            if not (self._is_nat(contents.get("row"))
                    and self._is_nat(contents.get("col"))):
                return False
            try:
                json.dumps(contents.get("value"))
                return True
            except (TypeError, ValueError):
                return False
        return True  # policy

    def _admit(self, doc_id: str, contents: Any,
               client_id: int = -1) -> None:
        row = self.doc_row(doc_id)
        if client_id >= 0 and contents["mx"] != "policy":
            # per-axis client capacity (MAX_CLIENTS): mint now so an op
            # that cannot be applied is CAPACITY-nacked, never acked
            self.axis_store.client(2 * row, client_id)
            self.axis_store.client(2 * row + 1, client_id)
        if contents["mx"] in ("insRow", "insCol", "rmRow", "rmCol"):
            # axis rows are fixed-capacity: an acked axis op the kernel
            # must drop (sticky overflow) would corrupt dims and cells, so
            # nack when the conservative bound says it may not fit
            axis = 2 * row + (1 if contents["mx"].endswith("Col") else 0)
            if self._axis_used[axis] + 2 > self.axis_store.capacity:
                raise KeyError("axis slot capacity exhausted")
            self._axis_used[axis] += 2
        if contents["mx"] == "setCell":
            # distinct interned identities never shrink and each queued
            # setCell (or deferred columnar write) may mint one more: past
            # this bound the table would drop acked live cells
            if not self.store.conservative_room(
                    self._pending_setcells + self._pending_cell_count):
                raise KeyError("cell table capacity exhausted")
            self._pending_setcells += 1

    # ----------------------------------------------------------- device side

    @staticmethod
    def _mixed(op_key) -> int:
        """The oracle's run identity mix (``opKey[0] · 1000003 +
        opKey[1]``)."""
        return op_key[0] * 1_000_003 + op_key[1]

    def _flush_impl(self) -> int:
        """Batch the window into per-axis-row op planes (axis mutations AND
        setCell position resolves in one scan), then FWW-filter the
        resolved key stream and merge the surviving cell writes. Deferred
        columnar cell batches harvest first (they were sequenced before
        anything in this queue)."""
        self._harvest_cells()
        n = len(self._queue)
        if not n:
            return n
        self._queue.sort(key=lambda dm: dm[1].seq)
        per_axis: Dict[int, list] = {}
        setcells = []  # (row, msg, r_slot, c_slot)
        dropped = set()
        for row, msg in self._queue:
            op = msg.contents
            mx = op["mx"]
            self._fww.setdefault(row, False)
            self._cell_meta.setdefault(row, {})
            ar, ac = 2 * row, 2 * row + 1
            try:
                self.axis_store.client(ar, msg.client_id)
                self.axis_store.client(ac, msg.client_id)
            except KeyError:
                dropped.add(id(msg))  # per-axis client capacity
                continue
            if mx in ("insRow", "insCol"):
                axis = ar if mx == "insRow" else ac
                run = self.axis_store.run_handle(
                    self._mixed(tuple(op["opKey"])), op.get("off", 0))
                per_axis.setdefault(axis, []).append(
                    (int(OpKind.STR_INSERT), op["pos"], op["count"], run,
                     msg.seq, self.axis_store.client(axis, msg.client_id),
                     msg.ref_seq))
            elif mx in ("rmRow", "rmCol"):
                axis = ar if mx == "rmRow" else ac
                per_axis.setdefault(axis, []).append(
                    (int(OpKind.STR_REMOVE), op["start"],
                     op["start"] + op["count"], 0, msg.seq,
                     self.axis_store.client(axis, msg.client_id),
                     msg.ref_seq))
            elif mx == "setCell":
                rl = per_axis.setdefault(ar, [])
                cl = per_axis.setdefault(ac, [])
                rl.append((int(OpKind.AXIS_RESOLVE), op["row"], 0, 0,
                           msg.seq,
                           self.axis_store.client(ar, msg.client_id),
                           msg.ref_seq))
                cl.append((int(OpKind.AXIS_RESOLVE), op["col"], 0, 0,
                           msg.seq,
                           self.axis_store.client(ac, msg.client_id),
                           msg.ref_seq))
                setcells.append((row, msg, len(rl) - 1, len(cl) - 1))
            # "policy" flips are applied in the seq-ordered pass below
        self._pending_setcells = 0

        rh = ro = None
        if per_axis:
            rh, ro = self._dispatch_axis(per_axis)

        # seq-ordered pass: policy flips + FWW filter on resolved keys
        records = []
        sc_i = 0
        for row, msg in self._queue:
            op = msg.contents
            if id(msg) in dropped:
                continue
            if op["mx"] == "policy":
                self._fww[row] = True
                continue
            if op["mx"] != "setCell":
                continue
            _, _, rs, cs = setcells[sc_i]
            sc_i += 1
            ar, ac = 2 * row, 2 * row + 1
            if rh[ar, rs] < 0 or rh[ac, cs] < 0:
                continue  # out of range at the op's perspective: dropped
            rk = self.axis_store.run_key(int(rh[ar, rs]), int(ro[ar, rs]))
            ck = self.axis_store.run_key(int(rh[ac, cs]), int(ro[ac, cs]))
            meta = self._cell_meta[row]
            cell = (rk, ck)
            if self._fww[row]:
                seq, writer = meta.get(cell, (0, None))
                if seq > msg.ref_seq and writer != msg.client_id:
                    continue  # FWW: an unseen concurrent write loses
            meta[cell] = (msg.seq, msg.client_id)
            records.append(((row, rk), ck, op["value"], msg.seq))
        self._queue.clear()
        if records:
            self.store.apply_batch(records)
        return n

    def ingest_cells(self, doc_ids: List[str], clients, client_seqs,
                     ref_seqs, rpos, cpos, values) -> dict:
        """High-throughput setCell ingest: N raw cell writes (op i targets
        ``doc_ids[i]`` at row / col positions ``rpos[i]`` / ``cpos[i]``):
        ONE native sequencing call, one resolve launch (K4) whose host
        copy is left in flight, ONE whole-batch durable record, and the
        harvest of every earlier batch (FWW filter on the resolved keys,
        one cell-table merge). Axis mutations and policy flips go through
        ``submit``. Requires ``sequencer="native"``. Returns {"seq": (N,)
        (negative = nack code), "nacked": int}."""
        self._check_poisoned()
        raw = getattr(self.deli, "raw", None)
        if raw is None:
            raise RuntimeError("cell ingest requires sequencer='native'")
        n = len(doc_ids)
        if not (len(clients) == len(client_seqs) == len(ref_seqs)
                == len(rpos) == len(cpos) == len(values) == n):
            raise ValueError("batch fields must have equal length")
        try:  # the log and the value interner both JSON-encode values:
            json.dumps(values)  # reject unserialisable BEFORE sequencing
        except (TypeError, ValueError) as e:
            raise ValueError(f"unserializable cell value: {e}") from None
        rpos = np.ascontiguousarray(rpos, np.int32)
        cpos = np.ascontiguousarray(cpos, np.int32)
        if len(rpos) and (int(rpos.min()) < 0 or int(cpos.min()) < 0):
            raise ValueError("negative cell position")
        if self._queue:   # per-op queue first: per-doc seq order holds
            self.flush()  # (also harvests any deferred cell batches)
        rows_l = list(map(self._doc_rows.get, doc_ids))
        if None in rows_l:  # unseen docs: the minting slow path
            rows = np.fromiter((self.doc_row(d) for d in doc_ids),
                               np.int32, count=n)
        else:
            rows = np.asarray(rows_l, np.int32)
        if not self.store.conservative_room(
                n + self._pending_cell_count):
            raise KeyError("cell table capacity exhausted")
        client = np.ascontiguousarray(clients, np.int32)
        # mint axis client slots BEFORE sequencing (a capacity failure
        # must reject the batch): one interner hit per unique (row, client)
        for p in np.unique(rows.astype(np.int64) * 4294967296
                           + (client.astype(np.int64)
                              & 0xFFFFFFFF)).tolist():
            row = p >> 32
            cid = int(np.uint32(p & 0xFFFFFFFF).astype(np.int32))
            self.axis_store.client(2 * row, cid)
            self.axis_store.client(2 * row + 1, cid)
        self._fill_row_handles(np.unique(rows), raw)
        cseq = np.ascontiguousarray(client_seqs, np.int32)
        ref = np.ascontiguousarray(ref_seqs, np.int32)
        out_seq, out_min, nacked, n_ok = self._sequence_columnar(
            raw, self._row_handle[rows], client, cseq, ref)
        ok = np.flatnonzero(~nacked)
        # the CLAMPED ref is what the log records and what recovery
        # replays: the live resolve and the FWW comparison use it too
        ref_clamped = self._clamped_ref(ref, out_seq)

        pend = self._cell_resolve(rows, client, rpos, cpos, values, ok,
                                  out_seq, ref_clamped) if len(ok) else None
        # the durable record is appended before the deferred harvest
        self._cell_record(doc_ids, ok, rpos, cpos, values, client, cseq,
                          ref_clamped, out_seq, out_min)
        self._min_seq.update(zip(map(doc_ids.__getitem__, ok.tolist()),
                                 out_min[ok].tolist()))
        if pend is not None:
            self._pending_cells.append(pend)
            self._pending_cell_count += len(pend["rows"])
        # pipeline: harvest every batch but the newest (its resolve and
        # its host copy overlap the caller's next batch)
        self._harvest_cells(keep_newest=True)
        return {"seq": out_seq, "nacked": int(nacked.sum())}

    def _cell_resolve(self, rows, client, rpos, cpos, values, ok, out_seq,
                      ref_clamped) -> dict:
        """ONE mutation-free resolve launch for every accepted op of a cell
        batch, its host copy left in flight: op i takes entry 2j (its row
        axis) and 2j+1 (its col axis), and per-axis slot order is op
        order. Returns the deferred batch for ``_harvest_cells``."""
        rows_ok = rows[ok].astype(np.int64)
        k2 = len(ok) * 2
        axis_arr = np.empty(k2, np.int64)
        axis_arr[0::2] = 2 * rows_ok
        axis_arr[1::2] = 2 * rows_ok + 1
        pos_in_axis, widest = positions_in_doc(axis_arr)
        o = 8
        while o < widest:
            o *= 2
        d2 = 2 * self.n_docs
        planes = {name: np.zeros((d2, o), np.int32)
                  for name in ("kind", "a0", "client", "ref_seq")}
        planes["kind"][:] = int(OpKind.NOOP)
        # client slot table: one interner hit per unique (axis, client)
        cl2 = np.repeat(client[ok].astype(np.int64), 2)
        uniq, inv = np.unique(axis_arr * (1 << 32) + cl2,
                              return_inverse=True)
        lut = np.fromiter(
            (self.axis_store.client(int(p >> 32), int(p & 0xFFFFFFFF))
             for p in uniq), np.int32, count=len(uniq))
        a0 = np.empty(k2, np.int64)
        a0[0::2] = rpos[ok]
        a0[1::2] = cpos[ok]
        planes["kind"][axis_arr, pos_in_axis] = int(OpKind.AXIS_RESOLVE)
        planes["a0"][axis_arr, pos_in_axis] = a0
        planes["client"][axis_arr, pos_in_axis] = lut[inv]
        planes["ref_seq"][axis_arr, pos_in_axis] = np.repeat(
            ref_clamped[ok], 2)
        return {
            "res": self.axis_store.resolve_async(planes),
            "axis": axis_arr, "pos": pos_in_axis,
            "rows": rows_ok, "client": client[ok].copy(),
            "ref": ref_clamped[ok].copy(), "seq": out_seq[ok].copy(),
            "values": [values[i] for i in ok],
        }

    def _cell_record(self, doc_ids, ok, rpos, cpos, values, client, cseq,
                     ref_clamped, out_seq, out_min) -> None:
        """The whole-batch durable record (family "ops"): it holds the RAW
        setCells, and recovery replays them through the same resolve +
        filter path."""
        id_tab = sorted(set(doc_ids))
        id_of = {d: i for i, d in enumerate(id_tab)}
        contents_tab = [{"mx": "setCell", "row": int(rpos[i]),
                         "col": int(cpos[i]), "value": values[i]}
                        for i in ok]
        self._append_columnar(ColumnarOps(
            id_tab, np.fromiter((id_of[doc_ids[i]] for i in ok), np.int32,
                                count=len(ok)),
            client[ok], cseq[ok], ref_clamped[ok], out_seq[ok],
            out_min[ok], np.zeros(len(ok), np.int32),
            np.arange(len(ok), dtype=np.int32),
            np.zeros(len(ok), np.int32),
            text="", timestamp=self.deli.clock(), family="ops",
            values=contents_tab))

    def _harvest_cells(self, keep_newest: bool = False) -> None:
        """Finish deferred cell-ingest batches in FIFO order: wait for
        their resolve results, run the FWW filter on the resolved keys and
        merge the survivors. ``keep_newest`` leaves the most recent batch
        in flight."""
        limit = len(self._pending_cells) - (1 if keep_newest else 0)
        for _ in range(max(limit, 0)):
            pend = self._pending_cells.pop(0)
            self._pending_cell_count -= len(pend["rows"])
            try:
                rh, ro = pend["res"].result()
            except Exception as e:   # device fault: state may lag the log
                self._poisoned = f"cell resolve harvest failed: {e!r}"
                self._pending_cells.clear()
                raise
            axis, pos = pend["axis"], pend["pos"]
            rh2 = rh[axis, pos].astype(np.int64)
            ro2 = ro[axis, pos].astype(np.int64)
            hr, hc = rh2[0::2], rh2[1::2]
            vi = np.flatnonzero((hr >= 0) & (hc >= 0))
            if not len(vi):  # out of range at perspective: dropped
                continue
            # resolved run keys: two gathers over the interned run table
            mixed, base = self.axis_store.runs_arrays()
            hr_v, hc_v = hr[vi], hc[vi]
            rkm, rkb = mixed[hr_v], base[hr_v] + ro2[0::2][vi]
            ckm, ckb = mixed[hc_v], base[hc_v] + ro2[1::2][vi]
            rows_v = pend["rows"][vi]
            seq_v = pend["seq"][vi]
            cl_v = pend["client"][vi]
            keep = self._fww_filter_columnar(
                rows_v, rkm, rkb, ckm, ckb, seq_v, cl_v, pend["ref"][vi])
            kept = np.flatnonzero(keep)
            if not len(kept):
                continue
            # key tuples built once, for survivors only: they feed the
            # visibility metadata and the columnar merge
            rk_pairs = list(zip(rkm[kept].tolist(), rkb[kept].tolist()))
            ck_pairs = list(zip(ckm[kept].tolist(), ckb[kept].tolist()))
            rows_l = rows_v[kept].tolist()
            seq_l = seq_v[kept].tolist()
            cells = list(zip(rk_pairs, ck_pairs))
            pairs = list(zip(seq_l, cl_v[kept].tolist()))
            # per-doc meta write-back in batch order (dict.update keeps
            # the last write of a cell)
            ri = rows_v[kept]
            order = np.argsort(ri, kind="stable")
            ri_sorted = ri[order]
            urows = np.unique(ri_sorted)
            bounds = np.append(np.searchsorted(ri_sorted, urows),
                               len(ri_sorted))
            for i, r in enumerate(urows.tolist()):
                idxs = order[bounds[i]:bounds[i + 1]].tolist()
                self._cell_meta[r].update(
                    zip(map(cells.__getitem__, idxs),
                        map(pairs.__getitem__, idxs)))
            vals = pend["values"]
            self.store.apply_batch_columnar(
                list(zip(rows_l, rk_pairs)), ck_pairs,
                list(map(vals.__getitem__, vi[kept].tolist())),
                np.asarray(seq_l, np.int32))

    def _fww_filter_columnar(self, rows, rkm, rkb, ckm, ckb, seqs,
                             clients, refs) -> np.ndarray:
        """First-writer-wins over one resolved, per-doc seq-ascending key
        stream; returns the bool keep mask. An op is dropped when the
        cell's current meta seq is newer than its ref AND held by another
        writer; each survivor installs (seq, client) as the new meta (so
        writes within the batch chain). Cells written once in the batch
        are judged vectorised against the persistent meta; cells written
        more than once replay the chain over their own ops."""
        k = len(rows)
        urows, row_inv = np.unique(rows, return_inverse=True)
        fww_flags = np.empty(len(urows), bool)
        for i, r in enumerate(urows.tolist()):
            fww_flags[i] = self._fww.setdefault(r, False)
            self._cell_meta.setdefault(r, {})
        keep = np.ones(k, bool)
        fww_op = fww_flags[row_inv]
        if not fww_op.any():
            return keep
        ident = np.empty((k, 5), np.int64)
        ident[:, 0] = rows
        ident[:, 1] = rkm
        ident[:, 2] = rkb
        ident[:, 3] = ckm
        ident[:, 4] = ckb
        _, first, inv, counts = np.unique(
            np.ascontiguousarray(ident).view([("", np.int64)] * 5).ravel(),
            return_index=True, return_inverse=True, return_counts=True)
        # the persistent meta probed once per unique FWW cell
        nu = len(first)
        prev_seq = np.zeros(nu, np.int64)
        prev_writer = np.full(nu, -1, np.int64)  # absent: seq 0 passes
        ufww = np.flatnonzero(fww_op[first])
        for t in ufww.tolist():
            j0 = int(first[t])
            prev = self._cell_meta[int(rows[j0])].get(
                ((int(rkm[j0]), int(rkb[j0])),
                 (int(ckm[j0]), int(ckb[j0]))))
            if prev is not None:
                prev_seq[t], prev_writer[t] = prev
        sing = fww_op & (counts[inv] == 1)
        keep[sing] = ~((prev_seq[inv][sing] > refs[sing])
                       & (prev_writer[inv][sing] != clients[sing]))
        for t in np.intersect1d(ufww, np.flatnonzero(counts > 1)).tolist():
            cs, cw = int(prev_seq[t]), int(prev_writer[t])
            for j in np.flatnonzero(inv == t).tolist():
                if cs > int(refs[j]) and cw != int(clients[j]):
                    keep[j] = False
                else:
                    cs, cw = int(seqs[j]), int(clients[j])
        return keep

    def _dispatch_axis(self, per_axis: Dict[int, list]):
        """Dense (2·D, O) planes from per-axis op lists → one launch."""
        widest = max(len(v) for v in per_axis.values())
        o = 8
        while o < widest:
            o *= 2
        names = ("kind", "a0", "a1", "a2", "seq", "client", "ref_seq")
        stack = np.zeros((7, 2 * self.n_docs, o), np.int32)
        stack[0] = int(OpKind.NOOP)
        for axis, recs in per_axis.items():
            stack[:, axis, :len(recs)] = np.array(recs, np.int32).T
        return self.axis_store.apply(
            {name: stack[i] for i, name in enumerate(names)})

    def overflowed(self) -> bool:
        """Sticky device overflow (cell table or an axis row): True means
        re-bucket with a larger table or axis capacity."""
        self._harvest_cells()
        return bool(self.store.overflowed()) or \
            bool(self.axis_store.overflowed().any())

    def compact(self) -> None:
        """Zamboni the axes at each doc's window floor; re-base the
        conservative axis-slot bound to the measured counts."""
        self.flush()
        ms = np.zeros((2 * self.n_docs,), np.int32)
        for doc_id, row in self._doc_rows.items():
            ms[2 * row] = ms[2 * row + 1] = self._min_seq.get(doc_id, 0)
        self.axis_store.compact(ms)
        self._axis_used = self.axis_store.state.count.cpu().numpy().astype(
            np.int64)
        super().compact()

    # ----------------------------------------------------------------- reads

    def _resolve_read(self, queries):
        """Latest-view resolves [(axis_row, pos)] → [(run, off)] in one
        non-mutating launch."""
        per_axis: Dict[int, list] = {}
        slots = []
        for axis, pos in queries:
            lst = per_axis.setdefault(axis, [])
            lst.append((int(OpKind.AXIS_RESOLVE), pos, 0, 0, 0, -1,
                        self._READ_REF))
            slots.append((axis, len(lst) - 1))
        rh, ro = self._dispatch_axis(per_axis)
        return [(int(rh[a, j]), int(ro[a, j])) for a, j in slots]

    def dims(self, doc_id: str):
        self.flush()
        row = self.doc_row(doc_id)
        lens = self.axis_store.visible_lengths()
        return int(lens[2 * row]), int(lens[2 * row + 1])

    def get_cell(self, doc_id: str, r: int, c: int):
        self.flush()
        row = self.doc_row(doc_id)
        (hr, orr), (hc, oc) = self._resolve_read(
            [(2 * row, r), (2 * row + 1, c)])
        if hr < 0 or hc < 0:
            raise IndexError(f"cell ({r}, {c}) out of range")
        return self.store.read_cell(
            ((row, self.axis_store.run_key(hr, orr)),
             self.axis_store.run_key(hc, oc)))

    def to_lists(self, doc_id: str):
        self.flush()
        row = self.doc_row(doc_id)
        nr, nc = self.dims(doc_id)
        res = self._resolve_read(
            [(2 * row, i) for i in range(nr)] +
            [(2 * row + 1, j) for j in range(nc)])
        rkeys = [self.axis_store.run_key(h, off) for h, off in res[:nr]]
        ckeys = [self.axis_store.run_key(h, off) for h, off in res[nr:]]
        cells = self.store.read_cells()
        return [[cells.get(((row, rk), ck)) for ck in ckeys]
                for rk in rkeys]

    # ----------------------------------------------------- summary / recovery

    def summarize(self, incremental: bool = False) -> dict:
        """The compacted stores plus the base summary. ``incremental=True``
        (after a summary of this engine) captures a delta: the dirty docs'
        axis rows and their FWW / cell metadata, plus the cell pool's live
        prefix (skipped when no doc is dirty: every merge rewrites the
        pool, so its delta is the live set) and the append-only identity,
        value and run tables' new entries; clean rows ride by reference to
        ``base``. Past ``max_incremental_chain`` deltas it is full again."""
        self.flush()
        self.compact()
        prev = self._summ_bookkeeping
        summary = self._base_summary()
        if self._incremental_ok(incremental):
            dirty_rows, cur_seqs = self._dirty_rows_since(prev)
            dirty = sorted(dirty_rows)
            self._mark_delta(summary, prev, cur_seqs)
            summary["cells_delta"] = self.store.snapshot_delta(
                prev["mx_bases"]) if dirty else None
            summary["axis_delta"] = self.axis_store.snapshot_rows(
                [a for r in dirty for a in (2 * r, 2 * r + 1)],
                prev["runs_len"])
            # per-dirty-row host metadata overlays (None = clear)
            summary["fww_delta"] = {r: self._fww.get(r) for r in dirty}
            summary["cell_meta_delta"] = {
                r: (list(self._cell_meta[r].items())
                    if r in self._cell_meta else None) for r in dirty}
            self._chain_depth += 1
        else:
            summary["kind"] = "full"
            self._chain_depth = 0
            summary["store"] = self.store.snapshot()
            summary["axis_store"] = self.axis_store.snapshot()
            summary["fww"] = dict(self._fww)
            summary["cell_meta"] = {row: list(m.items())
                                    for row, m in self._cell_meta.items()}
            cur_seqs = {d: self.deli.doc_seq(d) for d in self._doc_rows}
        summary["n_docs"] = self.n_docs
        self._note_summary(summary, cur_seqs,
                           mx_bases=self.store.table_bases(),
                           runs_len=len(self.axis_store._runs))
        return summary

    @classmethod
    def load(cls, summary: dict, log: PartitionedLog, device="cuda",
             mesh=None, **kwargs) -> "MatrixServingEngine":
        """Resume from a summary (this package's or the JAX engine's, full
        or incremental) and the log: the newest full summary's stores, each
        delta over them, the host metadata, the sequencer and dedup state,
        then the log tail replayed through the same apply path. The stores
        are built on ``device``, or sharded over ``mesh``. A doc-sharded
        cell pool's summary (``"sharded_docs"``) loads with or without a
        mesh, and so does one pool's: the live cells are dealt to their
        docs' shards, or merged into one pool."""
        full, deltas = cls.resolve_summary_chain(summary)
        if mesh is not None:
            store = ShardedMatrixStore.restore(full["store"], mesh,
                                               summary["n_docs"])
        else:
            store = TensorMatrixStore.restore(full["store"], device)
        axis = TensorAxisStore.restore(full["axis_store"], device, mesh)
        fww = dict(full["fww"])
        cell_meta = {
            row: {tuple_key(cell): tuple(sw) for cell, sw in items}
            for row, items in full["cell_meta"].items()}
        for delta in deltas:
            if delta["cells_delta"] is not None:
                store.apply_delta(delta["cells_delta"])
            axis.apply_row_snapshot(delta["axis_delta"])
            for r, v in delta["fww_delta"].items():
                if v is None:
                    fww.pop(int(r), None)
                else:
                    fww[int(r)] = v
            for r, items in delta["cell_meta_delta"].items():
                if items is None:
                    cell_meta.pop(int(r), None)
                else:
                    cell_meta[int(r)] = {tuple_key(cell): tuple(sw)
                                         for cell, sw in items}
        engine = cls(summary["n_docs"], log=log, store=store,
                     axis_store=axis, device=device, mesh=mesh, **kwargs)
        engine._restore_base(summary)
        engine._fww = fww
        engine._cell_meta = cell_meta
        # re-base the axis-slot admission bound from the restored planes
        # (a zeroed bound would admit ops the full axis cannot hold)
        engine._axis_used = axis.state.count.cpu().numpy().astype(np.int64)
        engine._replay_tail(summary)
        engine.flush()
        return engine


@dataclasses.dataclass
class TreeRecordOps:
    """A columnar run of sequenced tree ops in the log: per-op sequencing
    planes plus the RAW record planes and their batch-local tables
    (``server.tree_wire`` documents the wire). Recovery re-applies the
    record planes bit for bit; ``expand`` decodes op dicts only for audit
    and oracle replay."""

    doc_ids: List[str]          # row-local doc-id table
    doc: np.ndarray             # (N,) index into doc_ids
    client: np.ndarray          # (N,)
    client_seq: np.ndarray      # (N,)
    ref_seq: np.ndarray         # (N,)
    seq: np.ndarray             # (N,)
    min_seq: np.ndarray         # (N,)
    rec_op: np.ndarray          # (R,) op index per record, ascending
    recs: np.ndarray            # (R, 8) kind, node, parent, after, field,
    #                             value, type_, meta (batch-local handles)
    ids: List[str]              # 1-based tables (handle h <-> table[h-1])
    fields: List[str]
    types: List[str]
    values: list
    timestamp: float = 0.0

    def _op_slices(self):
        """(start, end) record range per op (rec_op ascends)."""
        n = len(self.seq)
        starts = np.searchsorted(self.rec_op, np.arange(n), side="left")
        ends = np.searchsorted(self.rec_op, np.arange(n), side="right")
        return starts, ends

    def expand(self, only_doc: Optional[str] = None
               ) -> List[SequencedDocumentMessage]:
        """Per-op messages with decoded dict contents (one vectorised
        decode pass over the run), or only ``only_doc``'s."""
        idxs = range(len(self.seq))
        if only_doc is not None:
            if only_doc not in self.doc_ids:
                return []
            want = self.doc_ids.index(only_doc)
            idxs = np.flatnonzero(np.asarray(self.doc) == want)
        ops = decode_records(self.rec_op, self.recs, self.ids,
                             self.fields, self.types, self.values)
        out = []
        for i in idxs:
            out.append(SequencedDocumentMessage(
                doc_id=self.doc_ids[int(self.doc[i])],
                client_id=int(self.client[i]),
                client_seq=int(self.client_seq[i]),
                ref_seq=int(self.ref_seq[i]), seq=int(self.seq[i]),
                min_seq=int(self.min_seq[i]), type=MessageType.OP,
                contents=ops[int(i)], timestamp=self.timestamp))
        return out


class _TreeIngestWave:
    """Per-wave carrier threaded through the tree engine's four
    columnar-ingest stages (the same ``PipelinedIngestExecutor`` hands it
    from worker to worker; ``ingest_records`` walks it in place)."""
    __slots__ = (
        "t_start", "n", "rows", "uniq_rows", "batch", "rec_op", "recs",
        "client", "cseq", "ref", "prepacked", "pipelined", "prep_ms",
        "prepack_ms", "seq_ms", "dispatch_ms", "log_ms", "out_seq",
        "out_min", "nacked", "n_ok", "keep", "ok")

    def __init__(self):
        self.prepacked = None
        self.pipelined = False
        self.prep_ms = 0.0
        self.prepack_ms = 0.0
        self.seq_ms = 0.0
        self.dispatch_ms = 0.0
        self.log_ms = 0.0


class TreeServingEngine(ServingEngineBase):
    """Sequencer + log + batched device merge for SharedTree documents, on
    ``device`` (default the card; ``device="cpu"`` runs the plain
    versions). Ops are the SharedTree wire dicts (insert / remove / move /
    setValue / transaction), submitted one by one or as pre-encoded record
    batches (``ingest_records`` / ``ingest_batch`` / ``ingest_leaves``);
    every apply is one launch of the tree record scan (plus the wire
    expansion on the compact-wire route). ``store`` adopts an existing
    store (``load``). ``mesh`` (a 1-D ``docs`` mesh) shards the store by
    doc row; each wave then takes the dense records, one launch a shard.

    Capacity: node slots are per doc row; an insert that finds no free
    slot sets the doc's sticky overflow flag and drops on the device.
    ``recover_overflowed`` rebuilds such a doc from its whole log history
    at doubled capacity (the same apply), then re-uploads it into its row
    when it fits or graduates it to a single-doc store of its own. Stores
    recovery builds sit on the engine's device; on the card a rebuild past
    what the kernel takes raises MemoryError."""

    def __init__(self, n_docs: int, capacity: int = 256,
                 batch_window: int = 64, n_partitions: int = 8,
                 log: Optional[PartitionedLog] = None,
                 store: Optional[TensorTreeStore] = None,
                 sequencer: str = "python", mesh=None, device="cuda"):
        check_store_mesh(store, mesh)
        super().__init__(n_docs, batch_window, n_partitions, log=log,
                         sequencer=sequencer)
        self.store = store if store is not None \
            else TensorTreeStore(n_docs, capacity, device, mesh)
        self.mesh = self.store.mesh
        self.device = self.store.device
        self.capacity = self.store.capacity
        # terminal tier: docs too big for the batched store, each in a
        # single-doc store sharing the main store's interners
        self._graduated: Dict[str, TensorTreeStore] = {}
        self._grad_queue: Dict[str, List[SequencedDocumentMessage]] = {}

    def allocate_node_ids(self, count: int) -> int:
        """Reserve ``count`` numeric node ids; returns the base handle (ids
        are ``#<base>`` .. ``#<base+count-1>``, never interned)."""
        return self.store._ids.reserve(count)

    def sync(self) -> np.ndarray:
        """Device -> host read of the per-row overflow flags."""
        return self.store.overflowed()

    # ------------------------------------------------------------ validation

    _EDIT_KINDS = ("insert", "remove", "move", "setValue", "transaction")

    def _valid_spec(self, spec: Any, depth: int = 0) -> bool:
        if depth > 64 or not isinstance(spec, dict) \
                or not isinstance(spec.get("id"), str) or not spec["id"]:
            return False
        if spec.get("type") is not None \
                and not isinstance(spec["type"], str):
            return False
        try:
            json.dumps(spec.get("value"))
        except (TypeError, ValueError):
            return False
        kids = spec.get("children")
        if kids is None:
            return True
        if not isinstance(kids, dict):
            return False
        for field, specs in kids.items():
            if not isinstance(field, str) or not isinstance(specs, list):
                return False
            if not all(self._valid_spec(c, depth + 1) for c in specs):
                return False
        return True

    def _valid_edit(self, op: Any, depth: int = 0) -> bool:
        if depth > 8 or not isinstance(op, dict) \
                or op.get("op") not in self._EDIT_KINDS:
            return False
        kind = op["op"]
        if kind == "insert":
            return (isinstance(op.get("parent"), str)
                    and isinstance(op.get("field"), str)
                    and (op.get("after") is None
                         or isinstance(op["after"], str))
                    and isinstance(op.get("nodes"), list)
                    and len(op["nodes"]) >= 1
                    and all(self._valid_spec(s) for s in op["nodes"]))
        if kind == "remove":
            return isinstance(op.get("id"), str) and bool(op["id"])
        if kind == "move":
            return (isinstance(op.get("id"), str)
                    and isinstance(op.get("parent"), str)
                    and isinstance(op.get("field"), str)
                    and (op.get("after") is None
                         or isinstance(op["after"], str)))
        if kind == "setValue":
            # "value" must be present: a logged op that flush cannot apply
            # poisons recovery
            if not isinstance(op.get("id"), str) or "value" not in op:
                return False
            try:
                json.dumps(op["value"])
            except (TypeError, ValueError):
                return False
            return True
        # transaction, top level only: a nested transaction's constraints
        # cannot share the single device gate (ok_txn)
        if depth > 0:
            return False
        cons = op.get("constraints", [])
        if not (isinstance(cons, list)
                and all(isinstance(c, dict)
                        and isinstance(c.get("nodeExists"), str)
                        for c in cons)):
            return False
        return (isinstance(op.get("edits"), list) and len(op["edits"]) >= 1
                and all(self._valid_edit(e, depth + 1)
                        for e in op["edits"]))

    def _valid_op(self, contents: Any) -> bool:
        return self._valid_edit(contents)

    # ----------------------------------------------------------- device side

    def _admit(self, doc_id: str, contents: Any,
               client_id: int = -1) -> None:
        if doc_id not in self._graduated:
            # a graduated doc owns its store: no flat row is pinned again
            self.doc_row(doc_id)

    def _enqueue(self, doc_id: str, msg: SequencedDocumentMessage) -> None:
        if doc_id in self._graduated:
            self._grad_queue.setdefault(doc_id, []).append(msg)
        else:
            self._queue.append((self.doc_row(doc_id), msg))

    def _queued(self) -> int:
        return len(self._queue) + sum(map(len, self._grad_queue.values()))

    def _flush_impl(self) -> int:
        n = len(self._queue)
        if self._queue:
            self.store.apply_messages(self._queue)
            self._queue.clear()
        for doc_id, msgs in self._grad_queue.items():
            if msgs:
                self._graduated[doc_id].apply_messages(
                    (0, m) for m in msgs)
                n += len(msgs)
                msgs.clear()
        return n

    # ------------------------------------------------------- columnar ingest

    def _validate_record_batch(self, batch: dict, n_ops: int):
        """Bounds-check a wire record batch. Only bounds matter for state
        safety: the kernel guards every merge rule, and recovery re-applies
        the same raw planes."""
        rec_op = np.ascontiguousarray(batch["rec_op"], np.int64)
        recs = np.ascontiguousarray(batch["recs"], np.int32)
        if recs.ndim != 2 or recs.shape[1] != 8 \
                or recs.shape[0] != len(rec_op):
            raise ValueError("record planes malformed")
        r = len(rec_op)
        if r and (rec_op[0] < 0 or rec_op[-1] >= n_ops
                  or np.any(np.diff(rec_op) < 0)):
            raise ValueError("rec_op must ascend within the op batch")
        # every op owns >= 1 record: a record-less op would be sequenced
        # but invisible to the seq derivation and the decoder
        if not np.array_equal(np.unique(rec_op), np.arange(n_ops)):
            raise ValueError("rec_op must cover every op in the batch")
        # id entries may be ints: numeric handles of the anonymous
        # namespace, passed through without interning
        if not all((isinstance(s, str) and s)
                   or (isinstance(s, int) and not isinstance(s, bool)
                       and ANON_BASE <= s < (1 << 31))
                   for s in batch["ids"]):
            raise ValueError("every id table entry must be a non-empty "
                             "str or a numeric handle in the anonymous "
                             "namespace")
        for tab, what in ((batch["fields"], "field"),
                          (batch["types"], "type")):
            if not all(isinstance(s, str) and s for s in tab):
                raise ValueError(
                    f"every {what} table entry must be a non-empty str")
        try:  # values land in the log record and the interner
            json.dumps(batch["values"], sort_keys=True)
        except (TypeError, ValueError) as e:
            raise ValueError(f"unserializable value table: {e}") from None
        if r:
            k = recs[:, 0]
            if not ((k >= 1) &
                    (k <= int(TreeOpKind.TXN_BEGIN_EXISTS))).all():
                raise ValueError("record kind out of range")
            for col, size, what in (
                    (1, len(batch["ids"]), "node"),
                    (2, len(batch["ids"]), "parent"),
                    (3, len(batch["ids"]), "after"),
                    (4, len(batch["fields"]), "field"),
                    (5, len(batch["values"]), "value"),
                    (6, len(batch["types"]), "type")):
                c = recs[:, col]
                if not ((c >= 0) & (c <= size)).all():
                    raise ValueError(f"{what} handle out of table bounds")
            me = recs[:, 7]
            if not ((me >= 0) & (me <= 1)).all():
                raise ValueError("record meta out of range")
        return rec_op, recs

    def _map_records(self, recs: np.ndarray, tables: dict) -> np.ndarray:
        """Batch-local table indices -> store interner handles (ids, then
        fields, types, values: the JAX engine's interning order)."""
        def table_map(items, interner):
            m = np.zeros(len(items) + 1, np.int32)
            if items:
                m[1:] = interner.bulk(items)
            return m

        id_map = table_map(tables["ids"], self.store._ids)
        f_map = table_map(tables["fields"], self.store._fields)
        t_map = table_map(tables["types"], self.store._types)
        v_map = table_map(tables["values"], self.store._values)
        g = np.empty_like(recs)
        g[:, 0] = recs[:, 0]
        g[:, 1] = id_map[recs[:, 1]]
        g[:, 2] = id_map[recs[:, 2]]
        g[:, 3] = id_map[recs[:, 3]]
        g[:, 4] = f_map[recs[:, 4]]
        g[:, 5] = v_map[recs[:, 5]]
        g[:, 6] = t_map[recs[:, 6]]
        g[:, 7] = recs[:, 7]
        return g

    def _wire_eligible(self, batch: dict) -> bool:
        """Can this batch ride the compact wire? The id / value lanes widen
        to u32, so only the u8 field / type lanes and the u16 row lane
        bound it; a sharded store, whose dense planes split by row, takes
        the dense path (as the JAX engine's mesh stores do)."""
        return (self.mesh is None
                and len(batch["ids"]) < 0x7FFFFFFF
                and len(batch["fields"]) < 0xFF
                and len(batch["types"]) < 0xFF
                and len(batch["values"]) < 0x7FFFFFFF
                and self.n_docs <= 0x10000)

    _WIRE_R_FLOOR = 256   # pow2 record-padding floor

    def _wave_base(self, rows: np.ndarray, out_seq: np.ndarray,
                   ok: np.ndarray) -> np.ndarray:
        """(D,) each doc's first op seq of the wave (op seqs are
        consecutive per doc within a wave)."""
        base = np.zeros(self.n_docs, np.int32)
        if len(ok):
            uniq, firsti = np.unique(rows[ok], return_index=True)
            base[uniq] = out_seq[ok][firsti].astype(np.int32)
        return base

    def _dispatch_wire(self, batch, recs, rec_op, keep, rows, out_seq,
                       nacked):
        """Pack the kept records into pooled wire buffers and dispatch the
        compact-wire apply. Returns the prep / dispatch split time, or None
        when the dense path must take the batch (o too wide)."""
        rec_op_k = rec_op[keep]
        pp = self.store.prepack_wire(recs[keep], rec_op_k,
                                     rows[rec_op_k].astype(np.int64), batch,
                                     r_floor=self._WIRE_R_FLOOR)
        if pp is None:
            return None
        base = self._wave_base(rows, out_seq, np.flatnonzero(~nacked))
        t_prep = time.perf_counter()
        self.store.apply_wire_prepacked(pp, base)
        return t_prep

    def _ingest_prepare(self, doc_ids: Optional[List[str]], clients,
                        client_seqs, ref_seqs, batch: dict,
                        rows: Optional[np.ndarray] = None,
                        prepack: bool = False) -> _TreeIngestWave:
        """Stage 1: validation, row resolution, row handles and (pipelined
        mode) the pooled wire pack and interner maps, all independent of
        sequencing."""
        raw = getattr(self.deli, "raw", None)
        if raw is None:
            raise RuntimeError("batch ingest requires sequencer='native'")
        w = _TreeIngestWave()
        w.t_start = time.perf_counter()
        n = len(doc_ids) if rows is None else len(rows)
        if not (len(clients) == len(client_seqs) == len(ref_seqs) == n):
            raise ValueError("batch fields must have equal length")
        w.rec_op, w.recs = self._validate_record_batch(batch, n)
        if rows is None:
            if self._graduated and any(d in self._graduated
                                       for d in doc_ids):
                raise ValueError("a targeted doc has graduated off the "
                                 "flat tier; route its ops through "
                                 "submit()")
            rows = np.fromiter((self.doc_row(d) for d in doc_ids),
                               np.int32, count=n)
        else:
            rows = np.ascontiguousarray(rows, np.int32)
            if n and not ((rows >= 0) & (rows < self.n_docs)).all():
                raise ValueError("row out of range")
        w.rows, w.n = rows, n
        w.uniq_rows = np.unique(rows)
        # a row without a doc fails here (KeyError)
        self._fill_row_handles(w.uniq_rows, raw)
        w.batch = batch
        w.client = np.ascontiguousarray(clients, np.int32)
        w.cseq = np.ascontiguousarray(client_seqs, np.int32)
        w.ref = np.ascontiguousarray(ref_seqs, np.int32)
        w.prep_ms = (time.perf_counter() - w.t_start) * 1000
        if prepack:
            w.pipelined = True
            if self._wire_eligible(batch):
                t0 = time.perf_counter()
                # every record, ahead of sequencing (a nacked wave discards
                # it at dispatch); None -> the dense path, which mints
                # table handles at dispatch (the executor then holds the
                # next wave's pack until this wave has dispatched)
                w.prepacked = self.store.prepack_wire(
                    w.recs, w.rec_op, rows[w.rec_op].astype(np.int64),
                    batch, r_floor=self._WIRE_R_FLOOR)
                w.prepack_ms = (time.perf_counter() - t0) * 1000
        return w

    def _ingest_sequence(self, w: _TreeIngestWave) -> None:
        """Stage 2: per-op queue flush, one native sequencing call, nack
        masks and the per-doc window floors."""
        self.flush()  # per-op queue first: per-doc seq order must hold
        t0 = time.perf_counter()
        w.out_seq, w.out_min, w.nacked, w.n_ok = self._sequence_columnar(
            self.deli.raw, self._row_handle[w.rows], w.client, w.cseq,
            w.ref)
        w.keep = ~w.nacked[w.rec_op] if len(w.rec_op) \
            else np.zeros(0, bool)
        w.ok = np.flatnonzero(~w.nacked)
        if len(w.ok):
            # the last op of each doc carries its latest min_seq
            rows_ok = w.rows[w.ok]
            order = np.argsort(rows_ok, kind="stable")
            rs = rows_ok[order]
            ms = w.out_min[w.ok][order]
            starts = np.r_[0, np.flatnonzero(np.diff(rs)) + 1]
            lasts = np.r_[starts[1:] - 1, len(rs) - 1]
            rdi = self._row_doc_id
            self._min_seq.update(
                zip((rdi[int(r)] for r in rs[starts]),
                    (int(m) for m in ms[lasts])))
        w.seq_ms = (time.perf_counter() - t0) * 1000

    def _ingest_dispatch(self, w: _TreeIngestWave) -> None:
        """Stage 3: the asynchronous device merge, by the prepacked wire,
        the inline wire pack or the dense planes. It is dispatched before
        the log append, which runs under it."""
        t0 = time.perf_counter()
        pp = w.prepacked
        if pp is not None and w.nacked.any():
            # rare: the prepack holds every record; drop it and repack
            # inline below with the keep mask
            self.store.release_wire(pp)
            pp = w.prepacked = None
        t_prep = None
        if pp is not None:
            base = self._wave_base(w.rows, w.out_seq, w.ok)
            t_prep = time.perf_counter()
            self.store.apply_wire_prepacked(pp, base)
            w.prepacked = None
        elif self._wire_eligible(w.batch):
            t_prep = self._dispatch_wire(w.batch, w.recs, w.rec_op,
                                         w.keep, w.rows, w.out_seq,
                                         w.nacked)
        if t_prep is None:
            # dense path: tables mapped on the host, int32 planes
            g = self._map_records(w.recs, w.batch)
            rows_r = w.rows[w.rec_op][w.keep]
            seq_r = w.out_seq[w.rec_op][w.keep]
            t_prep = time.perf_counter()
            self.store.apply_records(rows_r, g[w.keep], seq_r)
        w.prep_ms += (t_prep - t0) * 1000
        w.dispatch_ms = (time.perf_counter() - t_prep) * 1000

    def _ingest_log(self, w: _TreeIngestWave) -> dict:
        """Stage 4: the whole-batch log append (the ack barrier: the poison
        clears and callers may ack only after it)."""
        t0 = time.perf_counter()
        ok = w.ok
        doc_tab = [self._row_doc_id[int(r)] for r in w.uniq_rows]
        doc_plane = np.searchsorted(w.uniq_rows,
                                    w.rows[ok]).astype(np.int32)
        new_idx = np.cumsum(~w.nacked) - 1   # op index among kept ops
        ref_clamped = self._clamped_ref(w.ref, w.out_seq)
        batch = w.batch
        self._append_columnar(TreeRecordOps(
            doc_tab, doc_plane,
            w.client[ok], w.cseq[ok], ref_clamped[ok], w.out_seq[ok],
            w.out_min[ok], new_idx[w.rec_op][w.keep],
            np.ascontiguousarray(w.recs[w.keep]),
            list(batch["ids"]), list(batch["fields"]),
            list(batch["types"]), list(batch["values"]),
            timestamp=self.deli.clock()))
        w.log_ms = (time.perf_counter() - t0) * 1000
        return {"seq": w.out_seq, "nacked": int(w.nacked.sum()),
                "stage_ms": {"prep": w.prep_ms, "prepack": w.prepack_ms,
                             "seq": w.seq_ms, "dispatch": w.dispatch_ms,
                             "log": w.log_ms}}

    def ingest_records(self, doc_ids: Optional[List[str]], clients,
                       client_seqs, ref_seqs, batch: dict,
                       rows: Optional[np.ndarray] = None) -> dict:
        """The tree volume path: N edits of any kind (op i targets
        ``doc_ids[i]``, or the cached row ``rows[i]``; per-doc order = list
        order), pre-encoded in the record wire format
        (``server.tree_wire``): one native sequencing call, one table ->
        interner mapping, one batched device apply, one raw-plane log
        record (``TreeRecordOps``). Nacked ops' records are dropped
        everywhere. Cached rows go stale when ``recover_overflowed``
        graduates a doc. Returns {"seq": (N,) (negative = nack code),
        "nacked", "stage_ms"}.

        The serial walk of the four stage methods above; the
        ``PipelinedIngestExecutor`` runs the same stages on its workers
        (``ex.submit(None, clients, client_seqs, ref_seqs, batch,
        rows=rows)``)."""
        self._check_poisoned()
        w = self._ingest_prepare(doc_ids, clients, client_seqs,
                                 ref_seqs, batch, rows=rows)
        self._ingest_sequence(w)
        self._ingest_dispatch(w)
        return self._ingest_log(w)

    def ingest_batch(self, doc_ids: List[str], clients, client_seqs,
                     ref_seqs, ops: List[dict]) -> dict:
        """Dict ops over ``ingest_records``: validate and encode each op
        through the canonical ``RecordEmitter``, then the record path."""
        if len(ops) != len(doc_ids):
            raise ValueError("batch fields must have equal length")
        for op in ops:
            if not self._valid_op(op):
                raise ValueError(f"malformed tree op {op!r}")
        return self.ingest_records(doc_ids, clients, client_seqs, ref_seqs,
                                   encode_tree_batch(ops))

    def ingest_leaves(self, doc_ids: List[str], clients, client_seqs,
                      ref_seqs, parents: List[str], fields: List[str],
                      node_ids: List[str], values: list,
                      types: Optional[List[str]] = None,
                      afters: Optional[List[Optional[str]]] = None
                      ) -> dict:
        """The flat path: N single-node inserts (op i creates
        ``node_ids[i]`` under ``parents[i]`` / ``fields[i]``), each one
        ``INSERT_SOLO`` record: a validated front over
        ``tree_wire.encode_leaf_records`` + ``ingest_records``."""
        n = len(node_ids)
        types = types if types is not None else [None] * n
        afters = afters if afters is not None else [None] * n
        if not (len(doc_ids) == len(clients) == len(client_seqs)
                == len(ref_seqs) == len(parents) == len(fields)
                == len(values) == len(types) == len(afters) == n):
            raise ValueError("batch fields must have equal length")
        for lst, what in ((parents, "parent"), (fields, "field"),
                          (node_ids, "node id")):
            if not all(isinstance(x, str) and x for x in lst):
                raise ValueError(f"every {what} must be a non-empty str")
        if not all(t is None or isinstance(t, str) for t in types):
            raise ValueError("every type must be a str or None")
        if not all(a is None or (isinstance(a, str) and a)
                   for a in afters):
            raise ValueError("every after must be a non-empty str or None")
        try:  # values land in the log record and the interner
            json.dumps(values, sort_keys=True)
        except (TypeError, ValueError) as e:
            raise ValueError(f"unserializable node value: {e}") from None
        return self.ingest_records(
            doc_ids, clients, client_seqs, ref_seqs,
            encode_leaf_records(parents, fields, node_ids, values,
                                types, afters))

    def _store_of(self, doc_id: str):
        """(store, row) owning this doc."""
        if doc_id in self._graduated:
            return self._graduated[doc_id], 0
        return self.store, self.doc_row(doc_id)

    # ----------------------------------------------------------------- reads

    def to_dict(self, doc_id: str) -> dict:
        self.flush()
        store, row = self._store_of(doc_id)
        return store.to_dict(row)

    def node_value(self, doc_id: str, node_id: str):
        self.flush()
        store, row = self._store_of(doc_id)
        return store.node_value(row, node_id)

    def has_node(self, doc_id: str, node_id: str) -> bool:
        self.flush()
        store, row = self._store_of(doc_id)
        return store.has_node(row, node_id)

    def node_count(self, doc_id: str) -> int:
        self.flush()
        store, row = self._store_of(doc_id)
        return store.node_count(row)

    # ----------------------------------------------------- overflow recovery

    def overflowed_docs(self) -> List[str]:
        flags = self.store.overflowed()
        out = [d for d, row in self._doc_rows.items() if flags[row]]
        out += [d for d, s in self._graduated.items()
                if s.overflowed().any()]
        return out

    def _doc_log_messages(self, doc_id: str):
        """Every sequenced OP message of one doc, seq-ascending, with
        decoded dict contents (oracle replay / audit; the rebuild uses
        ``_doc_log_records``). Whole-batch records round-robin across
        partitions, so every partition is scanned."""
        p_own = partition_of(doc_id, self.log.n_partitions)
        msgs = []
        for p in range(self.log.n_partitions):
            for rec in self.log.read(p):
                if hasattr(rec, "expand"):
                    msgs.extend(rec.expand(only_doc=doc_id))
                elif p == p_own and rec.doc_id == doc_id \
                        and rec.type == MessageType.OP:
                    msgs.append(rec)
        msgs.sort(key=lambda m: m.seq)
        return msgs

    def _doc_log_records(self, doc_id: str):
        """One doc's whole raw record history as seq-ascending per-op
        (seq, records) chunks in the store's handle space:
        ``TreeRecordOps`` contribute their planes bit for bit, per-op
        messages re-encode through the canonical emitter."""
        p_own = partition_of(doc_id, self.log.n_partitions)
        emitter = self.store.emitter
        chunks: List[tuple] = []   # (seq, (k, 8) global-handle records)

        def add_msg(m):
            chunks.append((m.seq,
                           np.array(emitter.emit_op(m.contents), np.int32)))

        for p in range(self.log.n_partitions):
            for rec in self.log.read(p):
                if isinstance(rec, TreeRecordOps):
                    if doc_id not in rec.doc_ids:
                        continue
                    want = rec.doc_ids.index(doc_id)
                    sel = np.flatnonzero(np.asarray(rec.doc) == want)
                    if not len(sel):
                        continue
                    g = self._map_records(
                        np.ascontiguousarray(rec.recs, np.int32),
                        {"ids": rec.ids, "fields": rec.fields,
                         "types": rec.types, "values": rec.values})
                    starts, ends = rec._op_slices()
                    for i in sel:
                        chunks.append((int(rec.seq[i]),
                                       g[starts[i]:ends[i]]))
                elif isinstance(rec, ColumnarOps):
                    for m in rec.expand(only_doc=doc_id):
                        add_msg(m)
                elif p == p_own and rec.doc_id == doc_id \
                        and rec.type == MessageType.OP:
                    add_msg(rec)
        chunks.sort(key=lambda c: c[0])
        return chunks

    _REBUILD_CHUNK = 2048   # bounds the packed scan length per apply

    @staticmethod
    def _chunked_ops(chunks):
        """Group per-op (seq, recs) chunks into apply batches of at most
        ``_REBUILD_CHUNK`` records WITHOUT splitting an op: the kernel
        resets the group flags per apply, so a transaction's records must
        land in one batch."""
        batch: List[tuple] = []
        size = 0
        for seq, recs in chunks:
            if batch and size + len(recs) > TreeServingEngine._REBUILD_CHUNK:
                yield batch
                batch, size = [], 0
            batch.append((seq, recs))
            size += len(recs)
        if batch:
            yield batch

    @staticmethod
    def _flatten_ops(batch):
        recs = np.concatenate([c[1] for c in batch])
        seqs = np.concatenate([np.full(len(c[1]), c[0], np.int64)
                               for c in batch])
        return recs, seqs

    def _check_rebuild_capacity(self, doc_id: str, cap: int,
                                grow_limit: int) -> None:
        """Refuse a rebuild at capacity ``cap`` past ``grow_limit`` or, on
        the card, past what the tree_apply kernel takes."""
        if cap > grow_limit:
            raise MemoryError(
                f"{doc_id}: rebuild exceeds grow limit {grow_limit}")
        if self.device.type == "cuda" and cap > tree_apply.max_slots():
            raise MemoryError(
                f"{doc_id}: a rebuild at capacity {cap} is past what the "
                f"tree_apply kernel takes (N <= {tree_apply.max_slots()} "
                "node slots, nine planes of a doc in shared memory)")

    def _rebuild_doc(self, doc_id: str, start_capacity: int,
                     grow_limit: int) -> TensorTreeStore:
        """Replay the doc's whole raw record history into a fresh
        single-doc store sharing the batched store's interners (so its
        planes can be adopted verbatim), doubling the capacity until it
        fits; chunked applies keep the scan length bounded."""
        chunks = self._doc_log_records(doc_id)
        cap = max(start_capacity, 64)
        while True:
            cap *= 2
            self._check_rebuild_capacity(doc_id, cap, grow_limit)
            tmp = TensorTreeStore(1, cap, self.device)
            tmp.share_interners(self.store)
            for batch in self._chunked_ops(chunks):
                recs, seqs = self._flatten_ops(batch)
                tmp.apply_records(np.zeros(len(recs), np.int64), recs,
                                  seqs)
            if not tmp.overflowed().any():
                tmp.repack()   # slot churn must not inflate the fit check
                return tmp

    def recover_overflowed(self, grow_limit: int = 1 << 16
                           ) -> Dict[str, str]:
        """Heal every overflowed doc from its log history: re-upload it
        into its row when the rebuild fits, else graduate it; a graduated
        store that overflows is rebuilt at doubled capacity. No acked op
        is lost. Returns {doc_id: "reuploaded" | "graduated" |
        "regrown"}."""
        self.flush()  # queues must be empty: the rebuild replays the log
        report: Dict[str, str] = {}
        flags = self.store.overflowed()
        for doc_id in [d for d, r in self._doc_rows.items() if flags[r]]:
            row = self._doc_rows[doc_id]
            tmp = self._rebuild_doc(doc_id, self.store.capacity, grow_limit)
            if tmp.high_water() <= self.store.capacity:
                self.store.adopt_doc(row, tmp)
                report[doc_id] = "reuploaded"
            else:
                self.store.clear_doc(row)
                self._graduated[doc_id] = tmp
                # free the row and its columnar-ingest caches: a cached row
                # of this doc now fails loudly in _fill_row_handles
                self._free_rows.append(self._doc_rows.pop(doc_id))
                self._row_doc_id[row] = None
                self._row_handle[row] = -1
                report[doc_id] = "graduated"
            # planes rewritten outside the op stream: the next delta
            # summary must carry the row
            self._dirty_outside_ops.add(doc_id)
        for doc_id, store in list(self._graduated.items()):
            if store.overflowed().any():
                self._graduated[doc_id] = self._rebuild_doc(
                    doc_id, store.capacity, grow_limit)
                report[doc_id] = "regrown"
        return report

    # ----------------------------------------------------- summary / load

    def summarize(self, incremental: bool = False) -> dict:
        """Flush, then the recovery summary: the store snapshot (or, with
        ``incremental=True`` after a summary of this engine, the rows whose
        doc sequenced an op since, rows whose mapping changed or that
        recovery rewrote, and the interner deltas), the graduated stores
        in full, and the base summary."""
        self.flush()
        prev = self._summ_bookkeeping
        summary = self._base_summary()
        if self._incremental_ok(incremental):
            dirty_rows, cur_seqs = self._dirty_rows_since(prev)
            self._mark_delta(summary, prev, cur_seqs)
            summary["store_delta"] = self.store.snapshot_rows(
                sorted(dirty_rows), prev["interner_bases"])
            self._chain_depth += 1
        else:
            summary["kind"] = "full"
            self._chain_depth = 0
            summary["store"] = self.store.snapshot()
            cur_seqs = {d: self.deli.doc_seq(d) for d in self._doc_rows}
        summary["graduated"] = {d: s.snapshot()
                                for d, s in self._graduated.items()}
        self._note_summary(summary, cur_seqs,
                           interner_bases=self.store.interner_bases())
        return summary

    def _replay_tail(self, summary: dict) -> None:
        """Tree tail replay: raw ``TreeRecordOps`` planes re-apply bit for
        bit, per-op messages re-encode through the emitter; everything
        goes through the sequencer in (doc, seq) order and applies in
        chunks at op boundaries (the kernel resets the group flags per
        apply)."""
        self._verify_tail_anchor(summary)
        items: List[tuple] = []   # (doc_id, seq, msg, raw recs or None)
        for p in range(self.log.n_partitions):
            for rec in self.log.read(
                    p, from_offset=summary["log_offsets"][p]):
                if isinstance(rec, TreeRecordOps):
                    g = self._map_records(
                        np.ascontiguousarray(rec.recs, np.int32),
                        {"ids": rec.ids, "fields": rec.fields,
                         "types": rec.types, "values": rec.values})
                    starts, ends = rec._op_slices()
                    for i in range(len(rec.seq)):
                        msg = SequencedDocumentMessage(
                            doc_id=rec.doc_ids[int(rec.doc[i])],
                            client_id=int(rec.client[i]),
                            client_seq=int(rec.client_seq[i]),
                            ref_seq=int(rec.ref_seq[i]),
                            seq=int(rec.seq[i]),
                            min_seq=int(rec.min_seq[i]),
                            type=MessageType.OP, contents=None,
                            timestamp=rec.timestamp)
                        items.append((msg.doc_id, msg.seq, msg,
                                      g[starts[i]:ends[i]]))
                elif hasattr(rec, "expand"):
                    for m in rec.expand():
                        items.append((m.doc_id, m.seq, m, None))
                else:
                    items.append((rec.doc_id, rec.seq, rec, None))
        items.sort(key=lambda t: (t[0], t[1]))
        emitter = self.store.emitter
        flat_ops: List[tuple] = []   # (row, seq, recs) whole ops
        grad: Dict[str, List[tuple]] = {}
        for doc_id, seq, msg, raw in items:
            self.deli.replay(msg)
            self._absorb_resilience(msg)
            if msg.type != MessageType.OP:
                continue
            self._min_seq[doc_id] = max(self._min_seq.get(doc_id, 0),
                                        msg.min_seq)
            rl = raw if raw is not None else \
                np.array(emitter.emit_op(msg.contents), np.int32)
            if doc_id in self._graduated:
                grad.setdefault(doc_id, []).append((seq, rl))
            else:
                flat_ops.append((self.doc_row(doc_id), seq, rl))
        batch: List[tuple] = []
        size = 0

        def apply_flat(batch):
            rows = np.concatenate([np.full(len(r), row, np.int64)
                                   for row, _s, r in batch])
            recs = np.concatenate([r for _row, _s, r in batch])
            seqs = np.concatenate([np.full(len(r), s, np.int64)
                                   for _row, s, r in batch])
            self.store.apply_records(rows, recs, seqs)

        for row, seq, rl in flat_ops:
            if batch and size + len(rl) > self._REBUILD_CHUNK:
                apply_flat(batch)
                batch, size = [], 0
            batch.append((row, seq, rl))
            size += len(rl)
        if batch:
            apply_flat(batch)
        for doc_id, parts in grad.items():
            for gb in self._chunked_ops(parts):
                recs, seqs = self._flatten_ops(gb)
                self._graduated[doc_id].apply_records(
                    np.zeros(len(recs), np.int64), recs, seqs)

    @classmethod
    def load(cls, summary: dict, log: PartitionedLog, device="cuda",
             mesh=None, **kwargs) -> "TreeServingEngine":
        """Resume from a summary (this package's or the JAX engine's, full
        or incremental) and the log: the newest full summary's store, each
        delta's rows over it, the graduated stores (re-aliased to the
        restored interners), the sequencer and dedup state, then the log
        tail re-applied. Every store is built on ``device``, the batched
        one sharded over ``mesh`` when one is given."""
        full, deltas = cls.resolve_summary_chain(summary)
        store = TensorTreeStore.restore(full["store"], device, mesh)
        for delta in deltas:
            store.apply_row_snapshot(delta["store_delta"])
        engine = cls(store.n_docs, store.capacity, log=log, store=store,
                     mesh=mesh, **kwargs)
        engine._restore_base(summary)
        for doc_id, snap in summary["graduated"].items():
            grad = TensorTreeStore.restore(snap, device)
            # graduated stores alias the batched store's interners, so
            # their snapshots exported the same tables: alias them again
            grad.share_interners(engine.store)
            engine._graduated[doc_id] = grad
        engine._replay_tail(summary)
        engine.flush()
        return engine


def engine_class(family: str):
    """The serving engine of ``family`` (string, map, matrix or tree)."""
    return {"string": StringServingEngine, "map": MapServingEngine,
            "matrix": MatrixServingEngine, "tree": TreeServingEngine}[family]
