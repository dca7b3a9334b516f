"""The replica serving engine: sequencer + partitioned log + batched device
merge, for many SharedString documents (the flat tier).

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
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..ops.schema import OpKind
from ..ops.string_store import TensorStringStore
from .deli import DeliSequencer, Nack, NackReason
from .oplog import PartitionedLog, partition_of


class DedupLedger:
    """Per ``(doc, client)`` the recent ``clientSeq → seq`` acks, recorded
    only after the op's log append: a resubmitted op whose ack was lost is
    re-acked with its original seq instead of nacked. Bounded per key."""

    def __init__(self, window: int = 512):
        self.window = window
        self._led: Dict[Tuple[str, int], "collections.OrderedDict"] = {}
        self._lock = threading.Lock()

    def record(self, doc_id: str, client_id: int, client_seq: int,
               seq: int) -> None:
        key = (doc_id, int(client_id))
        with self._lock:
            led = self._led.get(key)
            if led is None:
                led = self._led[key] = collections.OrderedDict()
            led[int(client_seq)] = int(seq)
            while len(led) > self.window:
                led.popitem(last=False)

    def lookup(self, doc_id: str, client_id: int,
               client_seq: int) -> Optional[int]:
        with self._lock:
            led = self._led.get((doc_id, int(client_id)))
            return None if led is None else led.get(int(client_seq))


def make_sequencer(kind: str = "python", clock=None):
    """"python" = the reference-semantics DeliSequencer; "native" = the C++
    sequencer behind the same surface (raises when it cannot be built)."""
    if kind == "native":
        from .native_deli import NativeDeliAdapter
        return NativeDeliAdapter(clock=clock)
    if kind != "python":
        raise ValueError(f"unknown sequencer {kind!r}")
    return DeliSequencer(clock=clock)


@dataclasses.dataclass
class ColumnarOps:
    """A columnar run of sequenced string ops in the log — ONE record per
    ingest batch (or per partition when some ops were nacked) instead of
    one object per op. Payload forms: broadcast ``text``, or per-op
    ``texts`` + ``tidx``; annotate slots index the single-key ``props``
    table through ``tidx``."""

    doc_ids: List[str]          # row-local doc-id table
    doc: np.ndarray             # (N,) index into doc_ids
    client: np.ndarray          # (N,)
    client_seq: np.ndarray      # (N,)
    ref_seq: np.ndarray         # (N,)
    seq: np.ndarray             # (N,)
    min_seq: np.ndarray         # (N,)
    kind: np.ndarray            # (N,) OpKind
    a0: np.ndarray              # (N,) pos / start
    a1: np.ndarray              # (N,) len / end
    text: str                   # broadcast insert payload
    timestamp: float = 0.0
    texts: Optional[List[str]] = None
    props: Optional[List[dict]] = None
    tidx: Optional[np.ndarray] = None

    def expand(self) -> List[SequencedDocumentMessage]:
        """The per-op message stream this record stands for."""
        out = []
        for i in range(len(self.seq)):
            k = int(self.kind[i])
            if k == OpKind.STR_INSERT:
                text = self.text if self.texts is None \
                    else self.texts[int(self.tidx[i])]
                contents = {"mt": "insert", "kind": 0, "pos": int(self.a0[i]),
                            "text": text,
                            "clientSeq": int(self.client_seq[i])}
            elif k == OpKind.STR_ANNOTATE:
                contents = {"mt": "annotate", "start": int(self.a0[i]),
                            "end": int(self.a1[i]),
                            "props": self.props[int(self.tidx[i])]}
            else:
                contents = {"mt": "remove", "start": int(self.a0[i]),
                            "end": int(self.a1[i])}
            out.append(SequencedDocumentMessage(
                doc_id=self.doc_ids[int(self.doc[i])],
                client_id=int(self.client[i]),
                client_seq=int(self.client_seq[i]),
                ref_seq=int(self.ref_seq[i]), seq=int(self.seq[i]),
                min_seq=int(self.min_seq[i]), type=MessageType.OP,
                contents=contents, timestamp=self.timestamp))
        return out


class ServingEngineBase:
    """The DDS-agnostic half of a serving engine: Deli sequencing, the
    partitioned log, doc-row membership, window-floor tracking and the
    batch window. Subclasses own the device store."""

    def __init__(self, n_docs: int, batch_window: int = 64,
                 n_partitions: int = 8, compact_every: int = 16,
                 log: Optional[PartitionedLog] = None,
                 sequencer: str = "python"):
        self.deli = make_sequencer(sequencer)
        self.log = log if log is not None else PartitionedLog(n_partitions)
        self.n_docs = n_docs
        self.batch_window = batch_window
        self.compact_every = compact_every
        self._doc_rows: Dict[str, int] = {}
        self._queue: List[Tuple[int, SequencedDocumentMessage]] = []
        self._flushes_since_compact = 0
        self._min_seq: Dict[str, int] = {}
        self._dedup = DedupLedger()
        self._dup_acked_last = 0
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

    def _check_poisoned(self) -> None:
        if self._poisoned:
            raise RuntimeError(
                f"engine poisoned ({self._poisoned}): device state may be "
                "ahead of the log")

    # ------------------------------------------------------------ membership

    def doc_row(self, doc_id: str) -> int:
        row = self._doc_rows.get(doc_id)
        if row is None:
            row = len(self._doc_rows)
            if row >= self.n_docs:
                raise KeyError(f"document capacity {self.n_docs} exhausted")
            self._doc_rows[doc_id] = row
            self._row_doc_id[row] = doc_id
            self._row_part[row] = partition_of(doc_id, self.log.n_partitions)
        return row

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
        return msg

    def disconnect(self, doc_id: str, client_id: int
                   ) -> Optional[SequencedDocumentMessage]:
        msg = self.deli.client_leave(doc_id, client_id)
        if msg is not None:
            self._log_append(doc_id, msg)
        return msg

    # ------------------------------------------ shared columnar protocol

    def _sequence_columnar(self, raw, handles, client, client_seq,
                           ref_seq, doc_of):
        """One native sequencing call, then POISON the engine until the
        batch's log record is appended. Returns (out_seq, out_min, nacked
        mask, n_ok). DUPLICATE-nacked slots found in the dedup ledger get
        their ORIGINAL seq patched into ``out_seq`` (so the ack fan
        re-acks them) while staying in the ``nacked`` mask (never
        re-applied or re-logged); ``doc_of`` maps a flat slot to its doc."""
        out_seq, out_min = raw.sequence_batch_rows(
            handles, client, client_seq, ref_seq)
        with self._poison_lock:
            self._seq_unlogged += 1
            self._poisoned = "columnar batch failed after sequencing"
        nacked = out_seq < 0
        n_ok = int((~nacked).sum())
        n_dup = 0
        if nacked.any():
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

    def _append_columnar(self, record: ColumnarOps) -> None:
        """Whole-batch append (round-robin partition) + poison clear."""
        p = self._col_part
        self._col_part = (p + 1) % self.log.n_partitions
        self.log.append(p, record)
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
            self._admit(doc_id, contents)
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
        self._queue.append((self.doc_row(doc_id), msg))
        self._min_seq[doc_id] = msg.min_seq
        if len(self._queue) >= self.batch_window:
            self.flush()
        return msg, None

    def _valid_op(self, contents: Any) -> bool:
        return True

    @staticmethod
    def _is_nat(v, lo: int = 0) -> bool:
        return isinstance(v, int) and not isinstance(v, bool) and v >= lo

    def _admit(self, doc_id: str, contents: Any) -> None:
        """Reserve the capacity the op will need at flush; KeyError → the
        op is nacked before it is logged."""
        self.doc_row(doc_id)

    def _unadmit(self) -> None:
        """Undo ``_admit`` when the sequencer nacks after admission."""

    def _log_append(self, doc_id: str, msg: SequencedDocumentMessage) -> None:
        self.log.append(partition_of(doc_id, self.log.n_partitions), msg)

    def flush(self) -> int:
        """Apply the queued window on the device; drives the compaction
        cadence. Returns the number of messages applied."""
        n = self._flush_impl()
        if n:
            self._flushes_since_compact += 1
            if self._flushes_since_compact >= self.compact_every:
                self.compact()
        return n

    def _flush_impl(self) -> int:
        raise NotImplementedError

    def compact(self) -> None:
        self._flushes_since_compact = 0


class _IngestWave:
    """Per-wave carrier threaded through the four columnar-ingest stages."""
    __slots__ = (
        "rows", "R", "O", "kind", "a0", "a1", "client", "ref_seq", "text",
        "texts", "tidx", "props", "flat_client", "flat_client_seq",
        "flat_ref_seq", "handles", "prepacked", "pipelined", "out_seq",
        "out_min", "nacked", "n_ok", "kind_eff", "seq_rs", "seq_base",
        "min_rs", "compact_due", "ms_arr", "ov_prev", "dup_acked")

    def __init__(self):
        self.prepacked = None
        self.pipelined = False
        self.ov_prev = None


class StringServingEngine(ServingEngineBase):
    """Sequencer + log + batched device merge for many documents, on
    ``device`` (default the card; ``device="cpu"`` runs the plain
    versions)."""

    def __init__(self, n_docs: int, capacity: int = 256, n_props: int = 4,
                 batch_window: int = 64, n_partitions: int = 8,
                 compact_every: int = 16,
                 log: Optional[PartitionedLog] = None,
                 sequencer: str = "python", device="cuda"):
        self.store = TensorStringStore(n_docs, capacity, n_props, device)
        super().__init__(n_docs, batch_window, n_partitions, compact_every,
                         log, sequencer=sequencer)
        # in-flight async copy of the overflow flags (deferred read)
        self._ov_pending = None
        self._admit_token = None

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

    def _admit(self, doc_id: str, contents: Any) -> None:
        """Row + property-plane reservation, refunded by ``_unadmit``."""
        self.doc_row(doc_id)
        self._admit_token = None
        props = contents.get("props")
        if props:
            self._admit_token = self.store.reserve_props(props)

    def _unadmit(self) -> None:
        if self._admit_token is not None:
            self.store.release_props(self._admit_token)
        self._admit_token = None

    def heartbeat(self, doc_id: str, client_id: int, ref_seq: int) -> None:
        """NOOP: advances the client's refSeq (and the doc's MSN) so zamboni
        can reclaim tombstones; consumes no clientSeq."""
        msg, _ = self.deli.sequence(
            doc_id, client_id, 0, ref_seq, MessageType.NOOP, None)
        if msg is not None:
            self._min_seq[doc_id] = msg.min_seq

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
        (negative = nack code), "nacked": int, "dup_acked": int}."""
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
            w.prepacked = self.store.prepack_planes(
                kind, w.a0, w.a1, text, texts, tidx, props)
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

    def _ingest_dispatch(self, w: _IngestWave) -> None:
        """Stage 3 — the asynchronous device merge (zamboni fused into the
        same kernel launch on a compaction-due wave) on the calling
        thread's current stream, plus the deferred overflow-flag read."""
        self.store.apply_planes(
            w.rows, w.kind_eff, w.a0, w.a1, w.seq_base, w.client,
            w.ref_seq, w.text, min_seq=w.ms_arr, texts=w.texts,
            tidx=w.tidx, props=w.props, prepacked=w.prepacked)
        if w.compact_due:
            self._flushes_since_compact = 0
            # DEFERRED overflow read: a synchronous flag read here would
            # stall the dispatch pipeline. Start an async device→host copy
            # of the flags now and inspect the PREVIOUS compaction's copy
            # (already landed): detection is one compaction late.
            w.ov_prev = self._ov_pending
            self._ov_pending = self._async_flags()
        else:
            self._flushes_since_compact += 1

    def _async_flags(self):
        """(host tensor, event): a clone of the overflow flags — the live
        buffer is overwritten by the next merge — copied non-blocking into
        pinned host memory; the event marks the copy's completion."""
        flags = self.store.state.overflow.clone()
        if flags.device.type != "cuda":
            return flags, None
        host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        host.copy_(flags, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _ingest_log(self, w: _IngestWave) -> dict:
        """Stage 4 — the whole-batch log append (the ack barrier: poison
        clears and callers may ack only after it commits).

        Raises OverflowError (after the append, so the log holds every
        acked op) when the deferred flag read shows a doc whose device
        capacity overflowed: overflow recovery is not ported, and its ops
        would otherwise be dropped silently."""
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
                self.log.append(p, ColumnarOps(
                    ids, row_sorted[sl], *(g[sl] for g in gathered),
                    text=w.text, timestamp=ts, texts=w.texts, props=w.props,
                    tidx=None if tidx_sorted is None else tidx_sorted[sl]))
            self._ingest_mark_logged()
        if w.ov_prev is not None:
            host, event = w.ov_prev
            if event is not None:
                event.synchronize()
            rows_over = np.flatnonzero(host.numpy())
            if len(rows_over):
                docs = [self._row_doc_id[r] for r in rows_over[:8]]
                raise OverflowError(
                    f"{len(rows_over)} docs overflowed their device "
                    f"capacity (e.g. {docs}); overflow recovery is not "
                    "ported — rebuild with a larger capacity")
        n_dup = int(w.dup_acked or 0)
        return {"seq": w.seq_rs, "nacked": int(nacked.sum()) - n_dup,
                "dup_acked": n_dup}

    # ----------------------------------------------------------- device side

    def _flush_impl(self) -> int:
        """Merge the queued window on the device in one batched apply."""
        n = len(self._queue)
        if self._queue:
            self.store.apply_messages(self._queue)
            self._queue.clear()
        return n

    def compact(self) -> None:
        """Zamboni at each doc's MSN (collaboration-window floor)."""
        min_seq = np.zeros((self.n_docs,), np.int32)
        for doc_id, row in self._doc_rows.items():
            min_seq[row] = self._min_seq.get(doc_id, 0)
        self.store.compact(min_seq)
        super().compact()

    # ----------------------------------------------------------------- reads

    def read_text(self, doc_id: str) -> str:
        self.flush()
        return self.store.read_text(self.doc_row(doc_id))

    def overflowed_docs(self) -> List[str]:
        """Docs whose device capacity overflowed (ops dropped)."""
        flags = self.store.overflowed()
        return [d for d, row in self._doc_rows.items() if flags[row]]
