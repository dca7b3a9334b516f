"""LocalService: the whole ordering service in one process ("tinylicious").

Reference counterpart: ``tinylicious`` / ``LocalDeltaConnectionServer`` +
``LocalOrderer`` (SURVEY.md §1, §4): the full Alfred → Kafka → Deli →
Broadcaster/Scriptorium/Scribe pipeline, in memory, deterministic, for local
development and integration tests. Unlike ``testing.MockSequencer`` (a flat
stub), this wires the real lambdas end to end: raw ops flow through the
partitioned log, Deli stamps them, and the sequenced stream feeds broadcast,
durable storage, and summary acks — exactly the production topology, minus
sockets.

Counterpart of ``fluidframework_tpu/server/tinylicious.py``: the same
connections, dedup ledger, lambdas, catch-up reads, summary upload,
spill recovery with its epoch bump and writer fence, and checkpoints. The
live operations plane (``start_ops`` and its ticker) is not here yet.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.protocol import (
    MessageType, SequencedDocumentMessage, SignalMessage,
)
from ..utils import tracing
from ..utils.telemetry import REGISTRY
from .deli import DeliSequencer, Nack, NackReason
from .oplog import PartitionedLog, partition_of
from .services import Broadcaster, Historian, Scribe, Scriptorium

#: per-(doc, client) dedup-ledger window: how many recent clientSeq→seq
#: acks are retained for idempotent dup-acking. A client's in-flight
#: window (ops submitted but unacked) is far smaller than this, so any
#: resubmitted op is either in the ledger (dup-acked with its original
#: seq) or was never durable (plain DUPLICATE nack → the client
#: renumbers and resends).
_DEDUP_WINDOW = 512


class DeltaConnection:
    """One client's connection to one document (reference:
    IDocumentDeltaConnection): submit ops, receive the sequenced stream."""

    def __init__(self, service: "LocalService", doc_id: str, client_id: int):
        self.service = service
        self.doc_id = doc_id
        self.client_id = client_id
        self._client_seq = 0
        self.listeners: List[Callable[[SequencedDocumentMessage], None]] = []
        self.signal_listeners: List[Callable[[SignalMessage], None]] = []
        self.nacks: List[Nack] = []
        #: resubmits recognized by the dedup ledger: acked idempotently
        #: with the ORIGINAL seq (``Nack.seq``) instead of nacked
        self.dup_acks: List[Nack] = []
        self.connected = True

    def submit(self, contents: Any, type: MessageType = MessageType.OP,
               ref_seq: int = 0, address: Optional[str] = None) -> int:
        assert self.connected, "submit on closed connection"
        if type != MessageType.NOOP:
            self._client_seq += 1
        self.service._ingest(
            self.doc_id, self.client_id, self._client_seq, ref_seq, type,
            contents, address)
        return self._client_seq

    def submit_raw(self, client_seq: int, contents: Any,
                   type: MessageType = MessageType.OP, ref_seq: int = 0,
                   address: Optional[str] = None) -> None:
        """Ingest with a CLIENT-stamped clientSeq (the network ingress path:
        the reference client stamps clientSequenceNumber itself so the
        service can dedupe at-least-once retries; Deli enforces continuity
        and nacks gaps/duplicates)."""
        assert self.connected, "submit on closed connection"
        self._client_seq = max(self._client_seq, client_seq)
        self.service._ingest(self.doc_id, self.client_id, client_seq,
                             ref_seq, type, contents, address)

    def on_op(self, fn: Callable[[SequencedDocumentMessage], None]) -> None:
        self.listeners.append(fn)

    def submit_signal(self, contents: Any) -> None:
        """Ephemeral broadcast: straight to connected clients, bypassing the
        sequencing pipeline entirely (reference: signals ride the socket
        layer, not Kafka)."""
        assert self.connected, "signal on closed connection"
        self.service._broadcast_signal(
            SignalMessage(self.doc_id, self.client_id, contents))

    def on_signal(self, fn: Callable[[SignalMessage], None]) -> None:
        self.signal_listeners.append(fn)

    def disconnect(self) -> None:
        if self.connected:
            self.connected = False
            self.service._leave(self)


class LocalService:
    """In-process ordering service with the production lambda topology."""

    def __init__(self, n_partitions: int = 4,
                 spill_dir: Optional[str] = None):
        self.raw_log = PartitionedLog(n_partitions, spill_dir, "rawdeltas")
        self.deltas_log = PartitionedLog(n_partitions, spill_dir, "deltas")
        self.deli = DeliSequencer()
        self.broadcaster = Broadcaster()
        self.scriptorium = Scriptorium()
        self.historian = Historian()
        self.scribe = Scribe(self.historian)
        self._next_client = 1
        self._lock = threading.RLock()
        self.nacks: List[Nack] = []
        self._connections: Dict[int, DeltaConnection] = {}
        # durable-dedup ledger: (doc, client) -> OrderedDict[clientSeq,
        # seq] of recently acked ops, recorded only AFTER the sequenced
        # message is durable in the deltas log — a resubmit is dup-acked
        # with its original seq iff that seq can never be lost
        self._acked: Dict[Tuple[str, int],
                          "collections.OrderedDict[int, int]"] = {}
        #: session epoch: bumped by every :meth:`recover`, handed to
        #: clients at connect/resync so they can tell a reconnect to the
        #: same instance from a reconnect across a restart
        self.epoch = 0
        #: writer epoch stamped on every durable append: the logs'
        #: persisted fence word at open. ``recover()`` bumps the
        #: fence, so an instance deposed by a recovery gets
        #: ``FencedWriterError`` on its next append instead of
        #: interleaving seqs into a stream it no longer owns.
        self.writer_epoch = max(self.raw_log.fence_epoch,
                                self.deltas_log.fence_epoch)
        self.deli.epoch = self.writer_epoch
        # wire the pipeline: raw -> deli -> deltas -> fan-out lambdas
        for p in range(n_partitions):
            self.raw_log.subscribe(p, self._deli_consume)
            self.deltas_log.subscribe(p, self._deltas_consume)

    # ------------------------------------------------------------ front door

    def connect(self, doc_id: str) -> DeltaConnection:
        """Alfred/Nexus ingress: allocate a client id, sequence the join,
        open the delta stream."""
        with self._lock:
            client_id = self._next_client
            self._next_client += 1
            conn = DeltaConnection(self, doc_id, client_id)
            self._connections[client_id] = conn
            self.broadcaster.join(doc_id, self._deliver_to(conn))
            join = self.deli.client_join(doc_id, client_id)
            self._publish(join)
        return conn

    def reconnect(self, doc_id: str, client_id: int) -> DeltaConnection:
        """Session resumption: re-bind an existing client identity to a
        fresh connection WITHOUT re-sequencing a join (``client_join``
        resets the dedup state — re-joining a still-seated client would
        let an already-sequenced resubmit double-apply). Used by the
        ingress resync path after a socket loss or a service restart."""
        with self._lock:
            old = self._connections.get(client_id)
            if old is not None and old.connected and old.doc_id == doc_id:
                # the previous socket's delivery is a zombie: detach it
                # without sequencing a leave (the seat stays held)
                self.broadcaster.leave(doc_id, old._deliver)
                old.connected = False
            conn = DeltaConnection(self, doc_id, client_id)
            conn._client_seq = self.deli.last_client_seq(doc_id, client_id)
            self._connections[client_id] = conn
            self.broadcaster.join(doc_id, self._deliver_to(conn))
            if not self.deli.is_member(doc_id, client_id):
                # across a restart the seat may have been released (clean
                # leave replayed from the log): re-join, dedup continuity
                # coming from the ledger rather than ClientState
                join = self.deli.client_join(doc_id, client_id)
                self._publish(join)
            self._next_client = max(self._next_client, client_id + 1)
        return conn

    def last_client_seq(self, doc_id: str, client_id: int) -> int:
        """Highest clientSeq the sequencer ever accepted from this client
        (resync contract: the client renumbers still-pending ops past
        this so burned clientSeqs — sequenced-but-lost ops — cannot
        wedge the resubmit stream)."""
        with self._lock:
            return self.deli.last_client_seq(doc_id, client_id)

    def _deliver_to(self, conn: DeltaConnection):
        def deliver(msg: SequencedDocumentMessage):
            if conn.connected:
                for fn in list(conn.listeners):
                    fn(msg)
        conn._deliver = deliver
        return deliver

    def _leave(self, conn: DeltaConnection) -> None:
        with self._lock:
            self.broadcaster.leave(conn.doc_id, conn._deliver)
            leave = self.deli.client_leave(conn.doc_id, conn.client_id)
            if leave is not None:
                self._publish(leave)

    def _broadcast_signal(self, sig: SignalMessage) -> None:
        """Fan a signal out to every connection on the document (including
        the sender — reference behavior: you see your own signals)."""
        for conn in list(self._connections.values()):
            if conn.connected and conn.doc_id == sig.doc_id:
                for fn in list(conn.signal_listeners):
                    fn(sig)

    # -------------------------------------------------------------- pipeline

    def _ingest(self, doc_id, client_id, client_seq, ref_seq, type, contents,
                address) -> None:
        p = partition_of(doc_id, self.raw_log.n_partitions)
        # trace context rides the raw-log record out of band of contents:
        # the deli consumer may run on another thread (or after a spill
        # replay), where the submitting thread's context is gone
        self.raw_log.append(p, dict(
            doc_id=doc_id, client_id=client_id, client_seq=client_seq,
            ref_seq=ref_seq, type=int(type), contents=contents,
            address=address, trace=tracing.current_wire()),
            epoch=self.writer_epoch)

    def _deli_consume(self, partition: int, offset: int, raw: dict) -> None:
        with self._lock:
            with tracing.span("deli.sequence", parent=raw.get("trace"),
                              doc=raw["doc_id"]) as sp:
                msg, nack = self.deli.sequence(
                    raw["doc_id"], raw["client_id"], raw["client_seq"],
                    raw["ref_seq"], MessageType(raw["type"]),
                    raw["contents"], raw.get("address"))
                if nack is not None:
                    sp.annotate(nacked=int(nack.reason))
                    if nack.reason == NackReason.DUPLICATE:
                        orig = self._acked.get(
                            (nack.doc_id, nack.client_id), {}
                        ).get(nack.client_seq)
                        if orig is not None:
                            # idempotent ack: the resubmitted op is
                            # durable at seq ``orig`` — ack it again
                            # with the original stamp, never re-sequence
                            nack.seq = orig
                            REGISTRY.inc("resubmit_dups_acked_total")
                            conn = self._connections.get(nack.client_id)
                            if conn is not None:
                                conn.dup_acks.append(nack)
                            return
                    self.nacks.append(nack)
                    conn = self._connections.get(nack.client_id)
                    if conn is not None:
                        conn.nacks.append(nack)
                    return
                sp.annotate(seq=msg.seq)
                # hand the deli span to downstream layers: broadcast /
                # storage / serving-apply spans parent under it
                if sp.ctx is not None:
                    msg.trace = sp.ctx.to_wire()
                self._publish(msg)
                # durable now (the deltas append returned): ledger the
                # (clientSeq → seq) mapping for idempotent dup-acks
                self._note_acked(msg)

    def _publish(self, msg: SequencedDocumentMessage) -> None:
        p = partition_of(msg.doc_id, self.deltas_log.n_partitions)
        self.deltas_log.append(p, msg, epoch=self.writer_epoch)

    def _note_acked(self, msg: SequencedDocumentMessage) -> None:
        """Record a durably-sequenced op in the dedup ledger (bounded per
        (doc, client); only types that consume a clientSeq matter)."""
        if msg.client_id < 0 or msg.type in (
                MessageType.NOOP, MessageType.CLIENT_JOIN,
                MessageType.CLIENT_LEAVE):
            return
        led = self._acked.setdefault(
            (msg.doc_id, msg.client_id), collections.OrderedDict())
        led[msg.client_seq] = msg.seq
        while len(led) > _DEDUP_WINDOW:
            led.popitem(last=False)

    def _deltas_consume(self, partition: int, offset: int,
                        msg: SequencedDocumentMessage) -> None:
        with tracing.span("serving.apply", parent=msg.trace,
                          doc=msg.doc_id, seq=msg.seq) as sp:
            # re-stamp: broadcast listeners (the client ack path, the
            # serving replica) parent under the apply span, not deli's
            if sp.ctx is not None:
                msg.trace = sp.ctx.to_wire()
            self.scriptorium.store(msg)
            ack = self.scribe.process(msg)
            self.broadcaster.publish(msg)
        if ack is not None:
            ack_type, contents = ack
            with self._lock:
                doc = self.deli._doc(msg.doc_id)
                doc.seq += 1
                service_msg = SequencedDocumentMessage(
                    doc_id=msg.doc_id, client_id=-1, client_seq=0,
                    ref_seq=doc.seq, seq=doc.seq, min_seq=doc.min_seq,
                    type=ack_type, contents=contents)
                self._publish(service_msg)

    # ----------------------------------------------------------- storage API

    def get_deltas(self, doc_id: str, from_seq: int = 0,
                   to_seq: Optional[int] = None):
        return self.scriptorium.get_deltas(doc_id, from_seq, to_seq)

    def upload_summary(self, doc_id: str, summary: dict, seq: int) -> str:
        return self.historian.upload_summary(doc_id, summary, seq)

    def latest_summary(self, doc_id: str):
        return self.historian.latest_summary(doc_id)

    # --------------------------------------------------------------- recovery

    @classmethod
    def recover(cls, spill_dir: str, n_partitions: int = 4) -> "LocalService":
        """Rebuild the full service from its JSONL spill after a crash —
        the durable-dedup path the reference service gets from Deli
        checkpoints + Kafka replay. Two steps:

        1. replay the durable deltas stream through ``deli.replay`` /
           scriptorium (sequencer counters — including every client's
           ``last_client_seq`` — and the catch-up store come back);
        2. wire the pipeline subscribers at the CURRENT offsets (no
           double-consumption of the replayed backlog).

        The raw-log backlog is deliberately NOT re-fed through the
        sequencer. A raw record whose sequencing the crash swallowed (a
        "burned" clientSeq: accepted, maybe sequenced in memory, never
        durable) looks recoverable — but re-feeding it here races the
        client's own recovery: a resilient client that resynced against
        the pre-crash instance has already RENUMBERED that op past
        ``last_client_seq`` and will resubmit it under the new number.
        Re-feeding the raw original would then sequence the same content
        twice under two clientSeqs — a double apply the dedup ledger
        cannot see. Un-acked ops are instead recovered by client
        resubmission (``drivers.resilient``); non-resilient clients may
        lose un-acked ops, which is the documented contract: an un-acked
        op may be dropped, but never corrupts.

        Every acked op survives (ack ⇒ durable in the deltas spill ⇒
        replayed in step 1) and no resubmit can double-apply (step 1
        restored the dedup state that guards it).
        """
        self = cls.__new__(cls)
        self.raw_log = PartitionedLog.recover(
            n_partitions, spill_dir, "rawdeltas")
        self.deltas_log = PartitionedLog.recover(
            n_partitions, spill_dir, "deltas")
        self.deli = DeliSequencer()
        self.broadcaster = Broadcaster()
        self.scriptorium = Scriptorium()
        self.historian = Historian()
        self.scribe = Scribe(self.historian)
        self._next_client = 1
        self._lock = threading.RLock()
        self.nacks = []
        self._connections = {}
        self._acked = {}
        self.epoch = self._bump_epoch(spill_dir)
        # takeover edge: advance both logs' fence words and adopt the new
        # epoch — if the crashed instance is somehow still live (a
        # supervisor double-start, the split-brain drill), its next
        # append raises FencedWriterError instead of extending the stream
        self.writer_epoch = max(self.raw_log.bump_fence(),
                                self.deltas_log.bump_fence())
        self.raw_log.fence(self.writer_epoch)
        self.deltas_log.fence(self.writer_epoch)
        self.deli.epoch = self.writer_epoch
        # 1) the durable deltas stream IS the recovery truth: global
        # (doc, seq) order mirrors _replay_tail's convention
        msgs: List[SequencedDocumentMessage] = []
        for p in range(n_partitions):
            msgs.extend(self.deltas_log.read(p))
        msgs.sort(key=lambda m: (m.doc_id, m.seq))
        for m in msgs:
            if m.client_id >= self._next_client:
                self._next_client = m.client_id + 1
            self.deli.replay(m)
            self.scriptorium.store(m)
            self._note_acked(m)
        # 2) subscribers from the current tail — the backlog was consumed
        # by its previous life
        for p in range(n_partitions):
            self.deltas_log.subscribe(
                p, self._deltas_consume, from_offset=self.deltas_log.size(p))
        # raw intake re-wired at the CURRENT tail only — see the
        # docstring for why the backlog must not be re-fed
        for p in range(n_partitions):
            self.raw_log.subscribe(
                p, self._deli_consume, from_offset=self.raw_log.size(p))
        REGISTRY.inc("service_recoveries_total")
        return self

    @staticmethod
    def _bump_epoch(spill_dir: str) -> int:
        """Monotone restart counter persisted beside the spill (clients
        compare epochs to detect a server restart behind a reconnect)."""
        from ..utils.atomicfile import atomic_write_json, read_json
        path = os.path.join(spill_dir, "epoch.json")
        try:
            epoch = int(read_json(path).get("epoch", 0)) + 1
        except (OSError, ValueError):
            epoch = 1
        atomic_write_json(path, {"epoch": epoch})
        return epoch

    # --------------------------------------------------------- fault testing

    def close(self) -> None:
        self.raw_log.close()
        self.deltas_log.close()

    def checkpoint(self) -> dict:
        return self.deli.checkpoint()

    def restart_sequencer(self, checkpoint: dict) -> None:
        """Simulate a Deli partition restart from its checkpoint."""
        with self._lock:
            self.deli = DeliSequencer.restore(checkpoint)

    def save_checkpoint(self, path: str) -> None:
        """Durable service checkpoint (sequencer state + both logs'
        offsets), written atomically (tmp + fsync + rename): a kill
        mid-write can never destroy the previous checkpoint. Recovery =
        ``restart_sequencer(load)`` + replaying the deltas log from the
        recorded offsets."""
        from ..utils.atomicfile import atomic_write_json
        with self._lock:
            atomic_write_json(path, {
                "deli": self.deli.checkpoint(),
                "raw_offsets": [self.raw_log.size(p) for p in
                                range(self.raw_log.n_partitions)],
                "deltas_offsets": [self.deltas_log.size(p) for p in
                                   range(self.deltas_log.n_partitions)],
            })

    @staticmethod
    def load_checkpoint(path: str) -> dict:
        from ..utils.atomicfile import read_json
        return read_json(path)
