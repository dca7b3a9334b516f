"""Deli: the sequencer lambda — per-document total-order stamping.

Reference counterpart: ``DeliLambda`` in ``server/routerlicious``: consumes
raw client ops, stamps monotone sequence numbers and the minimum sequence
number (MSN), dedupes by (clientId, clientSeqNumber), nacks gaps and
unknown clients, and tracks join/leave.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, Optional, Tuple

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..utils.atomicfile import atomic_write_json, read_json


class NackReason(enum.IntEnum):
    UNKNOWN_CLIENT = 0
    CLIENT_SEQ_GAP = 1      # clientSeq jumped forward: lost op
    DUPLICATE = 2           # clientSeq replayed (at-least-once ingress): drop
    REF_SEQ_BELOW_MSN = 3   # op referenced state below the collab window
    MALFORMED = 4           # op contents rejected before sequencing
    CAPACITY = 5            # engine capacity (docs/keys) exhausted


@dataclasses.dataclass
class Nack:
    doc_id: str
    client_id: int
    client_seq: int
    reason: NackReason
    #: original seq of an idempotently re-acked DUPLICATE (-1 = unknown)
    seq: int = -1


@dataclasses.dataclass
class _ClientState:
    last_client_seq: int = 0
    ref_seq: int = 0


@dataclasses.dataclass
class _DocState:
    seq: int = 0
    min_seq: int = 0
    clients: Dict[int, _ClientState] = dataclasses.field(default_factory=dict)

    def compute_msn(self) -> int:
        if not self.clients:
            # no connected clients: window closes at the current seq
            return max(self.min_seq, self.seq)
        msn = min(c.ref_seq for c in self.clients.values())
        return max(self.min_seq, msn)  # MSN is monotone


class DeliSequencer:
    """Sequencer for the documents of one partition."""

    def __init__(self, clock=None):
        self._docs: Dict[str, _DocState] = {}
        self.clock = clock if clock is not None else time.time
        # writer epoch this sequencer's stream is stamped under: set by
        # the owning engine from its log's fence word (at construction
        # and on acquire_write_authority). Deliberately NOT part of
        # checkpoint(): the fence word's source of truth is the log's
        # persisted fence file, never a checkpoint that may be stale.
        self.epoch = 0

    def _doc(self, doc_id: str) -> _DocState:
        if doc_id not in self._docs:
            self._docs[doc_id] = _DocState()
        return self._docs[doc_id]

    def client_join(self, doc_id: str, client_id: int
                    ) -> SequencedDocumentMessage:
        doc = self._doc(doc_id)
        doc.clients[client_id] = _ClientState(ref_seq=doc.seq)
        doc.seq += 1
        doc.min_seq = doc.compute_msn()
        return SequencedDocumentMessage(
            doc_id=doc_id, client_id=client_id, client_seq=0,
            ref_seq=doc.seq - 1, seq=doc.seq, min_seq=doc.min_seq,
            type=MessageType.CLIENT_JOIN, contents={"clientId": client_id})

    def is_member(self, doc_id: str, client_id: int) -> bool:
        """Whether ``client_id`` holds a seat on ``doc_id`` (a resumed
        session must not re-join a seated client: ``client_join`` resets
        ``last_client_seq`` and would re-open the dedup window)."""
        doc = self._docs.get(doc_id)
        return doc is not None and client_id in doc.clients

    def last_client_seq(self, doc_id: str, client_id: int) -> int:
        """The highest clientSeq accepted from this client on this doc (0
        when unknown): a resyncing client renumbers its pending ops past
        it."""
        doc = self._docs.get(doc_id)
        if doc is None:
            return 0
        client = doc.clients.get(client_id)
        return client.last_client_seq if client is not None else 0

    def client_leave(self, doc_id: str, client_id: int
                     ) -> Optional[SequencedDocumentMessage]:
        doc = self._doc(doc_id)
        if client_id not in doc.clients:
            return None
        del doc.clients[client_id]
        doc.seq += 1
        doc.min_seq = doc.compute_msn()
        return SequencedDocumentMessage(
            doc_id=doc_id, client_id=client_id, client_seq=0, ref_seq=doc.seq,
            seq=doc.seq, min_seq=doc.min_seq,
            type=MessageType.CLIENT_LEAVE, contents={"clientId": client_id})

    def sequence(self, doc_id: str, client_id: int, client_seq: int,
                 ref_seq: int, type: MessageType, contents: Any,
                 address: Optional[str] = None
                 ) -> Tuple[Optional[SequencedDocumentMessage], Optional[Nack]]:
        """Stamp one raw op. Returns (message, None) or (None, nack).
        NOOP heartbeats advance the client's refSeq (and thus MSN) without
        consuming a clientSeq."""
        doc = self._doc(doc_id)
        client = doc.clients.get(client_id)
        if client is None:
            return None, Nack(doc_id, client_id, client_seq,
                              NackReason.UNKNOWN_CLIENT)
        if type != MessageType.NOOP:
            expected = client.last_client_seq + 1
            if client_seq < expected:
                return None, Nack(doc_id, client_id, client_seq,
                                  NackReason.DUPLICATE)
            if client_seq > expected:
                return None, Nack(doc_id, client_id, client_seq,
                                  NackReason.CLIENT_SEQ_GAP)
        if ref_seq < doc.min_seq:
            return None, Nack(doc_id, client_id, client_seq,
                              NackReason.REF_SEQ_BELOW_MSN)
        # a client cannot have seen the future: clamp ref_seq to doc seq
        ref_seq = min(ref_seq, doc.seq)
        if type != MessageType.NOOP:
            client.last_client_seq = client_seq
        client.ref_seq = max(client.ref_seq, ref_seq)
        doc.seq += 1
        doc.min_seq = doc.compute_msn()
        msg = SequencedDocumentMessage(
            doc_id=doc_id, client_id=client_id, client_seq=client_seq,
            ref_seq=ref_seq, seq=doc.seq, min_seq=doc.min_seq, type=type,
            contents=contents, address=address, timestamp=self.clock())
        return msg, None

    def doc_seq(self, doc_id: str) -> int:
        return self._doc(doc_id).seq

    # ---------------------------------------------------------- checkpoints

    def checkpoint(self) -> dict:
        """Serialisable sequencer state, in the JAX package's layout (so a
        checkpoint taken by either package restores in the other)."""
        return {
            doc_id: {
                "seq": d.seq,
                "minSeq": d.min_seq,
                "clients": {str(cid): [c.last_client_seq, c.ref_seq]
                            for cid, c in d.clients.items()},
            }
            for doc_id, d in self._docs.items()
        }

    @classmethod
    def restore(cls, snapshot: dict, clock=None) -> "DeliSequencer":
        deli = cls(clock)
        for doc_id, d in snapshot.items():
            doc = _DocState(seq=d["seq"], min_seq=d["minSeq"])
            for cid, (lcs, rs) in d["clients"].items():
                doc.clients[int(cid)] = _ClientState(lcs, rs)
            deli._docs[doc_id] = doc
        return deli

    def save_checkpoint(self, path: str) -> None:
        """Durable checkpoint: tmp + fsync + rename, so a kill mid-write
        never destroys the previous one."""
        atomic_write_json(path, self.checkpoint())

    @classmethod
    def load_checkpoint(cls, path: str, clock=None) -> "DeliSequencer":
        return cls.restore(read_json(path), clock=clock)

    def replay(self, msg: SequencedDocumentMessage) -> None:
        """Re-apply an already-sequenced message (log-tail replay after a
        restore from an older checkpoint): the counters must advance past
        every sequenced op, or the resumed sequencer would re-issue seqs."""
        doc = self._doc(msg.doc_id)
        if msg.type == MessageType.CLIENT_JOIN:
            doc.clients[msg.client_id] = _ClientState(ref_seq=msg.ref_seq)
        elif msg.type == MessageType.CLIENT_LEAVE:
            doc.clients.pop(msg.client_id, None)
        else:
            client = doc.clients.get(msg.client_id)
            if client is not None:
                if msg.type != MessageType.NOOP:
                    client.last_client_seq = max(client.last_client_seq,
                                                 msg.client_seq)
                client.ref_seq = max(client.ref_seq, msg.ref_seq)
        doc.seq = max(doc.seq, msg.seq)
        doc.min_seq = max(doc.min_seq, msg.min_seq)
