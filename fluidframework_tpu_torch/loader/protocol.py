"""Protocol handler: quorum membership and proposals.

Reference counterpart: the protocol handler + ``Quorum`` in
``@fluidframework/container-loader`` (SURVEY.md §2.10, §3.1): tracks connected
clients (join/leave ops), document-level proposals (e.g. the code proposal),
and the (seq, minSeq) protocol state every summary captures. A proposal is
*accepted* once the MSN passes its sequence number — i.e. every connected
client has seen it (reference: Quorum approval rule).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.protocol import MessageType, SequencedDocumentMessage


@dataclasses.dataclass
class QuorumProposal:
    key: str
    value: Any
    seq: int                 # sequence number of the proposal op
    client_id: int
    accepted: bool = False


class Quorum:
    """Connected-client set + accepted document configuration."""

    def __init__(self):
        self.members: Dict[int, dict] = {}
        self._pending: List[QuorumProposal] = []
        self._accepted: Dict[str, QuorumProposal] = {}
        self._listeners: Dict[str, List[Callable]] = {}

    # -------------------------------------------------------------- listeners

    def on(self, event: str, fn: Callable) -> None:
        self._listeners.setdefault(event, []).append(fn)

    def _emit(self, event: str, *args) -> None:
        for fn in self._listeners.get(event, []):
            fn(*args)

    # ---------------------------------------------------------------- queries

    def get(self, key: str, default: Any = None) -> Any:
        p = self._accepted.get(key)
        return p.value if p is not None else default

    def has(self, key: str) -> bool:
        return key in self._accepted

    @property
    def pending(self) -> List[QuorumProposal]:
        return list(self._pending)

    # ------------------------------------------------------------- op intake

    def add_member(self, client_id: int, details: Optional[dict] = None) -> None:
        self.members[client_id] = details or {}
        self._emit("addMember", client_id)

    def remove_member(self, client_id: int) -> None:
        if client_id in self.members:
            del self.members[client_id]
            self._emit("removeMember", client_id)

    def add_proposal(self, key: str, value: Any, seq: int,
                     client_id: int) -> None:
        self._pending.append(QuorumProposal(key, value, seq, client_id))

    def advance_min_seq(self, min_seq: int) -> None:
        """Accept every pending proposal whose seq the MSN has passed."""
        still: List[QuorumProposal] = []
        for p in self._pending:
            if p.seq <= min_seq:
                p.accepted = True
                self._accepted[p.key] = p
                self._emit("approveProposal", p)
            else:
                still.append(p)
        self._pending = still

    # ------------------------------------------------------------- snapshots

    def snapshot(self) -> dict:
        return {
            "members": {str(cid): d for cid, d in self.members.items()},
            "accepted": {k: {"value": p.value, "seq": p.seq,
                             "clientId": p.client_id}
                         for k, p in self._accepted.items()},
            "pending": [{"key": p.key, "value": p.value, "seq": p.seq,
                         "clientId": p.client_id} for p in self._pending],
        }

    @classmethod
    def load(cls, snap: dict) -> "Quorum":
        q = cls()
        for cid, d in snap.get("members", {}).items():
            q.members[int(cid)] = d
        for k, pd in snap.get("accepted", {}).items():
            p = QuorumProposal(k, pd["value"], pd["seq"], pd["clientId"],
                               accepted=True)
            q._accepted[k] = p
        for pd in snap.get("pending", []):
            q._pending.append(QuorumProposal(
                pd["key"], pd["value"], pd["seq"], pd["clientId"]))
        return q


class ProtocolHandler:
    """Document-level protocol state: seq / minSeq counters + quorum.

    Every inbound sequenced message passes through here before the runtime
    (SURVEY.md §3.2: Container.processRemoteMessage → ProtocolHandler).
    """

    def __init__(self, quorum: Optional[Quorum] = None,
                 seq: int = 0, min_seq: int = 0):
        self.quorum = quorum if quorum is not None else Quorum()
        self.seq = seq
        self.min_seq = min_seq

    def process(self, msg: SequencedDocumentMessage) -> None:
        assert msg.seq == self.seq + 1, \
            f"protocol seq gap: have {self.seq}, got {msg.seq}"
        self.seq = msg.seq
        if msg.type == MessageType.CLIENT_JOIN:
            self.quorum.add_member(msg.contents["clientId"],
                                   (msg.contents or {}).get("details"))
        elif msg.type == MessageType.CLIENT_LEAVE:
            self.quorum.remove_member(msg.contents["clientId"])
        elif msg.type == MessageType.PROPOSAL:
            self.quorum.add_proposal(
                msg.contents["key"], msg.contents["value"], msg.seq,
                msg.client_id)
        if msg.min_seq > self.min_seq:
            self.min_seq = msg.min_seq
            self.quorum.advance_min_seq(self.min_seq)

    # -------------------------------------------------------------- snapshots

    def attributes(self) -> dict:
        """The protocol attributes blob every summary carries
        (reference: .protocol/attributes in the summary tree)."""
        return {"sequenceNumber": self.seq,
                "minimumSequenceNumber": self.min_seq}

    def snapshot(self) -> dict:
        return {"attributes": self.attributes(),
                "quorum": self.quorum.snapshot()}

    @classmethod
    def load(cls, snap: dict) -> "ProtocolHandler":
        attrs = snap.get("attributes", {})
        return cls(quorum=Quorum.load(snap.get("quorum", {})),
                   seq=attrs.get("sequenceNumber", 0),
                   min_seq=attrs.get("minimumSequenceNumber", 0))
