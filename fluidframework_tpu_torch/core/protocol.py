"""Wire/op message types (reference: ``@fluidframework/protocol-definitions``).

Host-side representation used by the sequencer and the serving engine. The
device never sees these objects: ops are packed into int32 planes with
variable-length payloads kept in host tables and referenced by handle.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class MessageType(enum.IntEnum):
    """Op type at the protocol layer."""

    OP = 0            # runtime-level operation
    NOOP = 1          # heartbeat carrying referenceSequenceNumber (advances MSN)
    CLIENT_JOIN = 2
    CLIENT_LEAVE = 3
    PROPOSAL = 4
    SUMMARIZE = 5
    SUMMARY_ACK = 6
    SUMMARY_NACK = 7
    REJOIN = 8


class ColumnarWireKind(enum.IntEnum):
    """Op kind codes of the columnar front door's 16-byte op records
    (``server/columnar_ingress.py``). These are WIRE codes: they coincide
    with ``ops.schema.OpKind``'s plane codes today, and the separate enum
    keeps the wire contract explicit.

    INSERT inserts ``texts[tidx]`` at a0; REMOVE removes [a0, a1);
    ANNOTATE applies the single-key ``props[tidx]`` dict over [a0, a1)
    (rich ``R`` frames only; plain ``B`` frames reject it)."""

    INSERT = 0
    REMOVE = 1
    ANNOTATE = 2


@dataclasses.dataclass
class SignalMessage:
    """An ephemeral, non-sequenced broadcast (reference: ISignalMessage):
    it fans out to the connected clients at once, carries no seq and is
    never stored."""

    doc_id: str
    client_id: int
    contents: Any = None


@dataclasses.dataclass
class SequencedDocumentMessage:
    """A sequenced op as broadcast to all clients (reference:
    ISequencedDocumentMessage): ``seq`` is the per-document total order,
    ``min_seq`` the collaboration-window floor used for zamboni."""

    doc_id: str
    client_id: int
    client_seq: int
    ref_seq: int
    seq: int
    min_seq: int
    type: MessageType
    contents: Any = None
    metadata: Optional[dict] = None
    address: Optional[str] = None
    timestamp: Optional[float] = None
    # trace context of the submitting batch ({"tid", "sid"}), None when
    # untraced; kept so a spilled message has the JAX package's fields
    trace: Optional[dict] = None

    def is_from(self, client_id: int) -> bool:
        return self.client_id == client_id
