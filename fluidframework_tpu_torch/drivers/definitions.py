"""Driver contracts: how a client talks to an ordering/storage service.

Reference counterpart: ``@fluidframework/driver-definitions`` —
``IDocumentService``, ``IDocumentDeltaConnection``, ``IDocumentStorageService``,
``IDocumentDeltaStorageService`` and ``IDocumentServiceFactory``
(SURVEY.md §1 L1, §2.12; mount empty). A driver adapts one backend (local
in-proc service, recorded file, replay stream) to these three capabilities:

- **delta stream** — a live ordered connection: submit raw ops, receive the
  sequenced broadcast;
- **delta storage** — range reads of already-sequenced ops (catch-up tail);
- **summary storage** — upload/download of summary trees (snapshots).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from ..core.protocol import (
    MessageType, SequencedDocumentMessage, SignalMessage,
)


class DeltaStreamConnection:
    """A live, ordered delta-stream connection for one client to one document
    (reference: IDocumentDeltaConnection)."""

    client_id: int
    connected: bool

    def submit(self, contents: Any, type: MessageType = MessageType.OP,
               ref_seq: int = 0, address: Optional[str] = None) -> int:
        """Submit one raw op; returns the client sequence number stamped on
        it (NOOPs consume no client seq)."""
        raise NotImplementedError

    def on_op(self, fn: Callable[[SequencedDocumentMessage], None]) -> None:
        """Register a listener for the sequenced broadcast stream."""
        raise NotImplementedError

    def on_nack(self, fn: Callable[[Any], None]) -> None:
        """Register a listener for nacks addressed to this client."""
        raise NotImplementedError

    def submit_signal(self, contents: Any) -> None:
        """Broadcast an ephemeral signal (reference:
        IDocumentDeltaConnection.submitSignal): no sequencing, no storage,
        delivered only to currently-connected clients."""
        raise NotImplementedError

    def on_signal(self, fn: Callable[[SignalMessage], None]) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        raise NotImplementedError


class DeltaStorageService:
    """Range reads over the sequenced-op store (reference:
    IDocumentDeltaStorageService; served by Scriptorium's op log)."""

    def get_deltas(self, from_seq: int = 0, to_seq: Optional[int] = None
                   ) -> List[SequencedDocumentMessage]:
        """Sequenced ops with ``from_seq < seq`` and, if given,
        ``seq <= to_seq`` — the catch-up tail read."""
        raise NotImplementedError


class SummaryStorageService:
    """Summary (snapshot) storage (reference: IDocumentStorageService over
    Historian/Gitrest's git-like tree API)."""

    def get_latest_summary(self) -> Optional[Tuple[dict, int]]:
        """(summary_tree, seq) of the newest accepted summary, or None."""
        raise NotImplementedError

    def upload_summary(self, summary: dict, seq: int) -> str:
        """Store a summary tree captured at ``seq``; returns its handle."""
        raise NotImplementedError


class DocumentService:
    """Everything a loaded container needs from the service for one document
    (reference: IDocumentService)."""

    doc_id: str

    def connect_to_delta_stream(self) -> DeltaStreamConnection:
        raise NotImplementedError

    @property
    def delta_storage(self) -> DeltaStorageService:
        raise NotImplementedError

    @property
    def summary_storage(self) -> SummaryStorageService:
        raise NotImplementedError


class DocumentServiceFactory:
    """Resolves a document id to a DocumentService (reference:
    IDocumentServiceFactory + url resolver, collapsed: our "urls" are ids)."""

    def create_document_service(self, doc_id: str) -> DocumentService:
        raise NotImplementedError
