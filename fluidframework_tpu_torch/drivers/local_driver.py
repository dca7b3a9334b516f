"""Local driver: the in-process ordering service behind the driver contracts.

Reference counterpart: ``@fluidframework/local-driver`` +
``LocalDeltaConnectionServer`` (SURVEY.md §2.12, §4): full loader/runtime
stacks in one process against the real sequencing pipeline
(``server.tinylicious.LocalService``), deterministic, for integration tests
and local development.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..server.tinylicious import LocalService
from ..utils import tracing
from . import definitions as defs


class LocalDeltaStreamConnection(defs.DeltaStreamConnection):
    def __init__(self, service: LocalService, doc_id: str):
        self._conn = service.connect(doc_id)
        self._nack_listeners: List[Callable[[Any], None]] = []
        self._nacks_seen = 0

    @property
    def client_id(self) -> int:
        return self._conn.client_id

    @property
    def connected(self) -> bool:
        return self._conn.connected

    def submit(self, contents: Any, type: MessageType = MessageType.OP,
               ref_seq: int = 0, address: Optional[str] = None) -> int:
        # wire span: zero serialization here, but the span keeps the tree
        # shape identical to the socket driver's (outbox → wire → deli)
        with tracing.span("wire.submit"):
            client_seq = self._conn.submit(contents, type, ref_seq, address)
        # the local pipeline is synchronous: a nack produced by this submit
        # is already recorded on the connection — deliver it now (a socket
        # driver would push it asynchronously instead)
        self._drain_nacks()
        return client_seq

    def _drain_nacks(self) -> None:
        while self._nacks_seen < len(self._conn.nacks):
            nack = self._conn.nacks[self._nacks_seen]
            self._nacks_seen += 1
            for fn in list(self._nack_listeners):
                fn(nack)

    def on_op(self, fn: Callable[[SequencedDocumentMessage], None]) -> None:
        self._conn.on_op(fn)

    def on_nack(self, fn: Callable[[Any], None]) -> None:
        self._nack_listeners.append(fn)

    def submit_signal(self, contents: Any) -> None:
        self._conn.submit_signal(contents)

    def on_signal(self, fn) -> None:
        self._conn.on_signal(fn)

    def disconnect(self) -> None:
        self._conn.disconnect()


class LocalDeltaStorage(defs.DeltaStorageService):
    def __init__(self, service: LocalService, doc_id: str):
        self._service = service
        self._doc_id = doc_id

    def get_deltas(self, from_seq: int = 0, to_seq: Optional[int] = None
                   ) -> List[SequencedDocumentMessage]:
        return self._service.get_deltas(self._doc_id, from_seq, to_seq)


class LocalSummaryStorage(defs.SummaryStorageService):
    def __init__(self, service: LocalService, doc_id: str):
        self._service = service
        self._doc_id = doc_id

    def get_latest_summary(self) -> Optional[Tuple[dict, int]]:
        summary, seq, _sha = self._service.latest_summary(self._doc_id)
        if summary is None:
            return None
        return summary, seq

    def upload_summary(self, summary: dict, seq: int) -> str:
        return self._service.upload_summary(self._doc_id, summary, seq)


class LocalDocumentService(defs.DocumentService):
    def __init__(self, service: LocalService, doc_id: str):
        self.doc_id = doc_id
        self._service = service
        self._delta_storage = LocalDeltaStorage(service, doc_id)
        self._summary_storage = LocalSummaryStorage(service, doc_id)

    def connect_to_delta_stream(self) -> LocalDeltaStreamConnection:
        return LocalDeltaStreamConnection(self._service, self.doc_id)

    @property
    def delta_storage(self) -> LocalDeltaStorage:
        return self._delta_storage

    @property
    def summary_storage(self) -> LocalSummaryStorage:
        return self._summary_storage


class LocalDocumentServiceFactory(defs.DocumentServiceFactory):
    def __init__(self, service: Optional[LocalService] = None):
        self.service = service if service is not None else LocalService()

    def create_document_service(self, doc_id: str) -> LocalDocumentService:
        return LocalDocumentService(self.service, doc_id)
