"""Container: document lifecycle — load, catch up, connect, process, close.

Reference counterpart: ``Loader`` / ``Container`` in
``@fluidframework/container-loader`` (SURVEY.md §2.10, §3.1): resolve a
document service, load the latest summary, initialize the protocol handler
(quorum + seq/minSeq from attributes), instantiate the runtime from the
summary, replay the op tail through the same path as live ops, then connect.

The runtime side is pluggable (reference: the code proposal / runtime
factory): ``runtime_factory(container, runtime_summary) -> runtime`` where
runtime exposes ``process(msg, local)`` and optionally
``set_connection_state(connected, client_id)`` and ``summarize()``.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, List, Optional

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..drivers.definitions import DocumentService, DocumentServiceFactory
from ..utils import tracing
from .delta_manager import DeltaManager
from .protocol import ProtocolHandler

RuntimeFactory = Callable[["Container", Optional[dict]], Any]

# message types routed to the runtime (everything passes the protocol
# handler first — SURVEY.md §3.2)
_RUNTIME_TYPES = (MessageType.OP, MessageType.SUMMARIZE,
                  MessageType.SUMMARY_ACK, MessageType.SUMMARY_NACK)


class ContainerState(enum.Enum):
    LOADING = "loading"
    LOADED = "loaded"
    CLOSED = "closed"


class Container:
    def __init__(self, service: DocumentService,
                 runtime_factory: RuntimeFactory):
        self.service = service
        self.state = ContainerState.LOADING
        self.protocol = ProtocolHandler()
        self.delta_manager = DeltaManager(service)
        self.base_seq = 0          # seq of the summary this container loaded
        self.runtime: Any = None
        self._runtime_factory = runtime_factory
        self._listeners: Dict[str, List[Callable]] = {}
        # every client id this container has held across reconnects (the
        # "is this op mine" set — see _process)
        self._my_client_ids: set = set()

    # -------------------------------------------------------------- listeners

    def on(self, event: str, fn: Callable) -> None:
        self._listeners.setdefault(event, []).append(fn)

    def _emit(self, event: str, *args) -> None:
        for fn in self._listeners.get(event, []):
            fn(*args)

    # ------------------------------------------------------------------- load

    @classmethod
    def load(cls, service: DocumentService,
             runtime_factory: RuntimeFactory,
             connect: bool = True) -> "Container":
        """Load from the latest summary + op tail (SURVEY.md §3.1)."""
        c = cls(service, runtime_factory)
        runtime_summary: Optional[dict] = None
        latest = service.summary_storage.get_latest_summary()
        if latest is not None:
            summary, seq = latest
            c.protocol = ProtocolHandler.load(summary.get("protocol") or {})
            runtime_summary = summary.get("runtime")
            c.base_seq = c.protocol.seq
            if c.base_seq != seq:
                # a summary whose protocol attributes disagree with its
                # handle seq cannot be resumed from — replaying the tail
                # against it would double-apply ops
                raise ValueError(
                    f"summary seq mismatch: protocol attributes say "
                    f"{c.base_seq}, summary handle says {seq}")
        c.delta_manager.attach_op_handler(c._process, last_seq=c.base_seq)
        c.runtime = runtime_factory(c, runtime_summary)
        c.delta_manager.on("connected", c._on_connected)
        c.delta_manager.on("disconnected", c._on_disconnected)
        c.delta_manager.on("signal", lambda sig: c._emit("signal", sig))
        c.state = ContainerState.LOADED
        if connect:
            c.connect()
        else:
            # offline catch-up: replay whatever the op store already has
            c.delta_manager.catch_up()
        return c

    # ------------------------------------------------------------- connection

    def connect(self) -> None:
        assert self.state == ContainerState.LOADED, "connect on closed container"
        self.delta_manager.connect()

    def disconnect(self, reason: str = "") -> None:
        self.delta_manager.disconnect(reason)

    @property
    def connected(self) -> bool:
        return self.delta_manager.connected

    @property
    def client_id(self) -> Optional[int]:
        return self.delta_manager.client_id

    @property
    def quorum(self):
        return self.protocol.quorum

    def _on_connected(self, client_id: int) -> None:
        self._my_client_ids.add(client_id)
        if self.runtime is not None and \
                hasattr(self.runtime, "set_connection_state"):
            self.runtime.set_connection_state(True, client_id)
        self._emit("connected", client_id)

    def _on_disconnected(self, reason: str) -> None:
        if self.runtime is not None and \
                hasattr(self.runtime, "set_connection_state"):
            self.runtime.set_connection_state(False, None)
        self._emit("disconnected", reason)

    # ---------------------------------------------------------------- inbound

    def _process(self, msg: SequencedDocumentMessage) -> None:
        self.protocol.process(msg)
        if msg.type in _RUNTIME_TYPES and self.runtime is not None:
            # "local" = submitted by THIS container on ANY of its
            # connections: after a reconnect, catch-up echoes of ops
            # submitted under the PREVIOUS client id must still ack the
            # pending records — judging by the current id alone would
            # resubmit already-sequenced ops and duplicate them for every
            # client (found by the network-driver e2e drill; the local
            # driver's synchronous acks never expose the race)
            local = msg.client_id in self._my_client_ids
            if local:
                # the batch's span tree closes here: the submitting
                # client processing its own sequenced echo IS the ack
                with tracing.span("ack", parent=msg.trace, seq=msg.seq):
                    self.runtime.process(msg, local)
            else:
                self.runtime.process(msg, local)
        self._emit("op", msg)

    # --------------------------------------------------------------- outbound

    def submit(self, contents: Any, type: MessageType = MessageType.OP,
               address: Optional[str] = None,
               ref_seq: Optional[int] = None) -> int:
        """Runtime-facing submit (reference: ContainerContext.submitFn);
        ``ref_seq`` is the seq the op was made against (None: now)."""
        return self.delta_manager.submit(contents, type, address, ref_seq)

    def submit_signal(self, contents: Any) -> None:
        """Ephemeral broadcast to currently-connected clients (reference:
        IContainer.submitSignal; listen via ``on("signal", fn)``)."""
        self.delta_manager.submit_signal(contents)

    def propose(self, key: str, value: Any) -> None:
        """Quorum proposal (accepted once MSN passes its seq)."""
        self.delta_manager.submit({"key": key, "value": value},
                                  MessageType.PROPOSAL)

    # ------------------------------------------------------------------ close

    def close(self) -> None:
        if self.state != ContainerState.CLOSED:
            self.disconnect("close")
            self.state = ContainerState.CLOSED
            self._emit("closed")


class Loader:
    """Resolve document ids to loaded containers (reference: Loader.resolve).

    The code-loader mapping of the reference (quorum code proposal →
    runtime factory) is collapsed to a single factory per Loader; the quorum
    proposal mechanism itself lives in ``protocol.Quorum``.
    """

    def __init__(self, factory: DocumentServiceFactory,
                 runtime_factory: RuntimeFactory):
        self.factory = factory
        self.runtime_factory = runtime_factory

    def resolve(self, doc_id: str, connect: bool = True) -> Container:
        service = self.factory.create_document_service(doc_id)
        return Container.load(service, self.runtime_factory, connect=connect)
