"""DeltaManager: the client-side op pump and connection state machine.

Reference counterpart: ``DeltaManager`` + ``ConnectionManager`` in
``@fluidframework/container-loader`` (SURVEY.md §2.10, §3.1–3.3):

- **inbound**: sequenced ops from the live stream and from catch-up tail
  reads merge into one strictly-ordered queue (``DeltaQueue``); duplicates
  dropped, gaps back-filled from delta storage;
- **outbound**: local ops are stamped with the current reference sequence
  number and submitted on the active connection;
- **connection state machine**: disconnected → connecting → catching_up →
  connected, with reconnection on a nack;
- the sequenced echo of the client's own op is the *ack* (§1 data flow).
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, List, Optional

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..drivers.definitions import DocumentService
from .delta_queue import DeltaQueue


class ConnectionState(enum.Enum):
    DISCONNECTED = "disconnected"
    CONNECTING = "connecting"
    CATCHING_UP = "catching_up"
    CONNECTED = "connected"


class DeltaManager:
    def __init__(self, service: DocumentService):
        self.service = service
        self.state = ConnectionState.DISCONNECTED
        self.connection = None
        self.client_id: Optional[int] = None
        self._handler: Optional[Callable[[SequencedDocumentMessage], None]] = None
        self._inbound: Optional[DeltaQueue] = None
        self._listeners: Dict[str, List[Callable]] = {}

    # -------------------------------------------------------------- listeners

    def on(self, event: str, fn: Callable) -> None:
        self._listeners.setdefault(event, []).append(fn)

    def _emit(self, event: str, *args) -> None:
        for fn in self._listeners.get(event, []):
            fn(*args)

    # ------------------------------------------------------------- properties

    @property
    def last_sequence_number(self) -> int:
        return self._inbound.last_seq if self._inbound is not None else 0

    @property
    def connected(self) -> bool:
        return self.state == ConnectionState.CONNECTED

    # ----------------------------------------------------------------- wiring

    def attach_op_handler(self, handler: Callable[[SequencedDocumentMessage], None],
                          last_seq: int = 0) -> None:
        """Install the inbound handler starting after ``last_seq`` (the
        summary's sequence number on load) — reference:
        DeltaManager.attachOpHandler (§3.1)."""
        self._handler = handler
        self._inbound = DeltaQueue(handler, lambda m: m.seq,
                                   initial_seq=last_seq)

    @property
    def inbound(self) -> DeltaQueue:
        assert self._inbound is not None, "attach_op_handler first"
        return self._inbound

    # ------------------------------------------------------------- connection

    def connect(self) -> None:
        assert self._inbound is not None, "attach_op_handler before connect"
        if self.state != ConnectionState.DISCONNECTED:
            return
        self.state = ConnectionState.CONNECTING
        try:
            conn = self.service.connect_to_delta_stream()
        except Exception:
            self.state = ConnectionState.DISCONNECTED
            raise
        self.connection = conn
        self.client_id = conn.client_id
        self.state = ConnectionState.CATCHING_UP
        # live ops stream straight into the ordered inbound queue; the tail
        # read below fills anything we missed while disconnected — DeltaQueue
        # drops the overlap and orders the rest
        conn.on_op(self._inbound.push)
        conn.on_nack(self._on_nack)
        conn.on_signal(lambda sig: self._emit("signal", sig))
        self.catch_up()
        self.state = ConnectionState.CONNECTED
        self._emit("connected", self.client_id)

    def catch_up(self) -> None:
        """Back-fill the gap between last processed seq and the live stream
        via delta storage (reference: fetch op tail, §3.1)."""
        q = self._inbound
        for msg in self.service.delta_storage.get_deltas(q.last_seq):
            q.push(msg)
        # a gap can remain only if the storage read raced new live ops that
        # themselves raced ahead; re-read until the queue is gap-free
        while q.has_gap() is not None:
            before = q.last_seq
            for msg in self.service.delta_storage.get_deltas(q.last_seq):
                q.push(msg)
            if q.last_seq == before:
                break  # nothing new: the gap is in flight, live push fills it

    def disconnect(self, reason: str = "") -> None:
        if self.connection is not None:
            conn, self.connection = self.connection, None
            try:
                conn.disconnect()
            finally:
                self.client_id = None
        if self.state != ConnectionState.DISCONNECTED:
            self.state = ConnectionState.DISCONNECTED
            self._emit("disconnected", reason)

    def reconnect(self, reason: str = "") -> None:
        """Drop the current connection and establish a new one (new client
        id, fresh client-seq space — pending-op resubmit is the runtime's
        job via the 'connected' event)."""
        self.disconnect(reason)
        self.connect()

    def _on_nack(self, nack: Any) -> None:
        self._emit("nack", nack)
        # reference behavior: a nack forces reconnection; pending ops are
        # resubmitted (and rebased) by the runtime on the new connection
        self.reconnect(f"nack:{getattr(nack, 'reason', nack)}")

    # --------------------------------------------------------------- outbound

    def submit(self, contents: Any, type: MessageType = MessageType.OP,
               address: Optional[str] = None,
               ref_seq: Optional[int] = None) -> int:
        """Submit one op stamped with ``ref_seq``, the sequence number it
        was made against (None: the current one); returns its client
        sequence number."""
        assert self.connection is not None and self.connected, \
            "submit while disconnected (runtime should queue + resubmit)"
        if ref_seq is None:
            ref_seq = self.last_sequence_number
        return self.connection.submit(
            contents, type, ref_seq=ref_seq, address=address)

    def submit_signal(self, contents: Any) -> None:
        """Ephemeral broadcast (reference: submitSignal) — fire-and-forget,
        silently dropped while disconnected (signals are best-effort)."""
        if self.connection is not None and self.connected:
            self.connection.submit_signal(contents)

    def submit_noop(self) -> None:
        """Heartbeat: advances this client's refSeq (and thus the MSN)
        without consuming a client sequence number."""
        if self.connection is not None and self.connected:
            self.connection.submit(None, MessageType.NOOP,
                                   ref_seq=self.last_sequence_number)
