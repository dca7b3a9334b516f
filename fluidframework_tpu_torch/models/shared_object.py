"""SharedObject base plumbing + the channel factory plugin boundary.

Reference counterpart: ``@fluidframework/shared-object-base``
(``SharedObject``, ``process``/``submitLocalMessage``, attach/summarize
lifecycle) and the ``IChannelFactory``/``IChannel`` contracts in
``datastore-definitions`` — SURVEY.md §2.7. This registry is the DDS plugin
boundary: every channel type registers here.

A SharedObject is one replica of one distributed data structure. It can be
wired directly to a ``MockSequencer`` (tests), or routed through the container
runtime / datastore addressing (``runtime/``), which sets ``_submit_fn``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..core.protocol import MessageType, SequencedDocumentMessage


class SharedObject:
    """Base class for every DDS replica (reference: SharedObjectCore)."""

    # subclasses set this to their channel type, e.g.
    # "https://graph.microsoft.com/types/map"-style identifiers in the
    # reference; short stable strings here.
    TYPE: str = "base"

    def __init__(self, object_id: str, client_id: int):
        self.id = object_id
        self.client_id = client_id
        self.last_processed_seq = 0
        self._submit_fn: Optional[Callable[[dict], None]] = None
        self._attached = False
        self._listeners: Dict[str, list] = {}
        self._attributor = None  # opt-in (see attach_attributor)

    # ---------------------------------------------------------------- events
    # Reference: DDSes are EventEmitters (SharedMap "valueChanged"/"clear",
    # sequences "sequenceDelta"); undo-redo and app views subscribe here.

    def on(self, event: str, listener: Callable) -> Callable:
        """Subscribe; returns the listener for later ``off``."""
        self._listeners.setdefault(event, []).append(listener)
        return listener

    def off(self, event: str, listener: Callable) -> None:
        try:
            self._listeners.get(event, []).remove(listener)
        except ValueError:
            pass

    def _emit(self, event: str, *args) -> None:
        for listener in list(self._listeners.get(event, [])):
            listener(*args)

    # ------------------------------------------------------------- lifecycle

    def connect(self, submit_fn: Callable[[dict], None]) -> None:
        """Attach to an op channel; pending local state is (re)submitted by
        the runtime layer on reconnect, not here."""
        self._submit_fn = submit_fn
        self._attached = True

    def submit_local_message(self, contents: dict) -> None:
        if self._submit_fn is not None:
            self._submit_fn(contents)

    # -------------------------------------------------------------- op inbox

    def attach_attributor(self, attributor) -> None:
        """Record every sequenced op's (client, timestamp) by seq
        (reference: @fluid-experimental/attributor's op-stream wiring)."""
        self._attributor = attributor

    def apply_msg(self, msg: SequencedDocumentMessage) -> None:
        """Process one sequenced op (reference: SharedObject.process)."""
        assert msg.seq > self.last_processed_seq, "ops must arrive in seq order"
        if self._attributor is not None:
            self._attributor.record(msg)
        addressed_here = msg.address is None or msg.address == self.id
        if msg.type == MessageType.OP and msg.contents is not None \
                and addressed_here:
            self.process_core(msg, local=msg.client_id == self.client_id)
        self.last_processed_seq = msg.seq
        self.on_min_seq(msg.min_seq)

    def deliver(self, msg: SequencedDocumentMessage, local: bool) -> None:
        """Runtime-path delivery (datastore routing decided the address and
        locality). Unlike ``apply_msg``, equal sequence numbers are allowed:
        every op of a grouped batch shares its envelope's seq (§2.8)."""
        assert msg.seq >= self.last_processed_seq, "ops must arrive in seq order"
        self.process_core(msg, local)
        self.last_processed_seq = msg.seq
        self.on_min_seq(msg.min_seq)

    def rebase_op(self, contents: dict):
        """Rebase one pending local op for resubmission after reconnect
        (reference: SharedObject.reSubmit). Returns the contents to resend —
        unchanged by default, which is correct for position-independent ops
        (map/counter/register...); sequence DDSes override to re-resolve
        positions against the current state. Return None to drop the op, or
        a list when one op regenerates into several."""
        return contents

    def on_client_id_changed(self, new_client_id: int) -> None:
        """A reconnect assigned a new client id; channels with deeper
        client-id state (merge-tree segment stamps) override and re-stamp."""
        self.client_id = new_client_id

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        raise NotImplementedError

    def on_min_seq(self, min_seq: int) -> None:
        """Collaboration-window advance hook (zamboni etc.)."""

    # ------------------------------------------------------------- summaries

    def summarize(self) -> dict:
        raise NotImplementedError

    def load_core(self, summary: dict) -> None:
        raise NotImplementedError

    def load_from_summary(self, summary: dict, base_seq: int = 0) -> None:
        """Load state captured at sequence number ``base_seq`` (reference:
        the channel ``.attributes`` sequence number). Subsequent ops must
        carry seq > base_seq, and locally-submitted ops reference it — a
        summary's segments keep their original sequence stamps, so a
        perspective below base_seq cannot see them."""
        self.load_core(summary)
        self.last_processed_seq = base_seq
        self.on_loaded(base_seq)

    def on_loaded(self, base_seq: int) -> None:
        """Hook for subclasses holding inner sequence state (e.g. the
        merge-tree client mirror) to adopt the summary's base seq."""


class ChannelFactory:
    """Creates/loads one DDS type (reference: IChannelFactory)."""

    def __init__(self, type_name: str, cls):
        self.type = type_name
        self.cls = cls

    def create(self, object_id: str, client_id: int) -> SharedObject:
        return self.cls(object_id, client_id)

    def load(self, object_id: str, client_id: int, summary: dict,
             base_seq: int = 0) -> SharedObject:
        obj = self.cls(object_id, client_id)
        obj.load_from_summary(summary, base_seq)
        return obj


class ChannelRegistry:
    """The DDS plugin boundary (reference: ISharedObjectRegistry)."""

    def __init__(self):
        self._factories: Dict[str, ChannelFactory] = {}

    def register(self, factory: ChannelFactory) -> None:
        self._factories[factory.type] = factory

    def get(self, type_name: str) -> ChannelFactory:
        if type_name not in self._factories:
            raise KeyError(f"no channel factory registered for {type_name!r}")
        return self._factories[type_name]

    def types(self):
        return sorted(self._factories)


def default_registry() -> ChannelRegistry:
    """Registry with every DDS type this package has: SharedString,
    SharedMap and SharedDirectory. Any other type name (the matrix, the
    tree, the small DDSes) raises ``KeyError`` naming it."""
    from .shared_map import SharedMap, SharedDirectory
    from .shared_string import SharedString

    reg = ChannelRegistry()
    for cls in (SharedMap, SharedDirectory, SharedString):
        reg.register(ChannelFactory(cls.TYPE, cls))
    return reg
