"""Mock in-memory sequencer for multi-client tests without a server.

Reference counterpart: ``@fluidframework/test-runtime-utils``
``MockContainerRuntimeFactory`` / ``MockFluidDataStoreRuntime`` (SURVEY.md §4):
create N replicas in one process, interleave local edits, then
``process_all_messages()`` to simulate the ordering service deterministically —
multi-client convergence testing with no server and no async. This is THE
pattern the kernel-vs-oracle fuzz tests are built on.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

from ..core.protocol import MessageType, SequencedDocumentMessage


class MockSequencer:
    """Deterministic Deli stand-in: stamps seq / minSeq, broadcasts in order.

    Replicas register with ``connect``; a replica is any object exposing
    ``client_id``, ``last_processed_seq`` and ``apply_msg(msg)`` (e.g.
    ``SequenceClient``, DDS kernels, or whole mock runtimes).
    """

    def __init__(self, doc_id: str = "doc"):
        self.doc_id = doc_id
        self.seq = 0
        self._queue: collections.deque = collections.deque()
        self._replicas: List[Any] = []
        self._client_ref_seq: Dict[int, int] = {}
        self._next_client_id = 1
        self._sequenced_listeners: List[Callable[
            [SequencedDocumentMessage], None]] = []

    # ------------------------------------------------------------ membership

    def connect(self, replica: Any) -> None:
        self._replicas.append(replica)
        self._client_ref_seq[replica.client_id] = self.seq
        # a bare SharedObject (has the submit plumbing but nothing wired)
        # gets its outbound channel attached here too, so tests can write
        # `seqr.connect(dds)` and have the full loop — matching the
        # reference's MockContainerRuntimeFactory.createContainerRuntime
        # which wires both directions in one call
        if getattr(replica, "_submit_fn", False) is None \
                and hasattr(replica, "connect"):
            replica.connect(lambda contents, r=replica:
                            self.submit(r, contents))

    def disconnect(self, replica: Any) -> None:
        self._replicas.remove(replica)
        self._client_ref_seq.pop(replica.client_id, None)

    def allocate_client_id(self) -> int:
        cid = self._next_client_id
        self._next_client_id += 1
        return cid

    def on_sequenced(
            self, cb: Callable[[SequencedDocumentMessage], None]) -> None:
        """Subscribe to the sequenced stream (Broadcaster-tap analog):
        ``cb`` is invoked with every stamped message, after replica
        delivery — lets tests capture the exact wire stream a serving
        engine / device store would consume."""
        self._sequenced_listeners.append(cb)

    # ----------------------------------------------------------- op pipeline

    def submit(self, replica: Any, contents: Any,
               type: MessageType = MessageType.OP,
               client_seq: Optional[int] = None) -> None:
        """Queue an op; ref_seq is captured at submit time, like the real
        outbox (reference: ContainerRuntime.submit → DeltaManager outbound)."""
        self._queue.append(dict(
            client_id=replica.client_id,
            client_seq=client_seq if client_seq is not None
            else contents.get("clientSeq", 0) if isinstance(contents, dict)
            else 0,
            ref_seq=replica.last_processed_seq,
            type=type,
            contents=contents,
            address=getattr(replica, "id", None),
        ))

    @property
    def outstanding(self) -> int:
        return len(self._queue)

    def _min_seq(self) -> int:
        if not self._client_ref_seq:
            return self.seq
        return min(self._client_ref_seq.values())

    def process_one(self) -> Optional[SequencedDocumentMessage]:
        """Sequence the oldest submitted op and deliver it to every replica
        (reference: Deli stamp → Broadcaster fan-out, SURVEY.md §3.5)."""
        if not self._queue:
            return None
        raw = self._queue.popleft()
        self.seq += 1
        self._client_ref_seq[raw["client_id"]] = raw["ref_seq"]
        msg = SequencedDocumentMessage(
            doc_id=self.doc_id,
            client_id=raw["client_id"],
            client_seq=raw["client_seq"],
            ref_seq=raw["ref_seq"],
            seq=self.seq,
            min_seq=self._min_seq(),
            type=raw["type"],
            contents=raw["contents"],
            address=raw.get("address"),
            # deterministic service timestamp: one tick per sequenced op
            timestamp=float(self.seq),
        )
        for replica in list(self._replicas):
            replica.apply_msg(msg)
        for cb in self._sequenced_listeners:
            cb(msg)
        return msg

    def process_some(self, n: int) -> int:
        done = 0
        for _ in range(n):
            if self.process_one() is None:
                break
            done += 1
        return done

    def process_all_messages(self) -> int:
        return self.process_some(len(self._queue))


def create_connected_dds(seqr: MockSequencer, cls, object_id: str = "dds"):
    """One replica of ``cls`` wired to the mock sequencer (the
    MockFluidDataStoreRuntime-style shortcut for DDS-level tests)."""
    obj = cls(object_id, seqr.allocate_client_id())
    seqr.connect(obj)
    obj.connect(lambda contents: seqr.submit(obj, contents))
    return obj
