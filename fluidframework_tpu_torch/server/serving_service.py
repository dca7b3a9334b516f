"""ServingLocalService: tinylicious + a device-merged server replica.

The missing piece between the two halves of the system: ``LocalService``
runs the full client-facing ordering pipeline (Alfred → Deli → broadcast /
storage, SURVEY.md §1), and the serving engines merge raw DDS streams on
device — but the reference's production story is interactive clients on the
FULL container stack (loader → container runtime → DDS, with outbox
grouping/compression on the wire) against a service that also holds merged
state. This service closes that loop: it consumes its own sequenced delta
stream through ``RemoteMessageProcessor`` (ungroup → decompress →
unwrap the ``/dataStoreId/channelId`` envelopes, §3.2), routes every
SharedString channel's merge-tree ops into the batched ``TensorStringStore``
kernel, and serves server-side reads (``read_text``/``get_properties``)
without any client in the loop — the north star's serving replica fed by
real container traffic.

Counterpart of ``fluidframework_tpu/server/serving_service.py``. The
replica's store lives on ``device`` (the card by default; ``"cpu"`` runs
the plain version): every ``flush_replica`` is one
``TensorStringStore.apply_messages``, which launches the hand kernel B1
(``csrc/string_apply.cu``) once an op window, and ``compact_replica`` runs
the store's compaction. The ops-plane gauge ticker waits with
``LocalService.start_ops``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..ops.string_store import TensorStringStore
from ..runtime.remote_message_processor import RemoteMessageProcessor
from ..utils import tracing
from ..utils.telemetry import MetricsCollector, REGISTRY, TelemetryLogger
from .tinylicious import LocalService


class ServingLocalService(LocalService):
    """LocalService whose sequenced stream also feeds a device replica of
    every string channel, keyed by (doc, datastore, channel) → store row."""

    def __init__(self, n_docs: int = 64, capacity: int = 1024,
                 n_props: int = 8, batch_window: int = 64,
                 compact_every: int = 16, n_partitions: int = 4,
                 spill_dir: Optional[str] = None, device="cuda"):
        # the store first: without a card it raises before any log opens
        self.store = TensorStringStore(n_docs, capacity, n_props,
                                       device=device)
        super().__init__(n_partitions, spill_dir)
        self.n_docs = n_docs
        self.batch_window = batch_window
        self.compact_every = compact_every
        self._rmp: Dict[str, RemoteMessageProcessor] = {}
        self._rows: Dict[Tuple[str, str, str], int] = {}
        self._row_doc: Dict[int, str] = {}
        self._replica_queue: list = []
        self._doc_min_seq: Dict[str, int] = {}
        self._flushes_since_compact = 0
        self.metrics = MetricsCollector()
        REGISTRY.attach("servingService", self.metrics)
        self.telemetry = TelemetryLogger(None, "servingService")
        # health-plane rollup: one labeled collector per deltas
        # partition — per-partition consume lag/volume becomes its own
        # Prometheus series instead of folding into the service blob
        self.partition_metrics = []
        for p in range(self.deltas_log.n_partitions):
            coll = MetricsCollector()
            REGISTRY.attach("servingService", coll,
                            labels={"partition": p})
            self.partition_metrics.append(coll)
        # channels the replica could NOT admit (store rows exhausted):
        # the ordering service still serves them — only device reads are
        # degraded — but the degradation must be VISIBLE, not silent
        self._dropped_channels: set = set()
        # subscribe the replica AFTER the parent wired its lambdas, so
        # broadcast/storage see each message first (same offset order)
        for p in range(self.deltas_log.n_partitions):
            self.deltas_log.subscribe(p, self._replica_consume)

    # ------------------------------------------------------------- consume

    def _row(self, doc_id: str, ds: str, channel: str) -> Optional[int]:
        key = (doc_id, ds, channel)
        if key not in self._rows:
            if len(self._rows) >= self.n_docs:
                # replica full: the channel is not served from the device
                # replica (ordering/broadcast are unaffected). Count every
                # shed op, warn once per channel: a shed that returned None
                # with no trace would be a silent degradation.
                self.metrics.inc("replica_ops_dropped")
                # canonical shed counter (default SLO holds it at zero:
                # replica-full shedding must page, not just warn once)
                self.metrics.inc("replica_sheds_total")
                if key not in self._dropped_channels:
                    self._dropped_channels.add(key)
                    self.metrics.inc("replica_channels_dropped")
                    self.telemetry.send_warning(
                        "replicaChannelDropped", doc_id=doc_id,
                        datastore=ds, channel=channel,
                        capacity=self.n_docs)
                return None
            self._rows[key] = len(self._rows)
            self._row_doc[self._rows[key]] = doc_id
        return self._rows[key]

    def dropped_channels(self):
        """(doc, datastore, channel) keys shed because the replica was
        full — the operator-facing view of serving degradation."""
        return sorted(self._dropped_channels)

    def _replica_consume(self, partition: int, offset: int,
                         msg: SequencedDocumentMessage) -> None:
        pm = self.partition_metrics[partition]
        pm.inc("ops_consumed")
        pm.set_gauge("consumed_offset", offset)
        self._doc_min_seq[msg.doc_id] = max(
            self._doc_min_seq.get(msg.doc_id, 0), msg.min_seq)
        if msg.type != MessageType.OP:
            return
        rmp = self._rmp.setdefault(msg.doc_id, RemoteMessageProcessor())
        for m in rmp.process(msg):
            contents = m.contents
            if not (isinstance(contents, dict) and "address" in contents):
                continue  # runtime-level op (attach, alias, ...)
            inner = contents.get("contents")
            if not (isinstance(inner, dict) and "address" in inner):
                continue
            dds_op = inner.get("contents")
            if not (isinstance(dds_op, dict) and "mt" in dds_op):
                continue  # not a merge-tree op (maps, intervals, ...)
            row = self._row(m.doc_id, contents["address"], inner["address"])
            if row is None:
                continue
            self._replica_queue.append(
                (row, _with_contents(m, dds_op)))
        if len(self._replica_queue) >= self.batch_window:
            self.flush_replica()

    # --------------------------------------------------------------- device

    def flush_replica(self) -> int:
        n = len(self._replica_queue)
        if n:
            # a reentrant log append (nested _publish from the scribe-ack
            # path, or a client submitting inside an on_op listener) can
            # deliver message N+1 to the replica before N finishes
            # dispatching — the device merge needs strict seq order
            self._replica_queue.sort(key=lambda rm: rm[1].seq)
            parent = getattr(self._replica_queue[-1][1], "trace", None)
            with tracing.span("replica.flush", parent=parent,
                              ops=n) as sp:
                self.store.apply_messages(self._replica_queue)
                st = getattr(self.store, "last_apply_stats", None)
                if st:
                    sp.annotate(**st)
            self.metrics.inc("replica_flushes")
            self.metrics.inc("replica_ops_applied", n)
            self._replica_queue.clear()
            self._flushes_since_compact += 1
            if self._flushes_since_compact >= self.compact_every:
                self.compact_replica()
        return n

    def compact_replica(self) -> None:
        """Zamboni each row at its document's collaboration-window floor."""
        min_seq = np.zeros((self.n_docs,), np.int32)
        for row, doc_id in self._row_doc.items():
            min_seq[row] = self._doc_min_seq.get(doc_id, 0)
        self.store.compact(min_seq)
        self._flushes_since_compact = 0

    # ---------------------------------------------------------------- reads

    def _served_row(self, doc_id: str, channel: str, ds: str) -> int:
        row = self._rows.get((doc_id, ds, channel))
        if row is None:
            raise KeyError(
                f"no served string channel {ds}/{channel} in {doc_id}")
        return row

    def read_text(self, doc_id: str, channel: str,
                  ds: str = "default") -> str:
        """Server-side read of a string channel's merged text — no client
        container involved (the serving-tier read path)."""
        self.flush_replica()
        return self.store.read_text(self._served_row(doc_id, channel, ds))

    def get_properties(self, doc_id: str, channel: str, pos: int,
                       ds: str = "default") -> dict:
        self.flush_replica()
        return self.store.get_properties(
            self._served_row(doc_id, channel, ds), pos)

    def served_channels(self, doc_id: str):
        return [(ds, ch) for (d, ds, ch) in self._rows if d == doc_id]


def _with_contents(msg: SequencedDocumentMessage, contents
                   ) -> SequencedDocumentMessage:
    import dataclasses
    return dataclasses.replace(msg, contents=contents)
