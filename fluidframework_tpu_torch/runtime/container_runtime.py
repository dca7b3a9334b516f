"""ContainerRuntime: op routing, batching, datastore lifecycle, pending state.

Reference counterpart: ``ContainerRuntime`` in
``@fluidframework/container-runtime`` (SURVEY.md §2.8, §3.2–3.3; mount
empty). This is the layer between the loader (``loader/container.py``) and
the datastores/DDSes (``runtime/datastore.py``, ``models/``):

- **inbound** (§3.2): ``process`` expands each sequenced wire message
  (chunk reassembly → decompression → ungrouping via
  ``RemoteMessageProcessor``), acks pending local records, routes runtime
  messages by outer address to the owning datastore;
- **outbound** (§3.3): ``submit`` goes through the ``Outbox`` (batching →
  grouped batching → compression → chunking); flush mode "immediate" sends
  after every op, "turn" batches until the host loop calls ``flush()``;
- **datastore lifecycle**: ``create_data_store`` announces new datastores
  via attach ops; channels created on an attached datastore are announced
  with channel-attach ops; remote replicas realize both lazily from the
  shipped summaries;
- **pending state** (§5.3): every local runtime message is recorded until
  its sequenced echo; on reconnect the records are resubmitted through the
  channels (rebase hook). Stash / rehydrate for offline resume waits;
- **id compression** (§2.11): creation ranges ride the op stream ahead of
  each flushed batch and finalize in sequence order on every replica.

Factory wiring: ``ContainerRuntime.factory(registry)`` returns the
``RuntimeFactory`` that ``loader.Container.load`` expects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..models.shared_object import ChannelRegistry, default_registry
from ..utils.telemetry import REGISTRY
from .datastore import FluidDataStoreRuntime
from .gc import GarbageCollector
from .id_compressor import IdCompressor, IdCreationRange
from .outbox import Outbox
from .pending_state import PendingStateManager
from .remote_message_processor import RemoteMessageProcessor

# runtime-level op kinds (the "type" discriminator of runtime message
# contents that are NOT address-routed envelopes)
ATTACH = "attach"
ATTACH_CHANNEL = "attachChannel"
ID_RANGE = "idRange"
WITH_METADATA = "withMeta"     # wire wrapper carrying per-op metadata

DEFAULT_DATASTORE = "default"


@dataclasses.dataclass
class ContainerRuntimeOptions:
    """Reference: IContainerRuntimeOptions — SURVEY.md §5.6. Grouping,
    compression and chunking are always on at the outbox's sizes, and so
    are GC and the id compressor."""

    flush_mode: str = "immediate"          # "immediate" | "turn"


class ContainerRuntime:
    def __init__(self, submit_fn: Callable[..., Any],
                 ref_seq_fn: Callable[[], int],
                 registry: Optional[ChannelRegistry] = None,
                 options: Optional[ContainerRuntimeOptions] = None):
        """``submit_fn(contents, ref_seq=...)`` sends one wire op (the
        loader container's ``submit``, with metadata folded into contents
        at the wire layer — see ``_send_wire_op``). ``ref_seq_fn()`` is the
        last sequence number this replica processed: the outbox records it
        for each batch (see ``Outbox``). It starts disconnected: the
        loader's ``set_connection_state`` gives it its client id."""
        self.registry = registry or default_registry()
        self.options = options or ContainerRuntimeOptions()
        self.client_id = -1
        self.connected = False
        self.datastores: Dict[str, FluidDataStoreRuntime] = {}
        self._pending_ds_summaries: Dict[str, dict] = {}
        # channel-handle reuse baselines: per-channel seqs captured at the
        # last summarize() (promoted on ack) — see summarize(incremental=)
        self._capture_channel_seqs: Optional[Dict[str, Dict[str, int]]] \
            = None
        self._acked_channel_seqs: Optional[Dict[str, Dict[str, int]]] \
            = None
        # (ds_id, channel_id) → outbound datastore refs at the channel's
        # last FULL serialization (GC marking for handle-reuse nodes)
        self._channel_refs: Dict[tuple, list] = {}
        self.root_datastores: set = set()
        self.gc = GarbageCollector()
        self.pending = PendingStateManager()
        self.inbound = RemoteMessageProcessor()
        self.id_compressor = IdCompressor()
        self._wire_submit = submit_fn
        self.outbox = Outbox(self._send_wire_op, ref_seq_fn)
        self.last_seq = 0
        self.min_seq = 0
        self._listeners: Dict[str, List[Callable]] = {}

    # ---------------------------------------------------------------- factory

    @classmethod
    def factory(cls, registry: Optional[ChannelRegistry] = None,
                options: Optional[ContainerRuntimeOptions] = None):
        """A ``RuntimeFactory`` for ``loader.Container.load`` (reference:
        the code-proposal → runtime-factory boundary)."""
        def make(container, runtime_summary):
            dm = container.delta_manager
            rt = cls(container.submit, lambda: dm.last_sequence_number,
                     registry=registry, options=options)
            if runtime_summary:
                rt._load_summary(runtime_summary)
            return rt
        return make

    def _on_channel_create(self, ds: FluidDataStoreRuntime,
                           channel) -> None:
        """Announce a locally-created channel to remote replicas
        (reference: channel attach ops)."""
        self._submit_runtime_op({
            "type": ATTACH_CHANNEL, "address": ds.id,
            "id": channel.id, "summary": channel.summarize()})

    def on(self, event: str, fn: Callable) -> None:
        self._listeners.setdefault(event, []).append(fn)

    def _emit(self, event: str, *args) -> None:
        for fn in self._listeners.get(event, []):
            fn(*args)

    # ------------------------------------------------------------- datastores

    def create_data_store(self, ds_id: str = DEFAULT_DATASTORE,
                          root: bool = True) -> FluidDataStoreRuntime:
        """Create + attach a datastore (announced via an attach op so every
        replica instantiates it — reference: createDataStore + attach).
        ``root=True`` makes it a GC root (reference: aliased/root
        datastores); a non-root datastore survives GC only while some root
        datastore holds a ``fluid_handle`` to it."""
        assert ds_id not in self.datastores \
            and ds_id not in self._pending_ds_summaries, \
            f"datastore {ds_id!r} already exists"
        ds = self._instantiate(ds_id)
        self.datastores[ds_id] = ds
        if root:
            self.root_datastores.add(ds_id)
        self._submit_runtime_op({"type": ATTACH, "id": ds_id,
                                 "root": root, "summary": ds.summarize()})
        return ds

    def get_data_store(self, ds_id: str = DEFAULT_DATASTORE
                       ) -> FluidDataStoreRuntime:
        """Realize-on-demand from the loaded summary (reference:
        resolveHandle / getRootDataStore)."""
        if ds_id not in self.datastores:
            summary = self._pending_ds_summaries.pop(ds_id)
            ds = FluidDataStoreRuntime.load(
                ds_id, self.registry, self.client_id,
                self._make_ds_submit(ds_id), summary,
                on_channel_create=self._on_channel_create)
            self.datastores[ds_id] = ds
        return self.datastores[ds_id]

    def has_data_store(self, ds_id: str) -> bool:
        return ds_id in self.datastores or ds_id in self._pending_ds_summaries

    def data_store_ids(self):
        return sorted(set(self.datastores) | set(self._pending_ds_summaries))

    def _instantiate(self, ds_id: str) -> FluidDataStoreRuntime:
        return FluidDataStoreRuntime(
            ds_id, self.registry, self.client_id,
            self._make_ds_submit(ds_id),
            on_channel_create=self._on_channel_create)

    def _make_ds_submit(self, ds_id: str):
        def submit(inner: dict, metadata: Optional[dict]) -> None:
            self._submit_runtime_op({"address": ds_id, "contents": inner},
                                    metadata)
        return submit

    # ---------------------------------------------------------------- inbound

    def process(self, msg: SequencedDocumentMessage, local: bool) -> None:
        """The processOp loop (§3.2): expand one wire message and route."""
        self.last_seq = msg.seq
        REGISTRY.inc("runtime_ops_processed")
        if msg.type != MessageType.OP:
            self._emit("op", msg, local)
            return
        # A "local" echo whose submission connection is NOT the oldest
        # pending record's is stale: its record was already resubmitted on a
        # newer connection (a reconnect raced an in-flight op that the
        # service still sequenced). Peers apply it, so we apply it too — as
        # a remote op — and leave pending state for the resubmission's echo.
        if local and not self.pending.head_matches_connection(msg.client_id):
            local = False
        for runtime_msg in self.inbound.process(msg):
            if local:
                record = self.pending.process_local(runtime_msg)
                if record["metadata"] is not None \
                        and runtime_msg.metadata is None:
                    runtime_msg = dataclasses.replace(
                        runtime_msg, metadata=record["metadata"])
            self._route(runtime_msg, local)
            self._emit("runtimeOp", runtime_msg, local)
        if msg.min_seq > self.min_seq:
            self.min_seq = msg.min_seq
            for ds in self.datastores.values():
                ds.on_min_seq(msg.min_seq)
        self._emit("op", msg, local)

    def _route(self, msg: SequencedDocumentMessage, local: bool) -> None:
        contents = msg.contents
        if not isinstance(contents, dict):
            return
        kind = contents.get("type")
        if kind == ATTACH:
            if contents.get("root"):
                self.root_datastores.add(contents["id"])
            if not local and not self.has_data_store(contents["id"]):
                self._pending_ds_summaries[contents["id"]] = \
                    contents["summary"]
            return
        if kind == ATTACH_CHANNEL:
            if not local:
                ds = self.get_data_store(contents["address"])
                if not ds.has_channel(contents["id"]):
                    ds._pending_summaries[contents["id"]] = \
                        contents["summary"]
            return
        if kind == ID_RANGE:
            self.id_compressor.finalize_range(
                IdCreationRange(**contents["range"]))
            return
        if "address" in contents:
            self.get_data_store(contents["address"]).process(msg, local)

    # --------------------------------------------------------------- outbound

    def _submit_runtime_op(self, contents: dict,
                           metadata: Optional[dict] = None) -> None:
        self.pending.on_submit(contents, metadata,
                               client_id=self.client_id
                               if self.connected else None)
        if self.connected:
            self.outbox.submit(contents, metadata)
            if self.options.flush_mode == "immediate":
                self.flush()
        # while disconnected the record waits in pending; reconnect resubmits

    def flush(self) -> int:
        """End-of-turn flush (reference: Outbox.flush at JS turn end)."""
        if not self.connected:
            return 0
        rng = self.id_compressor.take_next_creation_range()
        if rng is not None:
            # the range rides ahead of the batch ops that use its ids, so
            # peers can resolve them — but AFTER any earlier (resubmitted)
            # range already in the outbox: ranges must hit the wire in
            # generation order or finalize_range rejects them
            record = {"type": ID_RANGE, "range": dataclasses.asdict(rng)}
            ops = self.outbox.main._ops
            idx = 0
            for i, op in enumerate(ops):
                if isinstance(op["contents"], dict) \
                        and op["contents"].get("type") == ID_RANGE:
                    idx = i + 1
            # pending order mirrors wire order
            self.pending.insert_before_last(
                self.outbox.pending_count - idx, record, None,
                client_id=self.client_id if self.connected else None)
            ops.insert(idx, {"contents": record, "metadata": None})
        return self.outbox.flush()

    def _send_wire_op(self, contents: dict, metadata: Optional[dict],
                      ref_seq: Optional[int] = None) -> None:
        """Metadata is folded into the wire contents here (the drivers'
        submit carries contents only); RemoteMessageProcessor unwraps it
        first on the inbound side. ``ref_seq`` is the batch's."""
        if metadata is not None:
            contents = {"type": WITH_METADATA, "contents": contents,
                        "metadata": metadata}
        self._wire_submit(contents, ref_seq=ref_seq)

    def generate_document_unique_id(self) -> int:
        """Reference: ContainerRuntime.generateDocumentUniqueId — a compact
        id finalized through the op stream (§2.11)."""
        return self.id_compressor.generate_id()

    # ------------------------------------------------------------- connection

    def set_connection_state(self, connected: bool,
                             client_id: Optional[int]) -> None:
        """Loader container calls this on connect/disconnect (§2.10). On
        reconnect: adopt the new client id, then resubmit pending records
        through the channels (rebase hook — §3.3)."""
        self.connected = connected
        if not connected:
            # unflushed outbox entries survive only as pending records
            self.outbox.main.pop_batch()
            return
        assert client_id is not None
        self.client_id = client_id
        for ds in self.datastores.values():
            ds.set_client_id(client_id)
        for record in self.pending.take_pending():
            self._resubmit(record)
        self.flush()

    def _resubmit(self, record: dict) -> None:
        contents, metadata = record["contents"], record["metadata"]
        kind = contents.get("type") if isinstance(contents, dict) else None
        if kind in (ATTACH, ATTACH_CHANNEL, ID_RANGE):
            self._submit_runtime_op(contents, metadata)
        elif isinstance(contents, dict) and "address" in contents:
            self.get_data_store(contents["address"]).resubmit(
                contents["contents"], metadata)
        else:
            self._submit_runtime_op(contents, metadata)

    # ---------------------------------------------------------------- summary

    def summarize(self, incremental: bool = False) -> dict:
        """Runtime summary subtree (§3.4): every datastore, realized or not,
        plus document-global id-compressor and GC state. The GC
        mark/sweep pass prunes swept datastores from the summary AND
        from this replica (other replicas drop them when they next load —
        the GC-op coordination of the reference is collapsed into the
        summary itself).

        ``incremental=True`` (meaningful after ``on_summary_ack``):
        channels that processed no op since the last ACKED summary emit
        ``__handle__`` nodes instead of their full subtree; the storage
        service materializes them against the prior summary at upload
        (SURVEY.md §2.16). GC still marks correctly: each channel's
        outbound references are cached when it serializes in full, and
        handle nodes contribute their cached refs to the mark phase."""
        from .gc import collect_handles, fluid_handle
        prev = self._acked_channel_seqs if incremental else None
        datastores = {ds_id: ds.summarize(prev.get(ds_id)
                                          if prev is not None else None)
                      for ds_id, ds in self.datastores.items()}
        datastores.update(self._pending_ds_summaries)
        # capture the per-channel baselines this summary represents; they
        # become the handle-reuse baseline when the summary is ACKED
        self._capture_channel_seqs = {
            ds_id: ds.channel_seqs()
            for ds_id, ds in self.datastores.items()}
        # refresh the per-channel ref cache from EVERY fully serialized
        # channel — a later incremental summary's handle nodes mark via
        # these refs (a handle channel marking with empty refs would let
        # GC sweep a datastore it still references)
        for ds_id, ds in datastores.items():
            for cid, ch in (ds.get("channels") or {}).items():
                if not (isinstance(ch, dict) and "__handle__" in ch):
                    self._channel_refs[(ds_id, cid)] = sorted(
                        collect_handles(ch))
        # handle nodes contribute their cached refs to the mark view
        gc_view: Dict[str, dict] = {}
        for ds_id, ds in datastores.items():
            chans = ds.get("channels") or {}
            view_ch = {}
            for cid, ch in chans.items():
                if isinstance(ch, dict) and "__handle__" in ch:
                    refs = self._channel_refs.get((ds_id, cid), ())
                    view_ch[cid] = {"refs": [fluid_handle(r)
                                             for r in refs]}
                else:
                    view_ch[cid] = ch
            gc_view[ds_id] = dict(ds, channels=view_ch)
        swept_before = len(self.gc.swept)
        kept = self.gc.run(gc_view, set(self.root_datastores))
        datastores = {ds_id: s for ds_id, s in datastores.items()
                      if ds_id in kept}
        for ds_id in self.gc.swept[swept_before:]:
            self.datastores.pop(ds_id, None)
            self._pending_ds_summaries.pop(ds_id, None)
            for key in [k for k in self._channel_refs
                        if k[0] == ds_id]:
                del self._channel_refs[key]   # keep the cache bounded
        return {"datastores": datastores,
                "roots": sorted(self.root_datastores),
                "gc": self.gc.summarize(),
                "idCompressor": self.id_compressor.summarize()}

    def take_summary_capture(self):
        """The per-channel seqs captured by the LAST ``summarize()`` call
        — the summarizer snapshots this right after building its upload,
        so an out-of-band ``summarize()`` between upload and ack cannot
        poison the promoted baseline."""
        cap, self._capture_channel_seqs = self._capture_channel_seqs, None
        return cap

    def on_summary_ack(self, capture=None) -> None:
        """The summarizer's proposal was ACKED: promote the captured
        per-channel seqs to the handle-reuse baseline (unchanged channels
        may now reference the acked summary by handle). ``capture`` is
        the snapshot the summarizer took at UPLOAD time (see
        ``take_summary_capture``)."""
        if capture is None:
            capture = self._capture_channel_seqs
        if capture is not None:
            self._acked_channel_seqs = capture

    def _load_summary(self, summary: dict) -> None:
        self._pending_ds_summaries = dict(summary.get("datastores", {}))
        self.root_datastores = set(summary.get("roots", ()))
        if "gc" in summary:
            self.gc.load(summary["gc"])
        if "idCompressor" in summary:
            self.id_compressor = IdCompressor.load(summary["idCompressor"])
