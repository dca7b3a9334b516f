"""FluidDataStoreRuntime: per-datastore channel registry and routing.

Reference counterpart: ``@fluidframework/datastore``
(``FluidDataStoreRuntime``, ``LocalChannelContext``/``RemoteChannelContext``)
+ the addressing scheme of ``runtime-definitions`` — SURVEY.md §2.9, §3.2
(mount empty). A datastore owns a set of channels (DDS instances) addressed
``/dataStoreId/channelId``; the container runtime routes the outer envelope,
the datastore routes the inner one. Channels are realized lazily from the
datastore's summary on first access (reference: RemoteChannelContext).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ..core.protocol import SequencedDocumentMessage
from ..models.shared_object import ChannelRegistry, SharedObject


class FluidDataStoreRuntime:
    def __init__(self, ds_id: str, registry: ChannelRegistry,
                 client_id: int,
                 submit_fn: Callable[[dict, Optional[dict]], None],
                 on_channel_create: Optional[
                     Callable[["FluidDataStoreRuntime", SharedObject],
                              None]] = None):
        """``submit_fn(inner_envelope, metadata)`` forwards to the container
        runtime, which wraps it in the outer ``{address: ds_id}`` envelope.
        ``on_channel_create(ds, channel)`` fires for every locally-created
        channel — the runtime uses it to announce channels to remote
        replicas (channel attach ops), so it must be wired on every
        construction path."""
        self.id = ds_id
        self.registry = registry
        self.client_id = client_id
        self._submit = submit_fn
        self._on_channel_create = on_channel_create
        self._channels: Dict[str, SharedObject] = {}
        # channelId -> summary not yet realized into a live channel
        self._pending_summaries: Dict[str, dict] = {}

    # --------------------------------------------------------------- channels

    def create_channel(self, channel_id: str, type_name: str) -> SharedObject:
        assert channel_id not in self._channels \
            and channel_id not in self._pending_summaries, \
            f"channel {channel_id!r} already exists"
        channel = self.registry.get(type_name).create(channel_id,
                                                      self.client_id)
        self._wire(channel)
        self._channels[channel_id] = channel
        if self._on_channel_create is not None:
            self._on_channel_create(self, channel)
        return channel

    def get_channel(self, channel_id: str) -> SharedObject:
        """Realize-on-demand (reference: RemoteChannelContext.getChannel)."""
        if channel_id not in self._channels:
            summary = self._pending_summaries.pop(channel_id)
            channel = self.registry.get(summary["type"]).load(
                channel_id, self.client_id, summary,
                summary.get("baseSeq", 0))
            self._wire(channel)
            self._channels[channel_id] = channel
        return self._channels[channel_id]

    def has_channel(self, channel_id: str) -> bool:
        return channel_id in self._channels \
            or channel_id in self._pending_summaries

    def channel_ids(self):
        return sorted(set(self._channels) | set(self._pending_summaries))

    def _wire(self, channel: SharedObject) -> None:
        channel.connect(lambda contents, _id=channel.id:
                        self._submit({"address": _id, "contents": contents},
                                     None))

    def set_client_id(self, client_id: int) -> None:
        """New connection: channels stamp local ops with the new id."""
        self.client_id = client_id
        for ch in self._channels.values():
            ch.on_client_id_changed(client_id)

    # ---------------------------------------------------------------- inbound

    def process(self, msg: SequencedDocumentMessage, local: bool) -> None:
        """Route the inner envelope ``{address, contents}`` to its channel
        (``msg.contents`` is the outer ``{address: ds_id, contents: inner}``
        envelope the container runtime routed by)."""
        inner = msg.contents["contents"]
        channel = self.get_channel(inner["address"])
        channel.deliver(
            dataclasses.replace(msg, contents=inner["contents"],
                                address=channel.id),
            local)

    def resubmit(self, inner: dict, metadata: Optional[dict] = None) -> None:
        """Reconnect path: let the channel rebase, then resend with the
        original local-op metadata preserved (§3.3). A rebase may drop the
        op (None) or split it into several (list)."""
        channel = self.get_channel(inner["address"])
        rebased = channel.rebase_op(inner["contents"])
        if rebased is None:
            return
        if isinstance(rebased, dict):
            rebased = [rebased]
        for contents in rebased:
            self._submit({"address": channel.id, "contents": contents},
                         metadata)

    def on_min_seq(self, min_seq: int) -> None:
        for ch in self._channels.values():
            ch.on_min_seq(min_seq)

    # -------------------------------------------------------------- summaries

    def summarize(self, prev_channel_seqs: Optional[Dict[str, int]] = None
                  ) -> dict:
        """Summary subtree: one entry per channel (realized channels
        summarize live; unrealized ones pass their loaded summary through —
        reference: summarizer handle reuse for unchanged subtrees).

        ``prev_channel_seqs`` ({channel id → baseSeq at the last ACKED
        summary}) enables channel-handle reuse: a channel that processed
        no op since then emits a ``__handle__`` node referencing its
        subtree in the prior summary instead of re-serializing — the
        storage service materializes it at upload (SURVEY.md §2.16:
        incremental via handle reuse)."""
        # baseSeq records each channel's capture point (reference: the
        # .attributes sequence number) so realization restores the base
        # perspective; unrealized passthrough summaries keep their original
        channels = {}
        for cid, ch in self._channels.items():
            base = ch.last_processed_seq
            if prev_channel_seqs is not None \
                    and prev_channel_seqs.get(cid) == base:
                # structural (ds, channel) path: ids may contain any
                # character, so no string splitting at resolution
                channels[cid] = {
                    "__handle__": [self.id, cid], "baseSeq": base}
            else:
                channels[cid] = dict(ch.summarize(), baseSeq=base)
        channels.update(self._pending_summaries)
        return {"channels": channels}

    def channel_seqs(self) -> Dict[str, int]:
        """{channel id → last processed seq} (handle-reuse baselines)."""
        return {cid: ch.last_processed_seq
                for cid, ch in self._channels.items()}

    @classmethod
    def load(cls, ds_id: str, registry: ChannelRegistry, client_id: int,
             submit_fn, summary: dict,
             on_channel_create=None) -> "FluidDataStoreRuntime":
        ds = cls(ds_id, registry, client_id, submit_fn,
                 on_channel_create=on_channel_create)
        ds._pending_summaries = dict(summary.get("channels", {}))
        return ds
