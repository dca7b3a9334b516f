"""Inbound inverse of the outbox: reassemble → decompress → ungroup.

Reference counterpart: ``RemoteMessageProcessor`` (+ ``OpDecompressor``,
``OpGroupingManager`` ungroup path) in ``@fluidframework/container-runtime``
— SURVEY.md §2.8, §3.2 (mount empty). One sequenced wire message expands to
zero (buffered chunk) or more runtime messages. Ungrouped ops from a grouped
batch share the envelope's sequence number; client-visible ordering within
the envelope is positional, and each inner op is delivered with its own
clientSeq-space intact via per-op metadata.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import zlib
from typing import Dict, List, Tuple

from ..core.protocol import MessageType, SequencedDocumentMessage
from .outbox import CHUNKED, COMPRESSED, GROUPED_BATCH


class RemoteMessageProcessor:
    def __init__(self):
        # (client_id, chunk_id) -> list of received pieces
        self._chunks: Dict[Tuple[int, int], List[str]] = {}

    def process(self, msg: SequencedDocumentMessage
                ) -> List[SequencedDocumentMessage]:
        """Expand one sequenced wire message into runtime messages, in
        apply order. Non-envelope messages pass through unchanged."""
        if msg.type != MessageType.OP or not isinstance(msg.contents, dict):
            return [msg]
        contents = msg.contents
        kind = contents.get("type")
        if kind == "withMeta":
            # outermost wrapper: per-op metadata folded into wire contents
            # by ContainerRuntime._send_wire_op
            msg = dataclasses.replace(msg, contents=contents["contents"],
                                      metadata=contents["metadata"])
            contents = msg.contents
            if not isinstance(contents, dict):
                return [msg]
            kind = contents.get("type")
        if kind == CHUNKED:
            whole = self._accept_chunk(msg, contents)
            if whole is None:
                return []
            contents = whole
            kind = contents.get("type")
        if kind == COMPRESSED:
            contents = self._decompress(contents)
            kind = contents.get("type") if isinstance(contents, dict) else None
        if kind == GROUPED_BATCH:
            return self._ungroup(msg, contents)
        if contents is msg.contents:
            return [msg]
        return [dataclasses.replace(msg, contents=contents)]

    # ----------------------------------------------------------------- stages

    def _accept_chunk(self, msg: SequencedDocumentMessage, contents: dict):
        key = (msg.client_id, contents["chunkId"])
        pieces = self._chunks.setdefault(key, [])
        assert contents["chunkIndex"] == len(pieces), \
            "chunks arrive in sequence order (total-order broadcast)"
        pieces.append(contents["payload"])
        if len(pieces) < contents["totalChunks"]:
            return None
        del self._chunks[key]
        payload = "".join(pieces)
        return {"type": COMPRESSED, "payload": payload}

    @staticmethod
    def _decompress(contents: dict) -> dict:
        raw = zlib.decompress(base64.b64decode(contents["payload"]))
        return json.loads(raw)

    @staticmethod
    def _ungroup(msg: SequencedDocumentMessage, contents: dict
                 ) -> List[SequencedDocumentMessage]:
        out = []
        for op in contents["contents"]:
            out.append(dataclasses.replace(
                msg, contents=op["contents"], metadata=op["metadata"]))
        return out
