"""Outbox: outbound op batching, compression, grouping, chunking.

Reference counterpart: ``Outbox`` / ``BatchManager`` / ``OpCompressor`` /
``OpGroupingManager`` / ``OpSplitter`` in ``@fluidframework/container-runtime``
(SURVEY.md §2.8, §3.3; mount empty). Pipeline, applied at flush time to the
ops accumulated during one host "turn":

1. **batching** — ops submitted between flushes form one atomic batch; batch
   boundaries are marked in metadata (``batch: True`` on the first op,
   ``batch: False`` on the last) so receivers can apply them atomically;
2. **grouped batching** — a multi-op batch is wrapped into ONE envelope op
   (type ``groupedBatch``) so the ordering service stamps a single sequence
   number and per-op sub-sequencing is reconstructed client-side;
3. **compression** — serialized batch payloads over a size threshold are
   zlib-compressed (base64 text payload, original op carried as dark matter);
4. **chunking** — a compressed payload over the max-op-size is split across
   multiple ``chunkedOp`` ops, reassembled before decompression.

The inverse lives in ``remote_message_processor.py``. Grouped batching is
what keeps the device path dense: one sequenced envelope yields a run of
merge-tree ops that the serving replica (``server/serving_service.py``)
lays out into the int32 op planes of one device merge.

Both packages emit byte-equal envelopes for the same batch: compact JSON,
zlib at its default level, standard base64, and one chunk id counter per
outbox.

The outbox records the number a batch's ops were made against (``ref_seq_fn``,
the last sequence number its replica processed) when the first one
enters; an op made after that number moved flushes the partial batch
first (the reference's ``flushPartialBatches``), and a batch whose number
moved before its flush is sent stamped with its own. Otherwise the wire
ops take the number current when each is sent, as the JAX outbox always
does: that outbox stamps a turn made before an inbound op with the seq of
that op, which shifts the turn's positions on every other replica
(ROADMAP C13).
"""

from __future__ import annotations

import base64
import json
import zlib
from typing import Callable, List, Optional

from ..utils import tracing

# envelope op types (carried inside MessageType.OP contents)
GROUPED_BATCH = "groupedBatch"
COMPRESSED = "compressed"
CHUNKED = "chunkedOp"

#: a serialized batch this long or longer is compressed
COMPRESSION_THRESHOLD = 4096
#: the largest wire op; a longer compressed payload is chunked
MAX_OP_SIZE = 16384


class BatchManager:
    """Accumulates the current batch (reference: BatchManager)."""

    def __init__(self):
        self._ops: List[dict] = []
        #: reference seq the batch's ops were made against (None: empty)
        self.ref_seq: Optional[int] = None

    def push(self, contents: dict, metadata: Optional[dict],
             ref_seq: int) -> None:
        """Append one op; the first op of a batch records ``ref_seq``."""
        if not self._ops:
            self.ref_seq = ref_seq
        self._ops.append({"contents": contents, "metadata": metadata})

    @property
    def empty(self) -> bool:
        return not self._ops

    def __len__(self) -> int:
        return len(self._ops)

    def pop_batch(self) -> List[dict]:
        ops, self._ops = self._ops, []
        self.ref_seq = None
        if len(ops) > 1:
            # batch-boundary metadata (reference: batchMetadata flag)
            ops[0] = {**ops[0], "metadata": {**(ops[0]["metadata"] or {}),
                                             "batch": True}}
            ops[-1] = {**ops[-1], "metadata": {**(ops[-1]["metadata"] or {}),
                                               "batch": False}}
        return ops


class Outbox:
    """Flush-time pipeline: group → compress → chunk → submit.

    ``submit_fn(contents, metadata, ref_seq)`` sends ONE wire op stamped
    with ``ref_seq`` (None: the connection's current one); the outbox
    calls it once per flushed envelope or singleton op. ``ref_seq_fn()``
    is the replica's last processed sequence number.
    """

    def __init__(self, submit_fn: Callable[[dict, Optional[dict],
                                            Optional[int]], None],
                 ref_seq_fn: Callable[[], int]):
        self._submit = submit_fn
        self._ref_seq_fn = ref_seq_fn
        self.main = BatchManager()
        self._chunk_id = 0

    # ------------------------------------------------------------- enqueueing

    def submit(self, contents: dict, metadata: Optional[dict] = None) -> None:
        """Enqueue one op. A batch made against an older sequence number
        is flushed first, stamped with its own."""
        ref_seq = self._ref_seq_fn()
        if not self.main.empty and self.main.ref_seq != ref_seq:
            self.flush()
        self.main.push(contents, metadata, ref_seq)

    @property
    def pending_count(self) -> int:
        return len(self.main)

    # ------------------------------------------------------------------ flush

    def flush(self) -> int:
        """Send the accumulated batch; returns number of wire ops sent."""
        if self.main.empty:
            return 0
        ref_seq = self.main.ref_seq
        if self._ref_seq_fn() == ref_seq:
            ref_seq = None   # nothing moved: stamp each op as it is sent
        batch = self.main.pop_batch()
        # trace root: one batch = one trace; every downstream layer
        # (wire, deli, apply, ack) parents its span under this one
        with tracing.span("outbox.flush", ops=len(batch)) as sp:
            if len(batch) > 1:
                envelope = {"type": GROUPED_BATCH,
                            "contents": [{"contents": op["contents"],
                                          "metadata": op["metadata"]}
                                         for op in batch]}
                sent = self._send_maybe_compressed(envelope, None, ref_seq)
            else:
                sent = 0
                for op in batch:
                    sent += self._send_maybe_compressed(
                        op["contents"], op["metadata"], ref_seq)
            sp.annotate(wire_ops=sent)
        return sent

    def _send_maybe_compressed(self, contents: dict,
                               metadata: Optional[dict],
                               ref_seq: Optional[int]) -> int:
        raw = json.dumps(contents, separators=(",", ":"))
        if len(raw) < COMPRESSION_THRESHOLD and len(raw) <= MAX_OP_SIZE:
            self._submit(contents, metadata, ref_seq)
            return 1
        packed = base64.b64encode(zlib.compress(raw.encode())).decode()
        envelope = {"type": COMPRESSED, "payload": packed}
        if len(packed) <= MAX_OP_SIZE:
            self._submit(envelope, metadata, ref_seq)
            return 1
        return self._send_chunked(packed, metadata, ref_seq)

    def _send_chunked(self, payload: str, metadata: Optional[dict],
                      ref_seq: Optional[int]) -> int:
        """Split an oversized compressed payload into chunkedOp pieces
        (reference: OpSplitter). Only the LAST chunk carries the original
        metadata — it is the op that "happens"; earlier chunks are inert
        carriers reassembled by the receiver."""
        self._chunk_id += 1
        n = (len(payload) + MAX_OP_SIZE - 1) // MAX_OP_SIZE
        for i in range(n):
            piece = payload[i * MAX_OP_SIZE:(i + 1) * MAX_OP_SIZE]
            self._submit({"type": CHUNKED, "chunkId": self._chunk_id,
                          "chunkIndex": i, "totalChunks": n,
                          "payload": piece},
                         metadata if i == n - 1 else None, ref_seq)
        return n
