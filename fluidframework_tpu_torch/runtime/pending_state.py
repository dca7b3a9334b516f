"""PendingStateManager: the lifecycle of local ops between submit and ack.

Reference counterpart: ``PendingStateManager`` in
``@fluidframework/container-runtime`` (SURVEY.md §2.8, §3.3, §5.3; mount
empty). Responsibilities:

- record every locally-submitted runtime message, in submit order;
- on the sequenced echo of a local message, pop the matching record (the
  echo IS the ack — §1 data flow) and verify it round-tripped intact;
- on reconnect, hand the still-pending records back to the runtime for
  **resubmission** through the channels (which may rebase — §3.3).

Matching is FIFO + content equality rather than clientSeq bookkeeping: after
grouping/compression/chunking, one wire op can carry many runtime messages,
but expansion (RemoteMessageProcessor) restores them in submit order, so the
n-th local runtime message to arrive is always the n-th pending record.
"""

from __future__ import annotations

import collections
import json
from typing import Any, Deque, List, Optional

from ..core.protocol import SequencedDocumentMessage


class PendingStateManager:
    def __init__(self):
        self._pending: Deque[dict] = collections.deque()

    # ---------------------------------------------------------------- records

    def on_submit(self, contents: Any, metadata: Optional[dict] = None,
                  client_id: Optional[int] = None) -> None:
        """``client_id`` stamps the connection the record is being
        submitted under — the reconnect-era discriminator (see
        ``head_matches_connection``)."""
        self._pending.append({"contents": contents, "metadata": metadata,
                              "client_id": client_id})

    def insert_before_last(self, n_last: int, contents: Any,
                           metadata: Optional[dict] = None,
                           client_id: Optional[int] = None) -> None:
        """Record an op that will be sent ahead of the last ``n_last``
        not-yet-flushed ops (the id-range that rides in front of its batch —
        pending order must mirror wire order)."""
        self._pending.insert(len(self._pending) - n_last,
                             {"contents": contents, "metadata": metadata,
                              "client_id": client_id})

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    # -------------------------------------------------------------------- ack

    def head_matches_connection(self, client_id: int) -> bool:
        """Is the oldest pending record's submission connection ``client_id``?
        False means an arriving "local" echo is STALE — the record it once
        acked was resubmitted on a newer connection (reconnect raced an
        in-flight op that still got sequenced). Such an echo must be applied
        as a REMOTE op (every peer applies it; skipping would diverge) and
        must not pop pending state (the resubmission's echo will)."""
        return bool(self._pending) and \
            self._pending[0].get("client_id") == client_id

    def process_local(self, msg: SequencedDocumentMessage) -> dict:
        """The sequenced echo of one of our runtime messages arrived; pop and
        verify. Returns the record (carrying any local-op metadata)."""
        assert self._pending, "local sequenced message with no pending record"
        record = self._pending.popleft()
        if _canon(record["contents"]) != _canon(msg.contents):
            raise RuntimeError(
                "pending state out of sync: sequenced echo does not match "
                "the oldest pending local op")
        return record

    # -------------------------------------------------------------- resubmit

    def take_pending(self) -> List[dict]:
        """Drain all pending records for resubmission (reconnect path).
        The runtime replays them through the channels, which re-enqueue new
        records as they resubmit."""
        records, self._pending = list(self._pending), collections.deque()
        return records


def _canon(value: Any) -> str:
    return json.dumps(value, sort_keys=True, default=str)
