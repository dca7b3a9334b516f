"""Post-sequencing lambdas: Broadcaster, Scriptorium, Scribe, Historian.

Reference counterparts (SURVEY.md §1 server table; mount empty):

- **Broadcaster** — fans sequenced ops out to connected clients (Redis
  pub/sub → Socket.IO rooms). Here: per-doc subscription registry fed by the
  sequenced-deltas log.
- **Scriptorium** — writes sequenced ops to the persistent op store (MongoDB)
  for catch-up reads. Here: per-doc ordered op store with range reads.
- **Scribe** — tracks protocol state and converts ``summarize`` ops into
  ``summaryAck``/``summaryNack``.
- **Historian/Gitrest** — content-addressed summary storage with a git-like
  blob/tree API.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.protocol import MessageType, SequencedDocumentMessage


class Broadcaster:
    def __init__(self):
        self._rooms: Dict[str, List[Callable[[SequencedDocumentMessage], None]]] = {}
        self._lock = threading.Lock()

    def join(self, doc_id: str,
             listener: Callable[[SequencedDocumentMessage], None]) -> None:
        with self._lock:
            self._rooms.setdefault(doc_id, []).append(listener)

    def leave(self, doc_id: str, listener) -> None:
        with self._lock:
            room = self._rooms.get(doc_id, [])
            if listener in room:
                room.remove(listener)

    def publish(self, msg: SequencedDocumentMessage) -> None:
        with self._lock:
            room = list(self._rooms.get(msg.doc_id, []))
        for listener in room:
            listener(msg)


class Scriptorium:
    """Durable sequenced-op store, the catch-up read path."""

    def __init__(self):
        self._ops: Dict[str, List[SequencedDocumentMessage]] = {}
        self._lock = threading.Lock()

    def store(self, msg: SequencedDocumentMessage) -> None:
        with self._lock:
            self._ops.setdefault(msg.doc_id, []).append(msg)

    def get_deltas(self, doc_id: str, from_seq: int = 0,
                   to_seq: Optional[int] = None
                   ) -> List[SequencedDocumentMessage]:
        """Ops with from_seq < seq <= to_seq (the tail-replay range)."""
        with self._lock:
            ops = self._ops.get(doc_id, [])
            return [m for m in ops
                    if m.seq > from_seq and (to_seq is None or m.seq <= to_seq)]


class Historian:
    """Content-addressed snapshot storage (git-like blobs + refs)."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._refs: Dict[str, Tuple[str, int]] = {}  # doc -> (sha, seq)
        self._lock = threading.Lock()

    def upload_summary(self, doc_id: str, summary: dict, seq: int) -> str:
        """Store a summary; ``__handle__`` channel nodes (channel-handle
        reuse — the client uploaded a reference instead of the subtree)
        are materialized here against the doc's latest accepted summary,
        so stored summaries are always fully resolved (the reference's
        uploadSummaryWithContext handle semantics)."""
        summary = self._resolve_handles(doc_id, summary)
        blob = json.dumps(summary, sort_keys=True, default=str).encode()
        sha = hashlib.sha1(blob).hexdigest()
        with self._lock:
            self._blobs[sha] = blob
            self._refs[doc_id] = (sha, seq)
        return sha

    def _resolve_handles(self, doc_id: str, summary: dict) -> dict:
        datastores = (summary.get("runtime") or {}).get("datastores")
        if not datastores:
            return summary
        has_handle = any(
            isinstance(ch, dict) and "__handle__" in ch
            for ds in datastores.values()
            for ch in (ds.get("channels") or {}).values())
        if not has_handle:
            return summary
        prev, _seq, _sha = self.latest_summary(doc_id)
        if prev is None:
            raise ValueError(
                f"{doc_id}: summary references a prior summary by handle "
                "but none is stored")
        prev_ds = (prev.get("runtime") or {}).get("datastores") or {}
        out = dict(summary)
        out["runtime"] = dict(summary["runtime"])
        out_ds = out["runtime"]["datastores"] = {}
        for ds_id, ds in datastores.items():
            chans = ds.get("channels") or {}
            if not any(isinstance(ch, dict) and "__handle__" in ch
                       for ch in chans.values()):
                out_ds[ds_id] = ds
                continue
            new_ds = dict(ds)
            new_ch = new_ds["channels"] = {}
            for cid, ch in chans.items():
                if isinstance(ch, dict) and "__handle__" in ch:
                    p_ds, p_cid = ch["__handle__"]
                    try:
                        new_ch[cid] = \
                            prev_ds[p_ds]["channels"][p_cid]
                    except KeyError:
                        raise ValueError(
                            f"{doc_id}: handle {p_ds}/{p_cid} not "
                            "present in the prior summary") from None
                else:
                    new_ch[cid] = ch
            out_ds[ds_id] = new_ds
        return out

    def latest_summary(self, doc_id: str
                       ) -> Tuple[Optional[dict], int, Optional[str]]:
        """(summary, seq, sha) of the newest accepted summary, or (None, 0,
        None) for a fresh document."""
        with self._lock:
            ref = self._refs.get(doc_id)
            if ref is None:
                return None, 0, None
            sha, seq = ref
            return json.loads(self._blobs[sha]), seq, sha

    def read_blob(self, sha: str) -> bytes:
        with self._lock:
            return self._blobs[sha]


class Scribe:
    """Summary-op protocol: validates summarize ops, emits acks."""

    def __init__(self, historian: Historian):
        self.historian = historian
        self.last_summary_seq: Dict[str, int] = {}

    def process(self, msg: SequencedDocumentMessage
                ) -> Optional[Tuple[MessageType, dict]]:
        """Returns a (SUMMARY_ACK|SUMMARY_NACK, contents) service message to
        sequence, or None for non-summary ops."""
        if msg.type != MessageType.SUMMARIZE:
            return None
        sha = (msg.contents or {}).get("handle")
        if sha is None or sha not in self.historian._blobs:
            return MessageType.SUMMARY_NACK, {"summaryProposal": msg.seq,
                                              "reason": "unknown handle"}
        self.last_summary_seq[msg.doc_id] = msg.seq
        return MessageType.SUMMARY_ACK, {"summaryProposal": msg.seq,
                                         "handle": sha}
