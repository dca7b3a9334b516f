"""Merge-tree Client: translates between ops and MergeTree calls.

Reference counterpart: ``@fluidframework/merge-tree`` ``Client``
(``applyMsg``, ``insertSegmentLocal``, ``ackPendingSegment`` — SURVEY.md §2.1,
§3.2/§3.3; mount empty). One Client == one replica's view of one sequence.

Local edits apply optimistically (latency-free) with ``SEQ_UNASSIGNED`` stamps
and produce op payloads; the sequenced echo of our own op is the ack that
converts pending state into committed state. Remote sequenced ops apply in the
perspective ``(op.ref_seq, op.client)``.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional

from ..core.constants import SEQ_UNASSIGNED
from ..core.protocol import MessageType, SequencedDocumentMessage
from .merge_tree import MergeTree, SegmentKind, LOCAL_VIEW


class SequenceClient:
    # set by every tree mutation (local apply and remote apply): the
    # affected segments, for the owning DDS's "sequenceDelta" event
    last_delta: Optional[Dict[str, Any]] = None

    def __init__(self, client_id: int):
        self.client_id = client_id
        self.tree = MergeTree(client_id)
        self.client_seq = 0
        self.last_processed_seq = 0
        self.pending = collections.deque()  # FIFO of (client_seq, kind)

    # ----------------------------------------------------------- local edits

    def _check_pos(self, pos: int) -> None:
        if not 0 <= pos <= self.get_length():
            raise IndexError(f"position {pos} outside [0, {self.get_length()}]")

    def _check_range(self, start: int, end: int) -> None:
        if not 0 <= start < end <= self.get_length():
            raise IndexError(
                f"range [{start},{end}) invalid for length {self.get_length()}"
            )

    def _record_pending(self, kind: str) -> int:
        # Called only after the tree mutation succeeded, so a rejected local
        # edit can never leave a phantom entry that desyncs later acks.
        self.pending.append((self.client_seq, kind))
        return self.client_seq

    @staticmethod
    def _op_handle(client_id: int, client_seq: int) -> tuple:
        """Globally-unique, replica-invariant payload handle for one insert op
        (same value computed at local apply and at every remote apply)."""
        return (client_id * (2**26) + client_seq, 0)

    def insert_text_local(self, pos: int, text: str,
                          props: Optional[dict] = None) -> Dict[str, Any]:
        self._check_pos(pos)
        self.client_seq += 1
        seg = self.tree.insert(
            pos, SegmentKind.TEXT, text, SEQ_UNASSIGNED, self.client_id,
            LOCAL_VIEW, props=props, local_op=self.client_seq,
            handle=self._op_handle(self.client_id, self.client_seq),
        )
        self.last_delta = {"operation": "insert", "segments": [seg]}
        op_id = self._record_pending("insert")
        return {"mt": "insert", "pos": pos, "kind": int(SegmentKind.TEXT),
                "text": text, "props": props, "clientSeq": op_id}

    def insert_marker_local(self, pos: int,
                            props: Optional[dict] = None) -> Dict[str, Any]:
        self._check_pos(pos)
        self.client_seq += 1
        seg = self.tree.insert(
            pos, SegmentKind.MARKER, "", SEQ_UNASSIGNED, self.client_id,
            LOCAL_VIEW, props=props, local_op=self.client_seq,
            handle=self._op_handle(self.client_id, self.client_seq),
        )
        self.last_delta = {"operation": "insert", "segments": [seg]}
        op_id = self._record_pending("insert")
        return {"mt": "insert", "pos": pos, "kind": int(SegmentKind.MARKER),
                "text": "", "props": props, "clientSeq": op_id}

    def remove_range_local(self, start: int, end: int) -> Dict[str, Any]:
        self._check_range(start, end)
        self.client_seq += 1
        marked = self.tree.mark_range_removed(
            start, end, SEQ_UNASSIGNED, self.client_id, LOCAL_VIEW,
            local_op=self.client_seq,
        )
        self.last_delta = {"operation": "remove", "segments": marked}
        op_id = self._record_pending("remove")
        return {"mt": "remove", "start": start, "end": end, "clientSeq": op_id}

    def annotate_range_local(self, start: int, end: int,
                             props: dict) -> Dict[str, Any]:
        self._check_range(start, end)
        self.client_seq += 1
        pairs = self.tree.annotate_range(
            start, end, props, SEQ_UNASSIGNED, self.client_id, LOCAL_VIEW,
            local_op=self.client_seq,
        )
        self.last_delta = {"operation": "annotate",
                           "segments": [s for s, _ in pairs],
                           "previous_properties": pairs}
        op_id = self._record_pending("annotate")
        return {"mt": "annotate", "start": start, "end": end, "props": props,
                "clientSeq": op_id}

    # ------------------------------------------------------- sequenced inbox

    def apply_msg(self, msg: SequencedDocumentMessage) -> None:
        """Process one sequenced op (reference: Client.applyMsg)."""
        assert msg.seq > self.last_processed_seq, "ops must arrive in seq order"
        if msg.type == MessageType.OP and msg.contents is not None:
            if msg.client_id == self.client_id:
                self._ack(msg)
            else:
                self._apply_remote(msg)
        self.last_processed_seq = msg.seq
        if msg.min_seq > self.tree.min_seq:
            self.tree.zamboni(msg.min_seq)

    def _ack(self, msg: SequencedDocumentMessage) -> None:
        op = msg.contents
        assert self.pending, "ack with no pending op"
        op_id, kind = self.pending.popleft()
        assert op_id == op["clientSeq"] and kind == op["mt"], (
            "sequenced echo out of order vs pending queue"
        )
        if kind == "insert":
            self.tree.ack_insert(op_id, msg.seq)
        elif kind == "remove":
            self.tree.ack_remove(op_id, msg.seq)
        elif kind == "annotate":
            self.tree.ack_annotate(op_id, msg.seq)

    def _apply_remote(self, msg: SequencedDocumentMessage) -> None:
        op = msg.contents
        if op["mt"] == "insert":
            seg = self.tree.insert(
                op["pos"], SegmentKind(op["kind"]), op["text"],
                msg.seq, msg.client_id, msg.ref_seq, props=op.get("props"),
                handle=self._op_handle(msg.client_id, op["clientSeq"]),
            )
            self.last_delta = {"operation": "insert", "segments": [seg]}
        elif op["mt"] == "remove":
            marked = self.tree.mark_range_removed(
                op["start"], op["end"], msg.seq, msg.client_id, msg.ref_seq,
            )
            self.last_delta = {"operation": "remove", "segments": marked}
        elif op["mt"] == "annotate":
            pairs = self.tree.annotate_range(
                op["start"], op["end"], op["props"], msg.seq, msg.client_id,
                msg.ref_seq,
            )
            self.last_delta = {"operation": "annotate",
                               "segments": [s for s, _ in pairs],
                               "previous_properties": pairs}
        else:
            raise ValueError(f"unknown merge-tree op {op['mt']!r}")

    # ------------------------------------------------- reconnect regeneration

    def set_client_id(self, new_client_id: int) -> None:
        """Adopt a reconnect's new client id (re-stamps pending segments)."""
        self.tree.set_local_client(new_client_id)
        self.client_id = new_client_id

    def _visible_at_local(self, seg, k: int) -> bool:
        return self.tree.visible_at_pending(seg, k)

    def regenerate_pending_ops(self, new_client_id=None):
        """Rebase every pending local op for resubmission on a new
        connection (reference: Client resubmit / segment-group regeneration;
        SURVEY.md §3.3 — correctness-critical). Returns
        ``{old_client_seq: [new op contents, ...]}`` in pending-FIFO order.

        Positions are recomputed per op from its *pending segments* in the
        local-seq perspective (acked state + earlier pending ops), so remote
        ops merged while offline are accounted for. One old op can become
        several (its segments were split apart by interleaved state) or none
        (its whole range was concurrently removed). Pending bookkeeping and
        segment stamps are renumbered onto fresh client seqs; with
        ``new_client_id`` the pending segments are re-stamped first (a new
        connection means a new client id)."""
        if new_client_id is not None:
            self.set_client_id(new_client_id)

        out = {}
        plans = []    # (old_id, kind, [(contents_sans_id, run_segments)])
        for k, kind in self.pending:
            plans.append((k, kind, self._regen_one(k, kind)))
        self.pending.clear()
        for k, kind, runs in plans:
            ops = []
            for contents, run_segs in runs:
                self.client_seq += 1
                nid = self.client_seq
                contents["clientSeq"] = nid
                for seg in run_segs:
                    if kind == "insert":
                        seg.local_insert_op = nid
                    elif kind == "remove":
                        seg.local_remove_op = nid
                    elif kind == "annotate":
                        seg.pending_annotates = [
                            (nid, p) if op_id == k else (op_id, p)
                            for op_id, p in seg.pending_annotates]
                self.pending.append((nid, kind))
                ops.append(contents)
            out[k] = ops
        return out

    def _regen_one(self, k: int, kind: str):
        """Plan the regenerated ops for pending op ``k``: contiguous runs of
        its segments in the perspective of op ``k``, with positions adjusted
        for this op's own earlier runs (receivers apply them first)."""
        runs = []
        pos = 0               # perspective-k prefix length at current segment
        cur = None            # (start_pos, segments) of the open run
        emitted = 0           # total length of earlier runs of this op

        def mine(seg) -> bool:
            if kind == "insert":
                return seg.local_insert_op == k
            if kind == "remove":
                return seg.local_remove_op == k \
                    and seg.removed_seq == SEQ_UNASSIGNED
            return any(op_id == k for op_id, _ in seg.pending_annotates) \
                and self._visible_at_local(seg, k)

        def close_run():
            nonlocal cur, emitted
            if cur is None:
                return
            start, segs = cur
            length = sum(s.length for s in segs)
            if kind == "insert":
                runs.append(({"mt": "insert", "pos": start + emitted,
                              "kind": int(segs[0].kind),
                              "text": "".join(s.text for s in segs),
                              "props": dict(segs[0].props) or None},
                             segs))
                emitted += length
            elif kind == "remove":
                runs.append(({"mt": "remove", "start": start - emitted,
                              "end": start - emitted + length}, segs))
                emitted += length
            else:
                props = next(p for op_id, p in segs[0].pending_annotates
                             if op_id == k)
                runs.append(({"mt": "annotate", "start": start,
                              "end": start + length, "props": props}, segs))
            cur = None

        for seg in self.tree.segments:
            if mine(seg):
                # a pending annotate may have split this insert's segments
                # and changed props on SOME pieces: coalescing across a
                # property boundary would stamp one piece's props over the
                # whole run (remotes would annotate text the originator
                # never did) — emit one insert op per property run instead
                if cur is not None and kind == "insert" \
                        and cur[1][-1].props != seg.props:
                    close_run()
                if cur is None:
                    cur = (pos, [seg])
                else:
                    cur[1].append(seg)
                # remove/annotate targets are perspective-k visible and
                # consume width; insert's own segments are not yet visible
                if kind != "insert":
                    pos += seg.length
            else:
                if self._visible_at_local(seg, k):
                    close_run()    # a visible foreign segment breaks the run
                    pos += seg.length
                # invisible segments (later pending ops) don't break runs
        close_run()
        return runs

    # ----------------------------------------------------------------- views

    def get_text(self) -> str:
        return self.tree.get_text()

    def get_length(self) -> int:
        return self.tree.get_length()
