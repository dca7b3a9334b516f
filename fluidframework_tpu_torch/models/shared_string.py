"""SharedString: collaborative rich text (text + markers + annotations +
interval collections) as a channel.

Reference counterpart: ``@fluidframework/sequence`` ``SharedString`` /
``SharedSegmentSequence`` (SURVEY.md §2.2; mount empty). A thin facade: the
merge semantics live in ``merge_tree.py`` (via ``SequenceClient``), interval
semantics in ``interval_collection.py``; this class does channel plumbing —
op routing, summaries, and the public text API.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..core.protocol import SequencedDocumentMessage
from .interval_collection import IntervalCollection
from .merge_tree import LOCAL_VIEW, MergeTree, SlidePolicy
from .merge_tree_client import SequenceClient
from .shared_object import SharedObject


class SharedString(SharedObject):
    TYPE = "sharedString"

    def __init__(self, object_id: str, client_id: int):
        super().__init__(object_id, client_id)
        self.client = SequenceClient(client_id)
        self._collections: Dict[str, IntervalCollection] = {}
        self._iv_clientseq = 0
        # per-FIELD shadow counts: (iid, field) -> in-flight local ops, where
        # field is "start", "end", or ("prop", key). A local change must only
        # shadow the fields it touches — swallowing a remote end-only change
        # because we have a start-only change in flight diverges replicas.
        self._iv_pending: Dict[tuple, int] = {}
        # FIFO of applied-at-submit flags for our in-flight delete/change ops
        import collections as _collections
        self._iv_applied = _collections.deque()
        # monotone ticket per local change so a deferred (not-applied-at-
        # submit) change cannot clobber a newer local change at its ack
        self._iv_ticket = 0
        self._iv_last_ticket: Dict[tuple, int] = {}
        # {old clientSeq: [regenerated ops]} during a reconnect resubmit
        self._regen_cache: Optional[Dict[int, list]] = None
        # most recent sequenceDelta (see _emit_delta)
        self.last_delta: Optional[dict] = None

    @property
    def tree(self) -> MergeTree:
        return self.client.tree

    # ------------------------------------------------------------- text API

    def insert_text(self, pos: int, text: str, props: Optional[dict] = None):
        self.submit_local_message(self.client.insert_text_local(pos, text, props))
        self._emit_delta(True)

    def insert_marker(self, pos: int, props: Optional[dict] = None):
        self.submit_local_message(self.client.insert_marker_local(pos, props))
        self._emit_delta(True)

    def remove_text(self, start: int, end: int):
        self.submit_local_message(self.client.remove_range_local(start, end))
        self._emit_delta(True)

    def annotate_range(self, start: int, end: int, props: dict):
        self.submit_local_message(self.client.annotate_range_local(start, end, props))
        self._emit_delta(True)

    def _emit_delta(self, local: bool) -> None:
        """Fire "sequenceDelta" with the segments the last op touched
        (reference: SharedSegmentSequence sequenceDelta events, which carry
        the merge-tree delta — what undo-redo and views subscribe to).
        The delta stays readable as ``last_delta`` (undo-redo reverts need
        the segment a revert-insert just created, to transfer tracking)."""
        delta, self.client.last_delta = self.client.last_delta, None
        if delta is not None:
            self.last_delta = delta
            self._emit("sequenceDelta", self, delta, local)

    def get_text(self) -> str:
        return self.client.get_text()

    def get_length(self) -> int:
        return self.client.get_length()

    def get_properties(self, pos: int) -> dict:
        seg, _ = self.tree.get_containing_segment(pos)
        return dict(seg.props) if seg else {}

    def create_local_reference_position(self, pos: int,
                                        policy: SlidePolicy = SlidePolicy.SLIDE):
        return self.tree.create_local_reference(pos, policy)

    def local_reference_to_position(self, ref) -> int:
        return self.tree.get_ref_position(ref)

    # ------------------------------------------------------------- intervals

    def get_interval_collection(self, label: str) -> "IntervalCollectionView":
        if label not in self._collections:
            self._collections[label] = IntervalCollection(label, self.tree)
        return IntervalCollectionView(self, self._collections[label])

    # -------------------------------------------------------------- op inbox

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        op = msg.contents
        if "mt" in op:
            if local:
                self.client._ack(msg)
            else:
                self.client._apply_remote(msg)
                self._emit_delta(False)
            self.client.last_processed_seq = msg.seq
            return
        if "iv" in op:
            self._process_interval(msg, op, local)
            return
        raise ValueError(f"unknown SharedString op {op!r}")

    @staticmethod
    def _change_fields(start, end, props) -> list:
        fields = []
        if start is not None:
            fields.append("start")
        if end is not None:
            fields.append("end")
        for k in (props or {}):
            fields.append(("prop", k))
        return fields

    def _process_interval(self, msg, op: dict, local: bool) -> None:
        coll = self._collections.setdefault(
            op["label"], IntervalCollection(op["label"], self.tree))
        kind = op["iv"]
        iid = op["id"]
        if kind == "add":
            if local:
                return  # created at submit time
            coll.apply_add(iid, op["start"], op["end"], op.get("props"),
                           msg.ref_seq, msg.client_id)
        elif kind == "delete":
            if local:
                applied, _ = self._iv_applied.popleft()
                if not applied:
                    # our delete targeted an interval whose add was still in
                    # flight at submit; the add has since applied — delete now
                    coll.apply_delete(iid)
                for key in [k for k in self._iv_pending if k[0] == iid]:
                    del self._iv_pending[key]
                return
            coll.apply_delete(iid)
        elif kind == "change":
            fields = self._change_fields(op.get("start"), op.get("end"),
                                         op.get("props"))
            if local:
                applied, meta = self._iv_applied.popleft()
                if not applied:
                    self._attach_deferred_change(coll, iid, op, meta)
                for f in fields:
                    n = self._iv_pending.get((iid, f), 0) - 1
                    if n <= 0:
                        self._iv_pending.pop((iid, f), None)
                    else:
                        self._iv_pending[(iid, f)] = n
                return
            # per-field shadowing: an in-flight local change only wins for
            # the fields it actually touches
            start = op.get("start") \
                if (iid, "start") not in self._iv_pending else None
            end = op.get("end") \
                if (iid, "end") not in self._iv_pending else None
            props = {k: v for k, v in (op.get("props") or {}).items()
                     if (iid, ("prop", k)) not in self._iv_pending}
            if start is not None or end is not None or props:
                coll.apply_change(iid, start, end, props or None,
                                  msg.ref_seq, msg.client_id)

    def _attach_deferred_change(self, coll, iid, op, meta) -> None:
        """Ack of a change whose target's add was in flight at submit: attach
        the anchors pre-resolved then (localOpMetadata), per field, unless a
        newer local change already defined that field (ticket check)."""
        sref, eref, props, ticket = meta
        iv = coll.get(iid)

        def drop(ref):
            if ref is not None:
                self.tree.remove_local_reference(ref)

        if iv is None:  # deleted by an earlier-sequenced op
            drop(sref)
            drop(eref)
            return
        if sref is not None:
            if self._iv_last_ticket.get((iid, "start"), -1) > ticket:
                drop(sref)
            else:
                self.tree.remove_local_reference(iv.start)
                iv.start = sref
                self._iv_last_ticket[(iid, "start")] = ticket
        if eref is not None:
            if self._iv_last_ticket.get((iid, "end"), -1) > ticket:
                drop(eref)
            else:
                self.tree.remove_local_reference(iv.end)
                iv.end = eref
                self._iv_last_ticket[(iid, "end")] = ticket
        for k, v in (props or {}).items():
            if self._iv_last_ticket.get((iid, ("prop", k)), -1) > ticket:
                continue
            self._iv_last_ticket[(iid, ("prop", k))] = ticket
            if v is None:
                iv.props.pop(k, None)
            else:
                iv.props[k] = v

    def on_min_seq(self, min_seq: int) -> None:
        if min_seq > self.tree.min_seq:
            self.tree.zamboni(min_seq)

    # ----------------------------------------------------- reconnect rebasing

    def on_client_id_changed(self, new_client_id: int) -> None:
        super().on_client_id_changed(new_client_id)
        self.client.set_client_id(new_client_id)

    def rebase_op(self, contents: dict):
        """Reconnect resubmission (§3.3, correctness-critical): merge-tree
        ops are regenerated from their pending segments — positions
        re-resolved against everything merged while offline, one op per
        contiguous surviving run (an op whose whole range was concurrently
        removed drops). Interval ops re-resolve endpoints from their local
        references. The runtime drains pending records in FIFO order, so the
        first merge-tree record triggers one whole-queue regeneration."""
        if "mt" in contents:
            if self._regen_cache is None:
                self._regen_cache = self.client.regenerate_pending_ops()
            ops = self._regen_cache.pop(contents["clientSeq"], None)
            assert ops is not None, "rebase for unknown pending op"
            if not self._regen_cache:
                self._regen_cache = None
            return ops or None
        if "iv" in contents:
            return self._rebase_interval(contents)
        return contents

    def _rebase_interval(self, op: dict):
        if op["iv"] == "delete":
            return op
        coll = self._collections.get(op["label"])
        iv = coll.get(op["id"]) if coll is not None else None
        if iv is None:
            # add whose interval was deleted locally while in flight: the
            # delete op follows in the queue; resend the add as recorded
            return op if op["iv"] == "add" else None
        start, end = coll.endpoints(iv)
        out = dict(op)
        if op["iv"] == "add":
            out["start"], out["end"] = start, end
        else:  # change: only re-resolve the fields the op touches
            if op.get("start") is not None:
                out["start"] = start
            if op.get("end") is not None:
                out["end"] = end
        return out

    # ------------------------------------------------------------- summaries

    def summarize(self) -> dict:
        tree_summary = self.tree.summarize()
        # intervals summarize by their current resolved positions
        collections = {}
        for label, coll in self._collections.items():
            collections[label] = [
                {"id": iid, "start": coll.endpoints(iv)[0],
                 "end": coll.endpoints(iv)[1], "props": dict(iv.props)}
                for iid, iv in sorted(coll.intervals.items())
            ]
        return {"type": self.TYPE, "tree": tree_summary,
                "collections": collections}

    def on_loaded(self, base_seq: int) -> None:
        # keep the inner merge-tree client's seq mirror (maintained by
        # process_core on every op) consistent with the summary's base:
        # its value stamps ref_seq on locally-submitted ops
        self.client.last_processed_seq = base_seq

    def load_core(self, summary: dict) -> None:
        self.client.tree = MergeTree.load(summary["tree"], self.client_id)
        for label, items in summary.get("collections", {}).items():
            coll = IntervalCollection(label, self.tree)
            self._collections[label] = coll
            for rec in items:
                coll.apply_add(rec["id"], rec["start"], rec["end"],
                               rec["props"], self.tree.min_seq, self.client_id)


class IntervalCollectionView:
    """Mutating facade bound to one SharedString replica (submits ops)."""

    def __init__(self, owner: SharedString, coll: IntervalCollection):
        self._owner = owner
        self._coll = coll

    def add(self, start: int, end: int, props: Optional[dict] = None) -> str:
        o = self._owner
        o._iv_clientseq += 1
        iid = f"iv-{o.client_id}-{o._iv_clientseq}"
        self._coll.apply_add(iid, start, end, props, ref_seq=LOCAL_VIEW,
                             client=o.client_id)
        o.submit_local_message({"iv": "add", "label": self._coll.label,
                                "id": iid, "start": start, "end": end,
                                "props": props})
        return iid

    def delete(self, interval_id: str) -> None:
        applied = self._coll.apply_delete(interval_id)
        self._owner._iv_applied.append((applied, None))
        self._owner.submit_local_message(
            {"iv": "delete", "label": self._coll.label, "id": interval_id})

    def change(self, interval_id: str, start: Optional[int] = None,
               end: Optional[int] = None, props: Optional[dict] = None) -> None:
        o = self._owner
        o._iv_ticket += 1
        ticket = o._iv_ticket
        fields = o._change_fields(start, end, props)
        applied = self._coll.apply_change(interval_id, start, end, props,
                                          ref_seq=LOCAL_VIEW, client=o.client_id)
        if applied:
            for f in fields:
                o._iv_last_ticket[(interval_id, f)] = ticket
            o._iv_applied.append((True, None))
        else:
            # target's add op still in flight: pre-resolve anchors in today's
            # view so the ack can attach them without re-resolving positions
            sref = (self._coll._anchor(start, LOCAL_VIEW, o.client_id)
                    if start is not None else None)
            eref = (self._coll._anchor(end, LOCAL_VIEW, o.client_id)
                    if end is not None else None)
            o._iv_applied.append((False, (sref, eref, props, ticket)))
        for f in fields:
            o._iv_pending[(interval_id, f)] = \
                o._iv_pending.get((interval_id, f), 0) + 1
        o.submit_local_message({"iv": "change", "label": self._coll.label,
                                "id": interval_id, "start": start, "end": end,
                                "props": props})

    def get(self, interval_id: str):
        return self._coll.get(interval_id)

    def endpoints(self, interval_id: str):
        return self._coll.endpoints(self._coll.intervals[interval_id])

    def find_overlapping(self, start: int, end: int):
        return list(self._coll.find_overlapping(start, end))

    def __len__(self):
        return len(self._coll)

    def digest(self):
        return self._coll.digest()
