"""Oracle MergeTree: the collaborative-sequence CRDT core, exact Fluid semantics.

Reference counterpart: ``@fluidframework/merge-tree`` (``MergeTree``,
``Client``, ``LocalReferenceCollection``, zamboni) — SURVEY.md §2.1/§3.2.
Semantics follow upstream-documented behavior; this module is the host
oracle every client replica runs, and the executable spec that the batched
(doc × segment) apply — ``ops/merge_tree.py`` and its hand kernel
``csrc/string_apply.cu`` — is held against. Clarity over speed: a flat
segment list with O(n) walks, not the reference's B-tree (a pointer-chase
optimization the batched device state does without); the oracle only needs
to be obviously correct.

Merge semantics implemented (the parts that make concurrent edits converge):

- Every segment is stamped (seq, client); removal stamps (removedSeq, removers).
  A pending local op holds ``SEQ_UNASSIGNED`` until its sequenced echo acks it.
- Positions in an op are interpreted in the op's *perspective*
  ``(refSeq, client)``: a segment counts iff it was inserted at ``seq <= refSeq``
  or by ``client`` itself, and not removed in that same perspective.
- Concurrent-insert tie-break at one boundary position: the new segment is
  placed *before* the first existing segment whose effective seq is lower, and
  *after* segments whose effective seq is higher, where pending local segments
  rank above all acked ones and the newest op ranks above earlier pending ones.
  Consequences (the observable Fluid behaviors): a later-sequenced concurrent
  insert at the same position lands to the left of an earlier-sequenced one;
  a remote op lands to the right of the applying replica's own pending inserts
  at that position; two local inserts at the same position stack leftward
  ("insert a at 0, insert b at 0" reads "ba").
- Overlapping removes keep the earliest acked removedSeq and accumulate all
  removing clients.
- Annotate is last-sequenced-writer-wins per property key; pending local
  annotations are re-applied on ack so they beat earlier-sequenced remote
  annotations that arrived in between.
- Zamboni: once minSeq passes a removal, the tombstone is physically deleted
  (local references slide per their policy) and adjacent same-era segments are
  coalesced.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..core.constants import SEQ_UNASSIGNED, SEQ_UNIVERSAL, NO_CLIENT

# Perspective refSeq meaning "the local view": every acked op is visible.
LOCAL_VIEW = 2**31 - 1

# Effective-seq ranks for the insert tie-break (see module docstring).
_EFF_NEW_LOCAL = 2**62       # the op being inserted, when it is a pending local op
_EFF_PENDING = 2**62 - 1     # an existing pending local segment


class SegmentKind(enum.IntEnum):
    TEXT = 0
    MARKER = 1  # length-1 out-of-band marker (reference: merge-tree Marker)


class SlidePolicy(enum.IntEnum):
    """What a local reference does when its segment is removed.

    Reference: merge-tree ``ReferenceType`` / SlideOnRemove | StayOnRemove.
    """

    SLIDE = 0   # slide to the nearest following live position (default)
    STAY = 1    # keep reporting the position where the segment used to be
    TRANSIENT = 2


class TrackingGroup:
    """A membership set over segments that survives splits and zamboni.

    Reference: merge-tree ``TrackingGroup`` / ``TrackingGroupCollection`` —
    the mechanism undo-redo revertibles use to keep hold of the exact
    segments an op touched: a split adds the right half to every group the
    left half is in, and zamboni neither frees nor coalesces a tracked
    segment (a tracked tombstone must stay restorable). Local-session state:
    never serialized into summaries.
    """

    def __init__(self):
        self.segments: List["Segment"] = []
        # per-segment metadata owned by the group's owner (e.g. undo-redo
        # keeps an annotate's previous property values here); follows
        # splits and replace() so it survives segment identity changes
        self.meta: dict = {}

    def link(self, seg: "Segment") -> None:
        if self not in seg.tracking:
            seg.tracking.append(self)
            self.segments.append(seg)

    def _link_after(self, anchor: "Segment", seg: "Segment") -> None:
        seg.tracking.append(self)
        self.segments.insert(self.segments.index(anchor) + 1, seg)
        if id(anchor) in self.meta:  # a split half carries the same meta
            self.meta[id(seg)] = self.meta[id(anchor)]

    def unlink(self, seg: "Segment") -> None:
        if self in seg.tracking:
            seg.tracking.remove(self)
            self.segments.remove(seg)
            self.meta.pop(id(seg), None)

    def replace(self, old: "Segment", new: "Segment") -> None:
        """Swap membership (and meta) from ``old`` to ``new`` in place —
        used when a revert re-inserts a tombstone's content as a fresh
        segment that should inherit the tombstone's tracked role."""
        idx = self.segments.index(old)
        old.tracking.remove(self)
        self.segments[idx] = new
        new.tracking.append(self)
        if id(old) in self.meta:
            self.meta[id(new)] = self.meta.pop(id(old))

    def clear(self) -> None:
        for seg in self.segments:
            seg.tracking.remove(self)
        self.segments = []
        self.meta = {}

    def __len__(self) -> int:
        return len(self.segments)


@dataclasses.dataclass(eq=False)  # identity equality: two refs at the same
class LocalReference:             # spot are still distinct anchors
    """A position anchored to (segment, offset) that survives remote edits.

    Reference: merge-tree ``LocalReferenceCollection`` / ``LocalReferencePosition``.
    """

    segment: Optional["Segment"]  # None = detached (document start)
    offset: int
    policy: SlidePolicy = SlidePolicy.SLIDE
    properties: Optional[dict] = None


@dataclasses.dataclass(eq=False)  # identity equality (segments are places)
class Segment:
    kind: SegmentKind
    text: str                      # "" for markers
    seq: int                       # SEQ_UNASSIGNED while pending
    client: int
    removed_seq: Optional[int] = None   # None=live, SEQ_UNASSIGNED=pending local remove
    removers: List[int] = dataclasses.field(default_factory=list)
    props: Dict[str, Any] = dataclasses.field(default_factory=dict)
    refs: List[LocalReference] = dataclasses.field(default_factory=list)
    # pending-op bookkeeping (client_seq of the local op; None if not pending)
    local_insert_op: Optional[int] = None
    local_remove_op: Optional[int] = None
    pending_annotates: List[Tuple[int, dict]] = dataclasses.field(default_factory=list)
    # payload identity for the device/text side table: (op handle, split offset)
    handle: Tuple[int, int] = (0, 0)
    # tracking groups holding this segment (see TrackingGroup)
    tracking: List["TrackingGroup"] = dataclasses.field(default_factory=list)

    @property
    def length(self) -> int:
        return 1 if self.kind == SegmentKind.MARKER else len(self.text)


def _inserted_in_view(seg: Segment, ref_seq: int, client: int) -> bool:
    return (seg.seq != SEQ_UNASSIGNED and seg.seq <= ref_seq) or seg.client == client


def _removed_in_view(seg: Segment, ref_seq: int, client: int) -> bool:
    if seg.removed_seq is None:
        return False
    if seg.removed_seq != SEQ_UNASSIGNED and seg.removed_seq <= ref_seq:
        return True
    return client in seg.removers


def _visible(seg: Segment, ref_seq: int, client: int) -> bool:
    return _inserted_in_view(seg, ref_seq, client) and not _removed_in_view(
        seg, ref_seq, client
    )


def _eff_seq(seg: Segment) -> int:
    return _EFF_PENDING if seg.seq == SEQ_UNASSIGNED else seg.seq


class MergeTree:
    """Flat-list oracle merge tree for one collaborative sequence."""

    def __init__(self, local_client: int = NO_CLIENT):
        self.segments: List[Segment] = []
        self.local_client = local_client
        self.min_seq = 0

    # ------------------------------------------------------------------ views

    def visible_segments(self, ref_seq: int, client: int) -> Iterable[Segment]:
        for seg in self.segments:
            if _visible(seg, ref_seq, client):
                yield seg

    def get_length(self, ref_seq: int = LOCAL_VIEW, client: Optional[int] = None) -> int:
        client = self.local_client if client is None else client
        return sum(s.length for s in self.visible_segments(ref_seq, client))

    def get_text(self, ref_seq: int = LOCAL_VIEW, client: Optional[int] = None) -> str:
        client = self.local_client if client is None else client
        return "".join(
            s.text for s in self.visible_segments(ref_seq, client)
            if s.kind == SegmentKind.TEXT
        )

    def get_containing_segment(
        self, pos: int, ref_seq: int = LOCAL_VIEW, client: Optional[int] = None
    ) -> Tuple[Optional[Segment], int]:
        """Segment containing ``pos`` in the given perspective, with offset."""
        client = self.local_client if client is None else client
        cum = 0
        for seg in self.segments:
            if not _visible(seg, ref_seq, client):
                continue
            if cum + seg.length > pos:
                return seg, pos - cum
            cum += seg.length
        return None, 0

    def get_position(self, seg: Segment, offset: int = 0) -> int:
        """Current local-view position of a point inside ``seg``.

        If the segment is removed in the local view, SLIDE semantics apply:
        the position of the nearest following live character (or end of doc).
        """
        cum = 0
        found = None
        for s in self.segments:
            if s is seg:
                found = cum
                if _visible(s, LOCAL_VIEW, self.local_client):
                    return cum + min(offset, max(s.length - 1, 0))
                # removed: slide forward — current cum is already the slid pos
                return cum
            if _visible(s, LOCAL_VIEW, self.local_client):
                cum += s.length
        if found is None:
            raise ValueError("segment not in tree (already zamboni'd?)")
        return cum

    # ------------------------------------------------------------ mutation ops

    def _split(self, idx: int, offset: int) -> None:
        """Split segments[idx] at offset (0 < offset < length) into two."""
        seg = self.segments[idx]
        assert seg.kind == SegmentKind.TEXT and 0 < offset < seg.length
        right = Segment(
            kind=seg.kind,
            text=seg.text[offset:],
            seq=seg.seq,
            client=seg.client,
            removed_seq=seg.removed_seq,
            removers=list(seg.removers),
            props=dict(seg.props),
            local_insert_op=seg.local_insert_op,
            local_remove_op=seg.local_remove_op,
            pending_annotates=list(seg.pending_annotates),
            handle=(seg.handle[0], seg.handle[1] + offset),
        )
        seg.text = seg.text[:offset]
        moved = [r for r in seg.refs if r.offset >= offset]
        seg.refs = [r for r in seg.refs if r.offset < offset]
        for r in moved:
            r.segment = right
            r.offset -= offset
        right.refs = moved
        for group in seg.tracking:
            group._link_after(seg, right)
        self.segments.insert(idx + 1, right)

    def _find_insertion_index(
        self, pos: int, ref_seq: int, client: int, eff_new: int
    ) -> int:
        """Resolve ``pos`` in perspective to a concrete segment-list index,
        splitting a segment if ``pos`` falls strictly inside one, then applying
        the concurrent-insert tie-break among zero-perspective-length segments
        at the boundary."""
        if pos < 0:
            raise IndexError(f"negative position {pos}")
        remaining = pos
        i = 0
        while i < len(self.segments) and remaining > 0:
            seg = self.segments[i]
            seg_len = seg.length if _visible(seg, ref_seq, client) else 0
            if seg_len <= remaining:
                remaining -= seg_len
                i += 1
            else:
                self._split(i, remaining)
                remaining = 0
                i += 1
        if remaining > 0:
            raise IndexError(f"insert position {pos} beyond perspective length")
        # Tie-break: skip past segments whose effective seq outranks the new op
        # (replica-local pending segments when applying a remote op).
        while i < len(self.segments) and _eff_seq(self.segments[i]) > eff_new:
            i += 1
        return i

    def insert(
        self,
        pos: int,
        seg_kind: SegmentKind,
        text: str,
        seq: int,
        client: int,
        ref_seq: int,
        props: Optional[dict] = None,
        local_op: Optional[int] = None,
        handle: Tuple[int, int] = (0, 0),
    ) -> Segment:
        """Apply an insert op (remote sequenced, or local pending if
        ``seq == SEQ_UNASSIGNED``) in perspective ``(ref_seq, client)``."""
        eff_new = _EFF_NEW_LOCAL if seq == SEQ_UNASSIGNED else seq
        idx = self._find_insertion_index(pos, ref_seq, client, eff_new)
        seg = Segment(
            kind=seg_kind,
            text=text if seg_kind == SegmentKind.TEXT else "",
            seq=seq,
            client=client,
            props=dict(props) if props else {},
            local_insert_op=local_op,
            handle=handle,
        )
        self.segments.insert(idx, seg)
        return seg

    def _resolve_range(
        self, start: int, end: int, ref_seq: int, client: int
    ) -> List[Segment]:
        """Split at the range boundaries and return the visible segments fully
        inside ``[start, end)`` of the perspective."""
        if end <= start:
            return []
        # Split at start.
        cum = 0
        i = 0
        while i < len(self.segments):
            seg = self.segments[i]
            seg_len = seg.length if _visible(seg, ref_seq, client) else 0
            if seg_len and cum < start < cum + seg_len:
                self._split(i, start - cum)
                cum += start - cum
                i += 1
                break
            if cum + seg_len > start:
                break
            cum += seg_len
            i += 1
        # Walk to end, splitting the segment that straddles it.
        out: List[Segment] = []
        while i < len(self.segments) and cum < end:
            seg = self.segments[i]
            seg_len = seg.length if _visible(seg, ref_seq, client) else 0
            if seg_len == 0:
                i += 1
                continue
            if cum + seg_len > end:
                self._split(i, end - cum)
                seg = self.segments[i]  # left half, now fully inside
            out.append(seg)
            cum += seg.length
            i += 1
        if cum < end:
            raise IndexError(f"remove/annotate range [{start},{end}) beyond length")
        return out

    def mark_range_removed(
        self,
        start: int,
        end: int,
        seq: int,
        client: int,
        ref_seq: int,
        local_op: Optional[int] = None,
    ) -> List[Segment]:
        """Apply a remove op. Only segments *visible in the op's perspective*
        are marked — text inserted concurrently inside the range survives
        (reference behavior: a remove cannot remove what its client never saw).
        """
        marked = self._resolve_range(start, end, ref_seq, client)
        for seg in marked:
            if seg.removed_seq is None:
                seg.removed_seq = seq
            elif seq != SEQ_UNASSIGNED:
                # Overlapping concurrent removes: keep the earliest acked seq.
                if seg.removed_seq == SEQ_UNASSIGNED or seq < seg.removed_seq:
                    seg.removed_seq = seq
            if client not in seg.removers:
                seg.removers.append(client)
            if local_op is not None:
                seg.local_remove_op = local_op
        return marked

    def annotate_range(
        self,
        start: int,
        end: int,
        props: dict,
        seq: int,
        client: int,
        ref_seq: int,
        local_op: Optional[int] = None,
    ) -> List[Tuple[Segment, dict]]:
        """Apply an annotate op: per-key last-sequenced-writer-wins.
        A ``None`` value deletes the key (reference: annotate semantics).
        Returns (segment, previous values of the touched keys) pairs — the
        previous values are what an undo-redo revertible restores (a key
        absent before maps to None, so its revert deletes it)."""
        segs = self._resolve_range(start, end, ref_seq, client)
        out = []
        for seg in segs:
            prev = {k: seg.props.get(k) for k in props}
            for k, v in props.items():
                if v is None:
                    seg.props.pop(k, None)
                else:
                    seg.props[k] = v
            if local_op is not None:
                seg.pending_annotates.append((local_op, dict(props)))
            out.append((seg, prev))
        return out

    # ------------------------------------------------------------------- acks

    def ack_insert(self, local_op: int, seq: int) -> None:
        for seg in self.segments:
            if seg.client == self.local_client and seg.local_insert_op == local_op:
                assert seg.seq == SEQ_UNASSIGNED
                seg.seq = seq
                seg.local_insert_op = None

    def ack_remove(self, local_op: int, seq: int) -> None:
        for seg in self.segments:
            if seg.local_remove_op == local_op:
                if seg.removed_seq == SEQ_UNASSIGNED:
                    seg.removed_seq = seq
                else:
                    seg.removed_seq = min(seg.removed_seq, seq)
                seg.local_remove_op = None

    def ack_annotate(self, local_op: int, seq: int) -> None:
        # Re-apply our annotation so it beats earlier-sequenced remote
        # annotates that were applied while ours was in flight (LWW by seq).
        for seg in self.segments:
            kept = []
            for op_id, props in seg.pending_annotates:
                if op_id != local_op:
                    kept.append((op_id, props))
                    continue
                for k, v in props.items():
                    if v is None:
                        seg.props.pop(k, None)
                    else:
                        seg.props[k] = v
            seg.pending_annotates = kept

    # ------------------------------------------------------------ local refs

    def create_local_reference(
        self, pos: int, policy: SlidePolicy = SlidePolicy.SLIDE,
        properties: Optional[dict] = None,
    ) -> LocalReference:
        seg, offset = self.get_containing_segment(pos)
        if seg is None:
            # reference at document end: anchor to the last segment's end, or
            # to a detached "end" sentinel when the doc is empty
            if not self.segments:
                seg = Segment(SegmentKind.TEXT, "", SEQ_UNIVERSAL, NO_CLIENT)
                self.segments.append(seg)
            live = [s for s in self.segments
                    if _visible(s, LOCAL_VIEW, self.local_client)]
            seg = live[-1] if live else self.segments[-1]
            offset = max(seg.length - 1, 0)
        ref = LocalReference(seg, offset, policy, properties)
        seg.refs.append(ref)
        return ref

    def remove_local_reference(self, ref: LocalReference) -> None:
        if ref.segment is not None and ref in ref.segment.refs:
            ref.segment.refs.remove(ref)

    def get_ref_position(self, ref: LocalReference) -> int:
        """Current local-view position of a local reference (detached -> 0)."""
        if ref.segment is None:
            return 0
        return self.get_position(ref.segment, ref.offset)

    def _slide_refs(self, idx: int) -> None:
        """Move refs off segments[idx] before physical deletion (zamboni).

        SLIDE policy: to the start of the nearest following live segment, else
        the end of the nearest preceding live segment (reference:
        SlideOnRemove). Targets are chosen in the *acked* view — never a
        replica-local pending segment — so replicated anchors (interval
        endpoints) slide identically on every replica.
        """
        seg = self.segments[idx]
        if not seg.refs:
            return

        def acked_live(s: Segment) -> bool:
            return (
                s.seq != SEQ_UNASSIGNED
                and (s.removed_seq is None or s.removed_seq == SEQ_UNASSIGNED)
            )

        target = None
        t_off = 0
        for j in range(idx + 1, len(self.segments)):
            if acked_live(self.segments[j]):
                target, t_off = self.segments[j], 0
                break
        if target is None:
            for j in range(idx - 1, -1, -1):
                if acked_live(self.segments[j]):
                    target = self.segments[j]
                    t_off = max(target.length - 1, 0)
                    break
        for ref in seg.refs:
            if ref.policy == SlidePolicy.TRANSIENT:
                continue
            if target is None:
                # no acked content left anywhere: detach (reference parks at
                # the document start, like DetachedReferencePosition)
                ref.segment = None
                ref.offset = 0
                continue
            ref.segment = target
            ref.offset = t_off
            target.refs.append(ref)
        seg.refs = []

    # ---------------------------------------------------------------- zamboni

    def zamboni(self, min_seq: int) -> int:
        """Collaboration-window cleanup once minSeq advances (reference:
        merge-tree zamboni). Physically deletes tombstones whose removal is
        acked at or below ``min_seq`` and coalesces adjacent same-era live
        segments. Returns number of segments freed.

        Two phases: refs slide off every doomed segment FIRST (slide targets
        are acked-live segments, which are never doomed and at worst get
        coalesced later — coalescing migrates refs correctly), THEN the list
        is rebuilt. Sliding mid-rebuild could target a segment the same pass
        already coalesced away, leaving a dangling anchor."""
        self.min_seq = max(self.min_seq, min_seq)

        def _dead(seg: Segment) -> bool:
            return (
                seg.removed_seq is not None
                and seg.removed_seq != SEQ_UNASSIGNED
                and seg.removed_seq <= self.min_seq
                and seg.local_remove_op is None
                # a tracked tombstone stays restorable (undo-redo holds it)
                and not seg.tracking
            )

        for idx, seg in enumerate(self.segments):
            if _dead(seg):
                self._slide_refs(idx)

        freed = 0
        kept: List[Segment] = []
        for seg in self.segments:
            if _dead(seg):
                freed += 1
                continue
            prev = kept[-1] if kept else None
            if (
                prev is not None
                and prev.kind == SegmentKind.TEXT
                and seg.kind == SegmentKind.TEXT
                and prev.removed_seq is None
                and seg.removed_seq is None
                and prev.seq != SEQ_UNASSIGNED
                and seg.seq != SEQ_UNASSIGNED
                and prev.seq <= self.min_seq
                and seg.seq <= self.min_seq
                and not prev.pending_annotates
                and not seg.pending_annotates
                and not prev.tracking
                and not seg.tracking
                and prev.props == seg.props
                # only halves of the SAME insert op re-coalesce: handle[0] is
                # unique per insert (0 = unknown provenance, never merged)
                and prev.handle[0] != 0
                and prev.handle == (seg.handle[0], seg.handle[1] - len(prev.text))
            ):
                # coalesce: identical visibility for every future perspective
                for r in seg.refs:
                    r.segment = prev
                    r.offset += len(prev.text)
                    prev.refs.append(r)
                prev.text += seg.text
                prev.seq = max(prev.seq, seg.seq)
                freed += 1
                continue
            kept.append(seg)
        self.segments = kept
        return freed

    # ------------------------------------------------------------- snapshots

    def summarize(self) -> dict:
        """Serialize acked state at the current minSeq (reference: merge-tree
        snapshot — SnapshotLoader/SnapshotLegacy, SURVEY.md §2.1/§3.4).
        Pending local ops are NOT part of a summary."""
        out = []
        for seg in self.segments:
            if seg.seq == SEQ_UNASSIGNED:
                continue
            removed = (
                seg.removed_seq is not None and seg.removed_seq != SEQ_UNASSIGNED
            )
            out.append({
                "kind": int(seg.kind),
                "text": seg.text,
                "seq": seg.seq,
                "client": seg.client,
                "removedSeq": seg.removed_seq if removed else None,
                "removers": [c for c in seg.removers] if removed else [],
                "props": dict(seg.props),
                # payload identity: the matrix permutation axes encode
                # row/col KEYS through handles, so snapshots must carry them
                "handle": list(seg.handle),
            })
        return {"minSeq": self.min_seq, "segments": out}

    @classmethod
    def load(cls, summary: dict, local_client: int = NO_CLIENT) -> "MergeTree":
        tree = cls(local_client)
        tree.min_seq = summary["minSeq"]
        for rec in summary["segments"]:
            seg = Segment(
                kind=SegmentKind(rec["kind"]),
                text=rec["text"],
                seq=rec["seq"],
                client=rec["client"],
                removed_seq=rec["removedSeq"],
                removers=list(rec["removers"]),
                props=dict(rec["props"]),
                handle=tuple(rec.get("handle", (0, 0))),
            )
            tree.segments.append(seg)
        return tree

    def visible_at_pending(self, seg: "Segment", k: int) -> bool:
        """Visibility in the perspective a receiver will have when this
        client's pending op ``k`` applies after resubmission: everything
        acked, plus this client's pending ops with smaller local ids (they
        are resubmitted, and therefore sequenced, before op ``k``).
        Reconnect-critical logic shared by the sequence client and the
        matrix axes — must not fork."""
        inserted = seg.seq != SEQ_UNASSIGNED or (
            seg.local_insert_op is not None and seg.local_insert_op < k)
        if not inserted:
            return False
        if seg.removed_seq is None:
            return True
        if seg.removed_seq != SEQ_UNASSIGNED:
            return False                       # acked remove
        return not (seg.local_remove_op is not None
                    and seg.local_remove_op < k)

    def set_local_client(self, new_client_id: int) -> None:
        """Adopt a reconnect's new client id: re-stamp pending segments and
        pending removers (acked stamps are history and stay). Shared by
        SequenceClient.set_client_id and the matrix axes — reconnect-critical
        logic that must not fork."""
        old = self.local_client
        if new_client_id == old:
            return
        for seg in self.segments:
            if seg.client == old and seg.seq == SEQ_UNASSIGNED:
                seg.client = new_client_id
            if old in seg.removers and seg.removed_seq == SEQ_UNASSIGNED:
                seg.removers[seg.removers.index(old)] = new_client_id
        self.local_client = new_client_id

    def structure_digest(self) -> tuple:
        """Canonical digest of converged acked state, for cross-replica checks
        (the race-detection analog, SURVEY.md §5.2). Ignores pending local ops
        and physical split boundaries (coalesces), so two replicas that have
        processed the same sequenced prefix produce identical digests."""
        parts = []
        for seg in self.segments:
            if seg.seq == SEQ_UNASSIGNED:
                continue
            removed = (
                seg.removed_seq is not None and seg.removed_seq != SEQ_UNASSIGNED
            )
            if removed:
                continue
            props = tuple(sorted(seg.props.items()))
            if parts and parts[-1][0] == int(seg.kind) == int(SegmentKind.TEXT) \
                    and parts[-1][2] == props:
                parts[-1] = (parts[-1][0], parts[-1][1] + seg.text, props)
            else:
                parts = parts + [(int(seg.kind), seg.text, props)]
        return tuple(parts)
