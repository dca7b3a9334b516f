"""IntervalCollection: named, sliding ranges over a collaborative sequence.

Reference counterpart: ``@fluidframework/sequence`` ``IntervalCollection`` /
``SequenceInterval`` (SURVEY.md §2.2; mount empty): intervals anchor their
endpoints as local references on merge-tree segments, so they follow the text
through remote edits and slide when their anchor text is removed.

Convergence: add/change/delete ops ride the same sequenced stream as text ops.
Endpoint positions in an op are resolved in the op's (refSeq, client)
perspective, which lands on the same segment+offset on every replica; a change
op is last-sequenced-writer-wins with in-flight local changes shadowing remote
ones (same pattern as SharedMap keys).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

from .merge_tree import LocalReference, MergeTree, SlidePolicy, _visible


@dataclasses.dataclass
class SequenceInterval:
    interval_id: str
    start: LocalReference
    end: LocalReference
    props: dict


class IntervalCollection:
    def __init__(self, label: str, tree: MergeTree):
        self.label = label
        self.tree = tree
        self.intervals: Dict[str, SequenceInterval] = {}

    # ------------------------------------------------------------ resolution

    def _anchor(self, pos: int, ref_seq: int, client: int) -> LocalReference:
        seg, offset = self.tree.get_containing_segment(pos, ref_seq, client)
        if seg is None:
            # endpoint at (or beyond) doc end in this perspective: anchor to
            # the last segment visible in that perspective; failing that, the
            # last *acked* segment (replica-invariant — the raw physical tail
            # can be a replica-local pending segment); failing that, detach
            from ..core.constants import SEQ_UNASSIGNED
            last = None
            for s in self.tree.segments:
                if _visible(s, ref_seq, client):
                    last = s
            if last is None:
                for s in self.tree.segments:
                    if s.seq != SEQ_UNASSIGNED:
                        last = s
            if last is None:
                return LocalReference(None, 0, SlidePolicy.SLIDE)
            seg, offset = last, max(last.length - 1, 0)
        ref = LocalReference(seg, offset, SlidePolicy.SLIDE)
        seg.refs.append(ref)
        return ref

    def _drop(self, iv: SequenceInterval) -> None:
        self.tree.remove_local_reference(iv.start)
        self.tree.remove_local_reference(iv.end)

    # ------------------------------------------------- op apply (both sides)

    def apply_add(self, interval_id: str, start: int, end: int, props: dict,
                  ref_seq: int, client: int) -> SequenceInterval:
        iv = SequenceInterval(
            interval_id,
            self._anchor(start, ref_seq, client),
            self._anchor(end, ref_seq, client),
            dict(props or {}),
        )
        self.intervals[interval_id] = iv
        return iv

    def apply_delete(self, interval_id: str) -> bool:
        iv = self.intervals.pop(interval_id, None)
        if iv is not None:
            self._drop(iv)
        return iv is not None

    def apply_change(self, interval_id: str, start: Optional[int],
                     end: Optional[int], props: Optional[dict],
                     ref_seq: int, client: int) -> bool:
        iv = self.intervals.get(interval_id)
        if iv is None:
            # interval unknown: either deleted by an earlier-sequenced op, or
            # (on the originator) its add op is still in flight — the caller
            # decides whether to retry at ack
            return False
        if start is not None:
            self.tree.remove_local_reference(iv.start)
            iv.start = self._anchor(start, ref_seq, client)
        if end is not None:
            self.tree.remove_local_reference(iv.end)
            iv.end = self._anchor(end, ref_seq, client)
        if props:
            for k, v in props.items():
                if v is None:
                    iv.props.pop(k, None)
                else:
                    iv.props[k] = v
        return True

    # ----------------------------------------------------------------- reads

    def get(self, interval_id: str) -> Optional[SequenceInterval]:
        return self.intervals.get(interval_id)

    def endpoints(self, iv: SequenceInterval) -> Tuple[int, int]:
        return (
            self.tree.get_ref_position(iv.start),
            self.tree.get_ref_position(iv.end),
        )

    def find_overlapping(self, start: int, end: int) -> Iterator[SequenceInterval]:
        for iv in self.intervals.values():
            s, e = self.endpoints(iv)
            if s <= end and start <= e:
                yield iv

    def __len__(self) -> int:
        return len(self.intervals)

    def digest(self) -> tuple:
        """Canonical (id, start, end, props) tuple set for convergence checks."""
        out = []
        for iid in sorted(self.intervals):
            iv = self.intervals[iid]
            s, e = self.endpoints(iv)
            out.append((iid, s, e, tuple(sorted(iv.props.items()))))
        return tuple(out)
