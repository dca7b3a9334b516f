"""Batched merge-tree state and its plain PyTorch op-apply math.

Reference counterpart: ``@fluidframework/merge-tree`` ``insertSegments`` /
``markRangeRemoved`` / ``annotateRange``. A document's acked merge-tree is
S position-ordered segment slots held in int32 planes; the whole merge —
position resolution in the op's (refSeq, client) perspective, concurrent-
insert tie-break, segment splits, tombstoning with overlapping removes,
per-key last-writer-wins annotate — is (doc × segment) tensor math applied
one op column at a time, every document of the batch advanced together.

These are the PLAIN versions: ``apply_string_batch`` is a Python loop over
the op axis, vectorised over docs. The CPU tests run them against the JAX
package, ``ops/string_kernel.py`` serves CPU tensors with them, and the
card checks its hand-written kernel against them.

Invariants (shared with the kernel):

- **Acked-only state.** Every op has a real seq, so the reference's
  tie-break collapses to "insert at the leftmost slot whose perspective
  prefix equals the position".
- **Position-ordered dense slots.** Active segments occupy slots
  0..count-1. An insert shifts the WHOLE S-wide tail right by 1 (boundary)
  or 2 (split), dropping the last slot(s); a split shifts by 1. Slots below
  the cut are untouched.
- **Client indexes + remover bitmask.** Clients of a doc are interned to
  indexes 0..31; "removed by client c" is bit c of an int32 plane.
- **Payload handles.** Segments carry (handle_op, handle_off, length);
  text bytes never reach the device.
- **Overflow.** An op that would overflow S sets a sticky per-doc flag and
  leaves the doc unchanged. A range op whose first split succeeds and whose
  second overflows keeps the first split and still marks.
- **int32 wrap-around.** Prefix sums, digests and offsets wrap like int32;
  every torch reduction here passes ``dtype=torch.int32`` (torch promotes
  integer sums to int64 by default).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import NOT_REMOVED
from .schema import OpKind

MAX_CLIENTS = 32        # remover bitmask width (int32)
PROP_HANDLE_BITS = 20   # a2 of an annotate = key plane << 20 | value handle

PLANES = ("seq", "client", "removed_seq", "removers", "length",
          "handle_op", "handle_off")
FIELDS = PLANES + ("prop_val", "count", "overflow")
OP_FIELDS = ("kind", "a0", "a1", "a2", "seq", "client", "ref_seq")

_I32 = torch.int32
# 1 << c as int32 for c in 0..31 (bit 31 is the sign bit)
_CLIENT_BITS = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)
                             ).view(np.int32)


@dataclasses.dataclass
class StringState:
    """Device-resident acked merge-tree state for D docs × S segment slots.
    All fields are int32 tensors on one device."""

    seq: torch.Tensor          # (D, S) insert seq
    client: torch.Tensor       # (D, S) inserting client index
    removed_seq: torch.Tensor  # (D, S) NOT_REMOVED if live
    removers: torch.Tensor     # (D, S) bitmask of removing client indexes
    length: torch.Tensor       # (D, S) run length
    handle_op: torch.Tensor    # (D, S) payload table id
    handle_off: torch.Tensor   # (D, S) offset within the payload
    prop_val: torch.Tensor     # (D, S, K) value handle per property key
    count: torch.Tensor        # (D,) active slot count
    overflow: torch.Tensor     # (D,) sticky overflow flag

    @staticmethod
    def create(n_docs: int, capacity: int, n_props: int = 4,
               device="cuda") -> "StringState":
        def z(fill=0):
            return torch.full((n_docs, capacity), fill, dtype=_I32,
                              device=device)
        return StringState(
            seq=z(), client=z(), removed_seq=z(NOT_REMOVED), removers=z(),
            length=z(), handle_op=z(), handle_off=z(),
            prop_val=torch.zeros((n_docs, capacity, n_props), dtype=_I32,
                                 device=device),
            count=torch.zeros((n_docs,), dtype=_I32, device=device),
            overflow=torch.zeros((n_docs,), dtype=_I32, device=device))

    def fields(self) -> dict:
        return {k: getattr(self, k) for k in FIELDS}


def state_from_numpy(planes: dict, device="cuda") -> StringState:
    """Build a state from numpy arrays keyed by the ten field names (the
    layout both packages share; JAX arrays convert with ``np.asarray``)."""
    return StringState(**{k: torch.as_tensor(np.asarray(planes[k], np.int32))
                          .to(device).contiguous() for k in FIELDS})


def state_to_numpy(state: StringState) -> dict:
    """The ten fields as host numpy int32 arrays."""
    return {k: v.cpu().numpy() for k, v in state.fields().items()}


# ----------------------------------------------------------- per-op math
# Each helper advances every doc of the batch by one op column. ``s`` is a
# dict of the state's fields; per-doc op scalars are (D,) tensors.

def _iota(s):
    S = s["seq"].shape[1]
    return torch.arange(S, dtype=_I32, device=s["seq"].device)[None, :]


def _visible(s, ref_seq, client_idx):
    """(D, S) mask of slots visible in perspective (ref_seq, client_idx)."""
    active = _iota(s) < s["count"][:, None]
    ins = (s["seq"] <= ref_seq[:, None]) | \
        (s["client"] == client_idx[:, None])
    bit = (s["removers"] >> client_idx.clamp(0, MAX_CLIENTS - 1)[:, None]) & 1
    rem = (s["removed_seq"] <= ref_seq[:, None]) | \
        ((bit != 0) & (client_idx >= 0)[:, None])
    return active & ins & ~rem


def _prefix(s, vis):
    """(exclusive prefix, inclusive end) of visible lengths, int32-wrapped."""
    pl = torch.where(vis, s["length"], 0)
    cum = torch.cumsum(pl, dim=1, dtype=_I32)
    return cum - pl, cum


def _first(mask, iota, fallback):
    """Per-doc index of the first true slot, else ``fallback``."""
    return torch.where(mask, iota, fallback).amin(dim=1)


def _shift_right(x, by):
    """Roll the slot axis (dim 1) right by ``by`` (1 or 2) per doc."""
    r1 = torch.roll(x, 1, dims=1)
    r2 = torch.roll(x, 2, dims=1)
    sel = (by == 2).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(sel, r2, r1)


def _col(m):
    """(D,) mask → broadcastable over (D, S) or (D, S, K)."""
    return m[:, None]


def _insert_one(s, pos, length, handle, seq, client_idx, ref_seq,
                with_props):
    S = s["seq"].shape[1]
    i = _iota(s)
    vis = _visible(s, ref_seq, client_idx)
    pre, end = _prefix(s, vis)

    inside = vis & (pre < pos[:, None]) & (pos[:, None] < end)
    has_inside = inside.any(dim=1)
    j = _first(inside, i, S)                        # containing slot
    off = pos - torch.where(inside, pre, 0).sum(dim=1, dtype=_I32)
    bcand = (i < s["count"][:, None]) & (pre >= pos[:, None])
    idx_b = _first(bcand, i, s["count"][:, None])   # boundary slot
    shift = torch.where(has_inside, 2, 1).to(_I32)
    new_count = s["count"] + shift
    would_overflow = new_count > S

    new_slot = torch.where(has_inside, j + 1, idx_b)[:, None]
    is_new = i == new_slot
    is_right = _col(has_inside) & (i == new_slot + 1)   # split right piece
    is_left = _col(has_inside) & (i == j[:, None])      # split left piece
    below = i < new_slot

    out = {k: torch.where(below, s[k], _shift_right(s[k], shift))
           for k in PLANES}
    # the right piece already holds the containing slot's values (shift 2)
    off_c = off[:, None]
    out["length"] = torch.where(
        is_new, length[:, None],
        torch.where(is_left, off_c,
                    torch.where(is_right, out["length"] - off_c,
                                out["length"])))
    out["handle_off"] = torch.where(
        is_new, 0,
        torch.where(is_right, out["handle_off"] + off_c, out["handle_off"]))
    out["handle_op"] = torch.where(is_new, handle[:, None], out["handle_op"])
    out["seq"] = torch.where(is_new, seq[:, None], out["seq"])
    out["client"] = torch.where(is_new, client_idx[:, None], out["client"])
    out["removed_seq"] = torch.where(is_new, NOT_REMOVED, out["removed_seq"])
    out["removers"] = torch.where(is_new, 0, out["removers"])
    keys = PLANES
    if with_props:
        # new segments carry no props; the split right piece inherits
        pv = torch.where(below[:, :, None], s["prop_val"],
                         _shift_right(s["prop_val"], shift))
        out["prop_val"] = torch.where(is_new[:, :, None], 0, pv)
        keys = PLANES + ("prop_val",)

    res = dict(s)
    for k in keys:
        keep = _col(would_overflow)
        if k == "prop_val":
            keep = keep[:, :, None]
        res[k] = torch.where(keep, s[k], out[k])
    res["count"] = torch.where(would_overflow, s["count"], new_count)
    res["overflow"] = torch.where(would_overflow, 1, s["overflow"])
    return res


def _split_at(s, p, ref_seq, client_idx, with_props):
    """Split the visible segment strictly containing perspective position p
    (shift the tail right by 1)."""
    S = s["seq"].shape[1]
    i = _iota(s)
    vis = _visible(s, ref_seq, client_idx)
    pre, end = _prefix(s, vis)
    inside = vis & (pre < p[:, None]) & (p[:, None] < end)
    has_inside = inside.any(dim=1)
    j = _first(inside, i, S)[:, None]
    off = (p - torch.where(inside, pre, 0).sum(dim=1, dtype=_I32))[:, None]

    new_count = s["count"] + 1
    would_overflow = new_count > S
    do = has_inside & ~would_overflow

    keep = i <= j
    is_left = i == j
    is_right = i == j + 1
    out = {k: torch.where(keep, s[k], torch.roll(s[k], 1, dims=1))
           for k in PLANES}
    out["length"] = torch.where(
        is_left, off,
        torch.where(is_right, out["length"] - off, out["length"]))
    out["handle_off"] = torch.where(
        is_right, out["handle_off"] + off, out["handle_off"])
    keys = PLANES
    if with_props:
        out["prop_val"] = torch.where(keep[:, :, None], s["prop_val"],
                                      torch.roll(s["prop_val"], 1, dims=1))
        keys = PLANES + ("prop_val",)

    res = dict(s)
    for k in keys:
        sel = _col(do) if k != "prop_val" else do[:, None, None]
        res[k] = torch.where(sel, out[k], s[k])
    res["count"] = torch.where(do, new_count, s["count"])
    res["overflow"] = torch.where(has_inside & would_overflow, 1,
                                  s["overflow"])
    return res


def _range_one(s, kind, start, end_pos, packed, seq, client_idx, ref_seq,
               with_props):
    """One remove OR annotate: two splits at the perspective boundaries,
    then mark the visible segments strictly inside. Remove keeps the
    earliest removal seq and ORs in the remover bit; annotate overwrites the
    key's plane (scan order is seq order, so that is per-key LWW)."""
    s = _split_at(s, start, ref_seq, client_idx, with_props)
    s = _split_at(s, end_pos, ref_seq, client_idx, with_props)
    vis = _visible(s, ref_seq, client_idx)
    pre, endp = _prefix(s, vis)
    target = vis & (pre >= start[:, None]) & (endp <= end_pos[:, None]) & \
        (s["length"] > 0)

    bits = torch.as_tensor(_CLIENT_BITS, device=client_idx.device)
    bit = torch.where(client_idx >= 0,
                      bits[client_idx.clamp(0, MAX_CLIENTS - 1).long()], 0)
    rem = target & _col(kind == int(OpKind.STR_REMOVE))
    out = dict(s)
    out["removed_seq"] = torch.where(
        rem, torch.minimum(s["removed_seq"], seq[:, None]), s["removed_seq"])
    out["removers"] = torch.where(rem, s["removers"] | bit[:, None],
                                  s["removers"])
    if with_props:
        K = s["prop_val"].shape[2]
        key_idx = packed >> PROP_HANDLE_BITS
        handle = packed & ((1 << PROP_HANDLE_BITS) - 1)
        ann = target & _col(kind == int(OpKind.STR_ANNOTATE))
        keys = torch.arange(K, dtype=_I32, device=packed.device)
        sel = ann[:, :, None] & (keys[None, None, :] == key_idx[:, None, None])
        out["prop_val"] = torch.where(sel, handle[:, None, None],
                                      s["prop_val"])
    return out


def _pick(which, new, old):
    """Per-doc select between two state dicts."""
    out = {}
    for k, v in old.items():
        sel = which.view((-1,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(sel, new[k], v)
    return out


def apply_string_batch(state: StringState, kind, a0, a1, a2, seq, client,
                       ref_seq, with_props: bool = True) -> StringState:
    """Apply a dense (D, O) batch of sequenced merge-tree ops; returns a new
    state (the input is not modified).

    Per doc, ops apply in ascending op index. STR_INSERT: a0=pos, a1=len,
    a2=payload handle. STR_REMOVE: a0=start, a1=end. STR_ANNOTATE: a0=start,
    a1=end, a2=key plane << 20 | value handle. Any other kind (NOOP pads)
    leaves the doc untouched.

    ``with_props=False``: the caller guarantees no annotate ever touched
    this state, so the all-zero property planes are permutation-invariant
    and are not moved (annotates still split)."""
    s = state.fields()
    ops = [torch.as_tensor(x, device=state.seq.device).to(_I32)
           for x in (kind, a0, a1, a2, seq, client, ref_seq)]
    for o in range(ops[0].shape[1]):
        k, p0, p1, p2, sq, cl, rs = (x[:, o].contiguous() for x in ops)
        is_ins = k == int(OpKind.STR_INSERT)
        is_rng = (k == int(OpKind.STR_REMOVE)) | \
            (k == int(OpKind.STR_ANNOTATE))
        if bool(is_ins.any()):
            s = _pick(is_ins, _insert_one(s, p0, p1, p2, sq, cl, rs,
                                          with_props), s)
        if bool(is_rng.any()):
            s = _pick(is_rng, _range_one(s, k, p0, p1, p2, sq, cl, rs,
                                         with_props), s)
    return StringState(**s)


def compact_string_state(state: StringState, min_seq,
                         with_props: bool = True) -> StringState:
    """Zamboni: drop tombstones whose removal is acked at or below min_seq
    (D,), as a stable partition (kept slots first, in document order, then
    the dropped ones in order). Returns a new state."""
    S = state.seq.shape[1]
    dev = state.seq.device
    min_seq = torch.as_tensor(min_seq, device=dev).to(_I32)
    active = torch.arange(S, device=dev)[None, :] < state.count[:, None]
    keep = active & ~(state.removed_seq <= min_seq[:, None])
    order = torch.sort((~keep).to(_I32), dim=1, stable=True).indices
    out = {k: torch.gather(getattr(state, k), 1, order) for k in PLANES}
    if with_props:
        K = state.prop_val.shape[2]
        out["prop_val"] = torch.gather(
            state.prop_val, 1, order[:, :, None].expand(-1, -1, K))
    else:
        out["prop_val"] = state.prop_val.clone()  # all-zero: invariant
    out["count"] = keep.sum(dim=1, dtype=_I32)
    out["overflow"] = state.overflow.clone()
    return StringState(**out)


def string_state_digest(state: StringState) -> torch.Tensor:
    """(D,) int32 per-doc content digest, invariant to split boundaries: for
    a live run at visible position pos, (handle_off - pos) is the same for
    every piece of one insert. Wraps like int32 by design."""
    S = state.seq.shape[1]
    active = torch.arange(S, device=state.seq.device)[None, :] < \
        state.count[:, None]
    live = active & (state.removed_seq == NOT_REMOVED)
    pl = torch.where(live, state.length, 0)
    pre = torch.cumsum(pl, dim=1, dtype=_I32) - pl
    # int64 products keep the low 32 bits exact; the cast back wraps
    mix = (state.handle_op.long() * 1000003
           + (state.handle_off - pre).long() * 8191) * pl.long()
    mix = torch.where(live, mix, 0).sum(dim=1) + pl.long().sum(dim=1)
    return _wrap_i32(mix)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 keeping the low 32 bits (two's complement)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(_I32)
