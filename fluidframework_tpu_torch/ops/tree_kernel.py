"""Batched SharedTree record scan: many tree documents on the device.

Port of ``fluidframework_tpu/ops/tree_kernel.py``. Representation (D docs ×
N node slots, eight int32 planes; slot 0 of every doc is the root, whose id
handle is ``ROOT_HANDLE``):

- ``node_id``  interned id handle (0 = free slot). A slot's index carries no
  meaning: sibling order is a doubly linked list (``prev_sib`` /
  ``next_sib`` id handles, 0 = end), so an insert-after is a splice;
- ``parent`` / ``field``  attachment (id handle / field-name handle);
- ``value`` / ``type_``   last-writer-wins value handle / node type handle;
- ``created_seq``         the sequenced op that created the slot (the
  nested-insert dependency test).

A batch is dense (D, O) record planes (kind, node, parent, after, field,
value, type_, seq, meta), each doc's records in sequence order, NOOP
padded. Per record: group flags (``INS_BEGIN`` / ``TXN_BEGIN`` reset them,
``INS_GUARD_ABSENT`` / ``TXN_GUARD_EXISTS`` AND them, solo kinds ignore
them), insert into the lowest free slot (an insert that finds none sets the
doc's sticky overflow flag and leaves it unchanged), remove of a whole
subtree, move unless it would make a cycle, last-writer-wins setValue. The
flags reset to 1 at the start of every apply call, so callers never split
an op across calls.

``apply_tree_batch`` / ``apply_tree_planes`` / ``apply_tree_wire`` /
``expand_tree_wire`` are the plain PyTorch versions (the CPU tests hold
them against the JAX functions bit for bit): vectorised over docs, a
Python loop over record columns. ``apply_tree_planes_fused`` /
``apply_tree_wire_fused`` / ``expand_tree_wire_fused`` are the entry
points: on CUDA tensors they launch the hand kernels of
``csrc/tree_apply.cu`` (K5 ``tree_apply``, K6 ``tree_expand``, through
``tree_apply``) and update the state IN PLACE; on CPU tensors they run the
plain version and copy it into the state. There is no switch and no
fallback.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import torch

from . import tree_apply
from .merge_tree import _wrap_i32

_I32 = torch.int32


class TreeOpKind(enum.IntEnum):
    NOOP = 0
    INS_BEGIN = 1         # reset ok_ins
    INS_GUARD_ABSENT = 2  # ok_ins &= (node absent)
    TXN_BEGIN = 3         # reset ok_txn and ok_ins
    TXN_GUARD_EXISTS = 4  # ok_txn &= (node present)
    INSERT = 5            # meta bit 0: nested (parent.created_seq == seq)
    REMOVE = 6
    MOVE = 7
    SET_VALUE = 8
    # solo kinds: a complete one-record op, the base kind's math (solo - 4)
    # without the group flags
    INSERT_SOLO = 9
    REMOVE_SOLO = 10
    MOVE_SOLO = 11
    SET_SOLO = 12
    # fused TXN_BEGIN + TXN_GUARD_EXISTS(node)
    TXN_BEGIN_EXISTS = 13


META_NESTED = 1

ROOT_HANDLE = 1  # every doc's root node id handle (the interner reserves it)

TREE_PLANES = ("node_id", "parent", "field", "value", "type_",
               "prev_sib", "next_sib", "created_seq")

_INSERT = int(TreeOpKind.INSERT)
_REMOVE = int(TreeOpKind.REMOVE)
_MOVE = int(TreeOpKind.MOVE)
_SET = int(TreeOpKind.SET_VALUE)
# (docs × N × N) elements per chunk of the plain subtree closure
_SUBTREE_CHUNK = 1 << 22


@dataclasses.dataclass
class TreeState:
    """D documents × N node slots: eight int32 (D, N) planes and a (D,)
    sticky overflow flag, on one device."""

    node_id: torch.Tensor
    parent: torch.Tensor
    field: torch.Tensor
    value: torch.Tensor
    type_: torch.Tensor
    prev_sib: torch.Tensor
    next_sib: torch.Tensor
    created_seq: torch.Tensor
    overflow: torch.Tensor

    @staticmethod
    def create(n_docs: int, capacity: int, device="cuda") -> "TreeState":
        z = lambda: torch.zeros((n_docs, capacity), dtype=_I32,  # noqa
                                device=device)
        st = TreeState(**{k: z() for k in TREE_PLANES},
                       overflow=torch.zeros((n_docs,), dtype=_I32,
                                            device=device))
        st.node_id[:, 0] = ROOT_HANDLE
        return st

    def fields(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in TREE_PLANES + ("overflow",)}

    def clone(self) -> "TreeState":
        return TreeState(**{k: v.clone() for k, v in self.fields().items()})


# ----------------------------------------------------------- per-doc math
# Helpers take a dict ``s`` of (d, N) planes and (d,) scalars, one per doc.

def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


def _exists(s, nid):
    """Is id handle ``nid`` present (and non-zero)?"""
    return (nid != 0) & (s["node_id"] == _col(nid)).any(dim=1)


def _slot_value(s, nid, plane):
    """plane[slot_of(nid)] as a masked sum (0 when absent)."""
    return _wrap_i32(torch.where(s["node_id"] == _col(nid), s[plane],
                                 0).sum(dim=1))


def _subtree_mask(s, nid):
    """(d, N) bool: slots inside the subtree rooted at id ``nid`` — the JAX
    fixpoint: a live slot joins when its parent's id is marked, one (N × N)
    compare per wave, until no doc's mark changes."""
    live = s["node_id"] != 0
    mark = live & (s["node_id"] == _col(nid))
    has_parent = live & (s["parent"] != 0)
    ids = s["node_id"][:, None, :]
    par = s["parent"][:, :, None]
    while True:
        hit = (mark[:, None, :] & (ids == par)).any(dim=2)
        new = mark | (has_parent & hit)
        if torch.equal(new, mark):
            return mark
        mark = new


def _splice_out(s, nid):
    """Unlink ``nid`` from its sibling list; its own attachment planes reset
    (a detached node must match no head or anchor search)."""
    prev = _slot_value(s, nid, "prev_sib")
    nxt = _slot_value(s, nid, "next_sib")
    me = s["node_id"] == _col(nid)
    out = dict(s)
    out["next_sib"] = torch.where(
        (s["node_id"] == _col(prev)) & _col(prev != 0), _col(nxt),
        s["next_sib"])
    out["prev_sib"] = torch.where(
        (s["node_id"] == _col(nxt)) & _col(nxt != 0), _col(prev),
        s["prev_sib"])
    for k in ("parent", "field", "prev_sib", "next_sib"):
        out[k] = torch.where(me, 0, out[k])
    return out


def _head_of(s, parent, field):
    """Id handle of the first child in (parent, field), else 0."""
    is_head = (s["node_id"] != 0) & (s["parent"] == _col(parent)) & \
        (s["field"] == _col(field)) & (s["prev_sib"] == 0)
    return _wrap_i32(torch.where(is_head, s["node_id"], 0).sum(dim=1))


def _attach(s, nid, parent, field, after):
    """Splice ``nid`` (already in a slot) after a live same-(parent, field)
    anchor, else at the field's head."""
    anchor_ok = (after != 0) & _exists(s, after) & \
        (_slot_value(s, after, "parent") == parent) & \
        (_slot_value(s, after, "field") == field)
    prev = torch.where(anchor_ok, after, 0)
    nxt = torch.where(anchor_ok, _slot_value(s, after, "next_sib"),
                      _head_of(s, parent, field))
    nxt = torch.where(nxt == nid, 0, nxt)  # self-link guard (fresh head)
    out = dict(s)
    me = s["node_id"] == _col(nid)
    out["parent"] = torch.where(me, _col(parent), s["parent"])
    out["field"] = torch.where(me, _col(field), s["field"])
    out["prev_sib"] = torch.where(me, _col(prev), s["prev_sib"])
    out["next_sib"] = torch.where(me, _col(nxt), s["next_sib"])
    out["next_sib"] = torch.where(
        (s["node_id"] == _col(prev)) & _col(prev != 0), _col(nid),
        out["next_sib"])
    out["prev_sib"] = torch.where(
        (s["node_id"] == _col(nxt)) & _col(nxt != 0), _col(nid),
        out["prev_sib"])
    return out


def _pick(do, a, b):
    """Per doc: ``a``'s planes where ``do``, else ``b``'s."""
    return {k: torch.where(_col(do), a[k], b[k]) for k in TREE_PLANES}


def _apply_insert(s, node, parent, after, field, value, type_, seq, nested,
                  ok):
    """(new planes, would_overflow)."""
    parent_ok = _exists(s, parent) | (parent == ROOT_HANDLE)
    dep_ok = torch.where(
        nested, _slot_value(s, parent, "created_seq") == seq, True)
    do = ok & parent_ok & ~_exists(s, node) & dep_ok & (node != 0)
    n = s["node_id"].shape[1]
    idx = torch.arange(n, dtype=_I32, device=node.device)[None, :]
    slot = torch.where(s["node_id"] == 0, idx, n).min(dim=1).values
    would_overflow = do & (slot >= n)
    do = do & (slot < n)
    is_slot = (idx == _col(slot)) & _col(do)
    out = dict(s)
    for k, v in (("node_id", node), ("value", value), ("type_", type_),
                 ("created_seq", seq)):
        out[k] = torch.where(is_slot, _col(v), s[k])
    for k in ("prev_sib", "next_sib", "parent", "field"):
        out[k] = torch.where(is_slot, 0, s[k])
    return _pick(do, _attach(out, node, parent, field, after), s), \
        would_overflow


def _apply_set_value(s, node, value, ok):
    do = ok & _exists(s, node)
    out = dict(s)
    out["value"] = torch.where(_col(do) & (s["node_id"] == _col(node)),
                               _col(value), s["value"])
    return out


def _apply_structural(s, base, node, parent, after, field, ok):
    """Remove and move for docs whose record is one of them (``base`` is
    REMOVE or MOVE for every doc given): both start from the subtree of
    ``node`` on the state before the record."""
    is_rem = base == _REMOVE
    mask = _subtree_mask(s, node)
    live = _exists(s, node) & (node != ROOT_HANDLE)
    in_subtree = (mask & (s["node_id"] == _col(parent))).any(dim=1)
    do_rem = ok & is_rem & live
    do_mov = ok & ~is_rem & live & _exists(s, parent) & ~in_subtree
    spliced = _splice_out(s, node)
    rem = {k: torch.where(mask, 0, spliced[k]) for k in TREE_PLANES}
    mov = _attach(spliced, node, parent, field, after)
    return _pick(do_rem, rem, _pick(do_mov, mov, s))


def apply_tree_batch(state: TreeState, kind, node, parent, after, field,
                     value, type_, seq, meta) -> TreeState:
    """Plain version: a new state after a dense (D, O) batch of records,
    per doc in column order (NOOP pads skip). The input state is not
    modified. Structural columns (remove / move) run only on the docs
    that have one, in chunks of docs, so the (N × N) closure stays
    bounded."""
    dev = state.node_id.device
    ops = [torch.as_tensor(x, device=dev).to(_I32)
           for x in (kind, node, parent, after, field, value, type_, seq,
                     meta)]
    s = {k: getattr(state, k).clone() for k in TREE_PLANES}
    overflow = state.overflow.clone()
    D, N = state.node_id.shape
    ok_ins = torch.ones(D, dtype=torch.bool, device=dev)
    ok_txn = torch.ones(D, dtype=torch.bool, device=dev)
    K = TreeOpKind
    for o in range(ops[0].shape[1]):
        k, nd, pa, af, fi, va, ty, sq, me = (x[:, o].contiguous()
                                             for x in ops)
        if not bool((k != K.NOOP).any()):
            continue
        solo = (k >= K.INSERT_SOLO) & (k <= K.SET_SOLO)
        base = torch.where(solo, k - 4, k)
        begin = (base == K.TXN_BEGIN) | (base == K.TXN_BEGIN_EXISTS)
        ok_ins = torch.where((base == K.INS_BEGIN) | begin, True, ok_ins)
        ok_txn = torch.where(begin, True, ok_txn)
        guard = base == K.INS_GUARD_ABSENT
        if bool(guard.any()):
            ok_ins = torch.where(guard, ok_ins & ~_exists(s, nd), ok_ins)
        guard = (base == K.TXN_GUARD_EXISTS) | (base == K.TXN_BEGIN_EXISTS)
        if bool(guard.any()):
            ok_txn = torch.where(guard, ok_txn & _exists(s, nd), ok_txn)
        ok = (ok_ins & ok_txn) | solo
        # every doc changes under at most one kind per column, so the
        # kinds apply one after the other, each masked to its docs
        is_ins = base == _INSERT
        if bool(is_ins.any()):
            s, would = _apply_insert(s, nd, pa, af, fi, va, ty, sq,
                                     (me & META_NESTED) != 0, ok & is_ins)
            overflow = torch.where(would, 1, overflow)
        is_set = base == _SET
        if bool(is_set.any()):
            s = _apply_set_value(s, nd, va, ok & is_set)
        heavy = torch.nonzero((base == _REMOVE) | (base == _MOVE))[:, 0]
        step = max(_SUBTREE_CHUNK // (N * N), 1)
        for c0 in range(0, len(heavy), step):
            idx = heavy[c0:c0 + step]
            sub = _apply_structural(
                {key: v[idx] for key, v in s.items()}, base[idx], nd[idx],
                pa[idx], af[idx], fi[idx], ok[idx])
            for key in TREE_PLANES:
                s[key][idx] = sub[key]
    return TreeState(**s, overflow=overflow)


def apply_tree_planes(state: TreeState, planes) -> TreeState:
    """Plain version of the stacked entry: ``planes`` is one (9, D, O)
    int32 buffer in plane order kind, node, parent, after, field, value,
    type_, meta, seq."""
    p = planes
    return apply_tree_batch(state, p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                            p[8], p[7])


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with out-of-range indices clamped to the last entry
    (XLA's gather semantics)."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def expand_tree_wire(cols, ids, vals, row, pos, id_map, f_map, t_map, v_map,
                     n_docs: int, o: int) -> torch.Tensor:
    """Plain version of K6: the width-coded wire (``tree_store.
    pack_wire_records``) expanded into dense (9, D, o) int32 planes in
    ``apply_tree_planes`` order, plane 8 holding each record's
    first-of-op bit instead of its seq. A record lands at (row, pos); one
    with ``pos >= o`` or ``row >= D`` is dropped (the padding)."""
    dev = id_map.device
    c = cols.to(dev).long()
    i = ids.to(dev).long()
    kind = c[:, 0] & 0xF
    meta = c[:, 0] >> 4
    stacked = torch.stack([
        kind, _gather(id_map, i[:, 0]), _gather(id_map, i[:, 1]),
        _gather(id_map, i[:, 2]), _gather(f_map, c[:, 1]),
        _gather(v_map, vals.to(dev).long()), _gather(t_map, c[:, 2]),
        meta & 1, (meta >> 1) & 1]).to(_I32)
    r = row.to(dev).long()
    p = pos.to(dev).long()
    keep = (p < o) & (r < n_docs)
    dense = torch.zeros((9, n_docs, o), dtype=_I32, device=dev)
    dense[:, r[keep], p[keep]] = stacked[:, keep]
    return dense


def wire_seq(first: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Per-record seq of the wire: each doc's first op seq plus the running
    count of first-of-op bits, minus one (int32, wrapping)."""
    return _wrap_i32(base.long()[:, None] + torch.cumsum(first.long(),
                                                         dim=1) - 1)


def apply_tree_wire(state: TreeState, cols, ids, vals, row, pos, base,
                    id_map, f_map, t_map, v_map, *, o: int) -> TreeState:
    """Plain version of the compact-wire apply: expand, derive each
    record's seq from ``base`` (D,), apply."""
    D = state.node_id.shape[0]
    dense = expand_tree_wire(cols, ids, vals, row, pos, id_map, f_map,
                             t_map, v_map, D, o)
    seq = wire_seq(dense[8], torch.as_tensor(base).to(dense.device))
    return apply_tree_batch(state, dense[0], dense[1], dense[2], dense[3],
                            dense[4], dense[5], dense[6], seq, dense[7])


def gather_tree_rows(state: TreeState, rows) -> tuple:
    """The given doc rows' eight planes and overflow (incremental
    summary)."""
    idx = torch.as_tensor(rows, device=state.node_id.device).long()
    return tuple(getattr(state, k)[idx] for k in TREE_PLANES) + \
        (state.overflow[idx],)


def write_tree_rows(state: TreeState, rows, *planes_and_overflow) -> None:
    """Overwrite the given doc rows IN PLACE (delta restore; duplicate
    padding rows write identical values)."""
    dev = state.node_id.device
    idx = torch.as_tensor(rows, device=dev).long()
    for k, v in zip(TREE_PLANES + ("overflow",), planes_and_overflow):
        getattr(state, k)[idx] = torch.as_tensor(v).to(device=dev,
                                                       dtype=_I32)


def tree_state_digest(state: TreeState) -> torch.Tensor:
    """(D,) structural digest, invariant to slot layout: each live node's
    (id, parent, field, prev, value, type) mixed, int32 wrap-around."""
    live = state.node_id != 0
    mix = (state.node_id.long() * 1000003 + state.parent.long() * 8191 +
           state.field.long() * 131071 + state.prev_sib.long() * 524287 +
           state.value.long() * 8209 + state.type_.long() * 127)
    return _wrap_i32(torch.where(live, mix, 0).sum(dim=1) +
                     live.long().sum(dim=1))


# ------------------------------------------------------------ entry points

def _check_state(state: TreeState) -> None:
    D, N = state.node_id.shape
    for k, v in state.fields().items():
        want = (D,) if k == "overflow" else (D, N)
        if v.dtype != _I32:
            raise TypeError(f"state {k} must be int32, got {v.dtype}")
        if tuple(v.shape) != want:
            raise ValueError(f"state {k} shape {tuple(v.shape)} != {want}")
        if v.device != state.node_id.device:
            raise ValueError(f"state {k} on {v.device}")


def _check_planes(state: TreeState, planes: torch.Tensor) -> None:
    _check_state(state)
    D = state.node_id.shape[0]
    if planes.dtype != _I32:
        raise TypeError(f"record planes must be int32, got {planes.dtype}")
    if planes.dim() != 3 or planes.shape[0] != 9 or planes.shape[1] != D:
        raise ValueError(f"record planes shape {tuple(planes.shape)} != "
                         f"(9, {D}, O)")
    if planes.device != state.node_id.device:
        raise ValueError(f"record planes on {planes.device}, state on "
                         f"{state.node_id.device}")


_WIRE_DTYPES = {"cols": (torch.uint8,), "ids": (torch.uint16, torch.uint32),
                "vals": (torch.uint16, torch.uint32), "row": (torch.uint16,),
                "pos": (torch.uint8, torch.uint16)}


def _check_wire(cols, ids, vals, row, pos, maps) -> None:
    """The wire's lanes at their shipped widths, the maps int32, all on the
    maps' device."""
    R = cols.shape[0]
    shapes = {"cols": (R, 3), "ids": (R, 3), "vals": (R,), "row": (R,),
              "pos": (R,)}
    dev = maps[0].device
    for name, t in zip(("cols", "ids", "vals", "row", "pos"),
                       (cols, ids, vals, row, pos)):
        if t.dtype not in _WIRE_DTYPES[name]:
            raise TypeError(f"wire {name} must be one of "
                            f"{_WIRE_DTYPES[name]}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"wire {name} shape {tuple(t.shape)} != "
                             f"{shapes[name]}")
        if t.device != dev:
            raise ValueError(f"wire {name} on {t.device}, maps on {dev}")
    for m in maps:
        if m.dtype != _I32 or m.dim() != 1 or m.shape[0] < 1:
            raise TypeError("wire maps must be non-empty 1-D int32")
        if m.device != dev:
            raise ValueError(f"a wire map on {m.device}, another on {dev}")


def _copy_into(state: TreeState, out: TreeState) -> TreeState:
    for k, v in state.fields().items():
        v.copy_(getattr(out, k))
    return state


def apply_tree_planes_fused(state: TreeState,
                            planes: torch.Tensor) -> TreeState:
    """Apply one (9, D, O) int32 record buffer to ``state`` IN PLACE and
    return it: K5 (planes mode) on a CUDA state, the plain version on a
    CPU state."""
    _check_planes(state, planes)
    if state.node_id.device.type == "cpu":
        return _copy_into(state, apply_tree_planes(state, planes))
    tree_apply.launch_apply(state, planes.contiguous(), None)
    return state


def expand_tree_wire_fused(cols, ids, vals, row, pos, id_map, f_map, t_map,
                           v_map, n_docs: int, o: int) -> torch.Tensor:
    """The wire expanded into a fresh (9, D, o) buffer on the maps'
    device: K6 on the card (one launch, which writes every cell of the
    uninitialised buffer), the plain version on the CPU."""
    _check_wire(cols, ids, vals, row, pos, (id_map, f_map, t_map, v_map))
    if id_map.device.type == "cpu":
        return expand_tree_wire(cols, ids, vals, row, pos, id_map, f_map,
                                t_map, v_map, n_docs, o)
    out = torch.empty((9, n_docs, o), dtype=_I32, device=id_map.device)
    tree_apply.launch_expand(cols, ids, vals, row, pos, id_map, f_map,
                             t_map, v_map, out)
    return out


def apply_tree_wire_fused(state: TreeState, cols, ids, vals, row, pos, base,
                          id_map, f_map, t_map, v_map, *,
                          o: int) -> TreeState:
    """The compact-wire apply IN PLACE: K6 then K5 (wire mode: each
    record's seq is derived inside the scan from ``base``) on a CUDA
    state, the plain version on a CPU state. Every tensor lies on the
    state's device."""
    _check_state(state)
    _check_wire(cols, ids, vals, row, pos, (id_map, f_map, t_map, v_map))
    D = state.node_id.shape[0]
    if state.node_id.device.type == "cpu":
        return _copy_into(state, apply_tree_wire(
            state, cols, ids, vals, row, pos, base, id_map, f_map, t_map,
            v_map, o=o))
    dense = expand_tree_wire_fused(cols, ids, vals, row, pos, id_map, f_map,
                                   t_map, v_map, D, o)
    tree_apply.launch_apply(state, dense, base)
    return state
