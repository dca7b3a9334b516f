"""Mega-doc merge: one long document's segment axis split into shards.

Reference counterpart: ``fluidframework_tpu/ops/megadoc_kernel.py`` (the
mega tier, B8). There, each shard of a document's slot axis lives on its
own chip of a 1-D mesh, and per op the shards resolve the position with
two all-gathers: the shards' perspective-visible totals (their exclusive
prefix places the op), then each shard's (inside, candidate) owner flags.
Exactly one shard applies an insert; every shard splits and marks its
clipped slice of a remove or annotate.

On one card the shards are the CTAs of one thread-block cluster (hand
kernel K7, ``csrc/megadoc_apply.cu``), and the all-gathers are reads of the
neighbours' shared memory. ``apply_megadoc_batch`` dispatches: CUDA tensors
launch K7, CPU tensors run the plain version, never the one for the other.

Layout (the JAX layout): D mega-docs × n·S_local slots, shard-major (shard
r owns slots [r·S_local, (r+1)·S_local) of every plane), ``count`` and
``overflow`` per (doc, shard) as (D, n). The plain versions view the
planes as (D·n, S_local) rows and reuse the flat merge-tree math of
``merge_tree`` row by row; only position resolution looks across a doc's
rows. A shard whose slots fill sets its sticky (doc, shard) overflow flag:
the op was dropped there and the doc must be rebuilt from the log, not
rebalanced (``rebalance_megadoc`` refuses such state).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import NOT_REMOVED
from . import merge_tree
from .merge_tree import (
    FIELDS, PLANES, StringState, _insert_one, _range_one, _visible,
    _wrap_i32,
)
from .schema import OpKind
from .string_store import resolve_device

_I32 = torch.int32
_INS = int(OpKind.STR_INSERT)
_REM = int(OpKind.STR_REMOVE)
_ANN = int(OpKind.STR_ANNOTATE)
#: planes moved by the host rebalance and the snapshot
KEYS = PLANES + ("prop_val",)


def refuse_mesh(mesh) -> None:
    """K7 holds a mega doc inside one card's thread-block cluster: the
    mega tier across cards (a doc's shards on several cards) is ROADMAP
    B9."""
    if mesh is not None:
        raise ValueError("the mega tier does not shard over a mesh (K7 "
                         "holds a doc inside one card's cluster): ROADMAP "
                         "B9, the mega tier across cards")


class MegaCapacityError(ValueError):
    """A doc's live slots exceed its layout's n_shards × capacity a shard
    (``rebalance_megadoc`` cannot deal them out)."""


def create_megadoc_state(n_docs: int, capacity_per_shard: int,
                         n_shards: int = 8, n_props: int = 4,
                         device="cuda", mesh=None) -> StringState:
    """(D, n_shards·S_local) planes, ``count`` / ``overflow`` (D, n_shards),
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    refuse_mesh(mesh)
    st = StringState.create(n_docs, n_shards * capacity_per_shard, n_props,
                            device=resolve_device(device))
    st.count = torch.zeros((n_docs, n_shards), dtype=_I32,
                           device=st.seq.device)
    st.overflow = torch.zeros_like(st.count)
    return st


def _rows(state: StringState) -> dict:
    """The state's fields viewed as (D·n, S_local) rows (views, not
    copies: writes land in ``state``)."""
    D, n = state.count.shape
    S = state.seq.shape[1] // n
    K = state.prop_val.shape[2]
    s = {k: getattr(state, k).view(D * n, S) for k in PLANES}
    s["prop_val"] = state.prop_val.view(D * n, S, K)
    s["count"] = state.count.view(D * n)
    s["overflow"] = state.overflow.view(D * n)
    return s


def _unrows(s: dict, D: int, n: int) -> StringState:
    S = s["seq"].shape[1]
    K = s["prop_val"].shape[2]
    out = {k: s[k].reshape(D, n * S) for k in PLANES}
    out["prop_val"] = s["prop_val"].reshape(D, n * S, K)
    out["count"] = s["count"].reshape(D, n)
    out["overflow"] = s["overflow"].reshape(D, n)
    return StringState(**out)


def _first_shard(flags: torch.Tensor, n: int) -> torch.Tensor:
    """(D,) index of the first true shard of (D, n) ``flags``, else n."""
    iota = torch.arange(n, dtype=_I32, device=flags.device)[None, :]
    return torch.where(flags, iota, n).amin(dim=1)


def _apply_rows(s: dict, rows: torch.Tensor, fn, *args) -> None:
    """Run the row-wise merge-tree step ``fn`` on the shard rows ``rows``
    only (each row's result depends on that row alone) and write the
    results back into ``s`` in place."""
    if rows.numel() == 0:
        return
    out = fn({k: v[rows] for k, v in s.items()}, *(a[rows] for a in args))
    for k, v in s.items():
        v[rows] = out[k]


def apply_megadoc_plain(state: StringState, kind, a0, a1, a2, seq, client,
                        ref_seq) -> StringState:
    """The plain version: a loop over the op axis, vectorised over docs and
    shards (the insert runs on its owner's row, a range on the rows its
    clipped slice is not empty on). Returns a new state (the input is not
    modified)."""
    D, n = state.count.shape
    s = {k: v.clone() for k, v in _rows(state).items()}
    S = s["seq"].shape[1]
    dev = state.seq.device
    shard = torch.arange(n, dtype=_I32, device=dev).repeat(D)  # (D·n,)
    iota = torch.arange(S, dtype=_I32, device=dev)[None, :]
    ops = [torch.as_tensor(x, device=dev).to(_I32)
           for x in (kind, a0, a1, a2, seq, client, ref_seq)]
    for o in range(ops[0].shape[1]):
        # every shard of a doc sees the doc's op
        k, p0, p1, p2, sq, cl, rs = (
            x[:, o].repeat_interleave(n) for x in ops)
        is_ins = k == _INS
        is_rng = (k == _REM) | (k == _ANN)
        if not bool((is_ins | is_rng).any()):
            continue
        vis = _visible(s, rs, cl)
        pl = torch.where(vis, s["length"], 0)
        local_vis = pl.sum(dim=1, dtype=_I32)
        # the first all-gather: shard totals → exclusive prefix
        tot = local_vis.view(D, n)
        ex = (torch.cumsum(tot, dim=1, dtype=_I32) - tot).reshape(D * n)
        if bool(is_ins.any()):
            gp = ex[:, None] + (torch.cumsum(pl, dim=1, dtype=_I32) - pl)
            inside = (vis & (gp < p0[:, None])
                      & (p0[:, None] < gp + s["length"])).any(dim=1)
            cand = ((iota < s["count"][:, None])
                    & (gp >= p0[:, None])).any(dim=1)
            # the second all-gather: the owner is the first shard strictly
            # containing pos, else the first with a candidate slot at or
            # past it, else the last shard
            inside, cand = inside.view(D, n), cand.view(D, n)
            owner = torch.where(
                inside.any(dim=1), _first_shard(inside, n),
                torch.where(cand.any(dim=1), _first_shard(cand, n), n - 1))
            owns = shard == owner.repeat_interleave(n)
            _apply_rows(s, torch.nonzero(is_ins & owns).squeeze(1),
                        lambda r, *a: _insert_one(r, *a, True),
                        p0 - ex, p1, p2, sq, cl, rs)
        if bool(is_rng.any()):
            l0 = torch.minimum(torch.clamp(p0 - ex, min=0), local_vis)
            l1 = torch.minimum(torch.clamp(p1 - ex, min=0), local_vis)
            _apply_rows(s, torch.nonzero(is_rng & (l1 > l0)).squeeze(1),
                        lambda r, *a: _range_one(r, *a, True),
                        k, l0, l1, p2, sq, cl, rs)
    return _unrows(s, D, n)


def apply_megadoc_batch(state: StringState, kind, a0, a1, a2, seq, client,
                        ref_seq) -> StringState:
    """Apply a dense (D, O) sequenced batch to D mega-docs IN PLACE and
    return the state. CUDA tensors launch K7 (``megadoc_apply``); CPU
    tensors run ``apply_megadoc_plain``. Every tensor must be int32,
    contiguous and on the state's device."""
    ops = (kind, a0, a1, a2, seq, client, ref_seq)
    dev = state.seq.device
    if dev.type == "cuda":
        from . import megadoc_apply
        megadoc_apply.launch(state, *ops)
        return state
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    out = apply_megadoc_plain(state, *ops)
    for k in FIELDS:
        getattr(state, k).copy_(getattr(out, k))
    return state


def compact_megadoc(state: StringState, min_seq) -> StringState:
    """Distributed zamboni: every shard drops its own tombstones acked at
    or below ``min_seq`` (D,) with the flat stable partition; slots never
    cross shards. Returns a new state."""
    D, n = state.count.shape
    ms = torch.as_tensor(min_seq, device=state.seq.device).to(_I32)
    rows = _rows(state)
    flat = merge_tree.compact_string_state(
        StringState(**rows), ms.repeat_interleave(n))
    return _unrows(flat.fields(), D, n)


def megadoc_digest(state: StringState) -> torch.Tensor:
    """(D,) content digest of each mega-doc, equal to
    ``string_state_digest`` of the same content held unsharded: each
    shard's visible prefix starts at the exclusive prefix of the shards'
    live totals. Wraps like int32."""
    D, n = state.count.shape
    s = _rows(state)
    S = s["seq"].shape[1]
    active = torch.arange(S, device=state.seq.device)[None, :] < \
        s["count"][:, None]
    live = active & (s["removed_seq"] == NOT_REMOVED)
    pl = torch.where(live, s["length"], 0)
    tot = pl.sum(dim=1, dtype=_I32).view(D, n)
    ex = (torch.cumsum(tot, dim=1, dtype=_I32) - tot).reshape(D * n)
    pre = torch.cumsum(pl, dim=1, dtype=_I32) - pl + ex[:, None]
    # int64 products keep the low 32 bits exact; the cast back wraps
    mix = (s["handle_op"].long() * 1000003
           + (s["handle_off"] - pre).long() * 8191) * pl.long()
    part = torch.where(live, mix, 0).sum(dim=1) + pl.long().sum(dim=1)
    return _wrap_i32(part.view(D, n).sum(dim=1))


def _to_numpy(state: StringState) -> dict:
    return {k: getattr(state, k).cpu().numpy() for k in FIELDS}


def _from_numpy(arrays: dict, device) -> StringState:
    return StringState(**{k: torch.as_tensor(np.asarray(arrays[k], np.int32))
                          .to(device).contiguous() for k in FIELDS})


def rebalance_megadoc(state: StringState) -> StringState:
    """Host-side preemptive rebalance (call while shards have headroom):
    each doc's shard-local active runs, concatenated in shard order (the
    document order), are dealt back out evenly across the shards; the
    first ``total % n`` shards take one more. Tombstones move with their
    neighbours. Returns a new state on the same device.

    Raises on sticky overflow: ops were dropped, and the doc must be
    rebuilt from the log instead (a rebalance would erase the evidence);
    raises ``MegaCapacityError`` when a doc's live slots exceed n × S."""
    if bool(state.overflow.any()):
        raise ValueError(
            "mega-doc state has sticky overflow: ops were dropped; drain "
            "the affected docs through the oracle and rebuild — rebalance "
            "cannot recover them")
    D, n = state.count.shape
    S = state.seq.shape[1] // n
    arrays = _to_numpy(state)
    count = arrays["count"]
    new = {k: np.zeros_like(arrays[k]) for k in KEYS}
    new["removed_seq"][:] = NOT_REMOVED
    new_count = np.zeros((D, n), np.int32)
    for d in range(D):
        cat = {k: np.concatenate([arrays[k][d, s * S: s * S + count[d, s]]
                                  for s in range(n)]) for k in KEYS}
        tot = len(cat["seq"])
        base, extra = divmod(tot, n)
        off = 0
        for s in range(n):
            c = base + (1 if s < extra else 0)
            if c > S:
                raise MegaCapacityError(f"doc {d}: {tot} live slots exceed "
                                        f"mesh capacity {n * S}")
            for k in KEYS:
                new[k][d, s * S: s * S + c] = cat[k][off:off + c]
            new_count[d, s] = c
            off += c
    return _from_numpy(dict(new, count=new_count,
                            overflow=np.zeros((D, n), np.int32)),
                       state.seq.device)


def visible_runs(state: StringState):
    """Host-side order-sensitive content oracle: per doc, the (handle_op,
    handle_off, length, props) runs of live segments in document order,
    adjacent pieces of one insert with equal properties coalesced (so the
    result does not depend on split history). Takes both layouts: flat
    (count (D,)) and mega (count (D, n), slots shard-major)."""
    count = state.count.cpu().numpy()
    n_shards = 1 if count.ndim == 1 else count.shape[1]
    count = count.reshape(count.shape[0], n_shards)
    planes = {k: getattr(state, k).cpu().numpy() for k in
              ("removed_seq", "handle_op", "handle_off", "length")}
    props = state.prop_val.cpu().numpy()
    S = planes["length"].shape[1] // n_shards
    docs = []
    for d in range(count.shape[0]):
        runs = []
        for s in range(n_shards):
            lo = s * S
            for i in range(lo, lo + count[d, s]):
                if planes["removed_seq"][d, i] != NOT_REMOVED:
                    continue
                op = int(planes["handle_op"][d, i])
                off = int(planes["handle_off"][d, i])
                ln = int(planes["length"][d, i])
                pv = tuple(int(x) for x in props[d, i])
                if runs and runs[-1][0] == op and \
                        runs[-1][1] + runs[-1][2] == off and \
                        runs[-1][3] == pv:
                    runs[-1] = (op, runs[-1][1], runs[-1][2] + ln, pv)
                else:
                    runs.append((op, off, ln, pv))
        docs.append(runs)
    return docs
