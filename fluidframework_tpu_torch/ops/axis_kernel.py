"""SharedMatrix permutation axes on the device: merge + resolve.

Reference counterpart: ``@fluidframework/matrix`` PermutationVector — a
MergeTree whose "text" is the row/col key space. The axis state IS the
batched merge-tree state (one row per (doc, axis), no property planes),
and position→key resolution happens inside the scan that applies the axis
mutations: an ``AXIS_RESOLVE`` op computes, at its own (ref_seq, client)
perspective, the run handle and within-run offset of the slot containing a
position without mutating the state, and the scan emits them per op.

Key identity: an inserted run interns (mixed opKey, key_offset) to a run
handle (``handle_op``); ``handle_off`` accumulates across splits, so a
resolved (run, handle_off + within) maps host-side to exactly the
oracle's ``(seg.handle[0], seg.handle[1] + off)`` key tuple.

The plain versions (``apply_axis_batch``, ``resolve_axis_positions``,
``axis_visible_lengths``) are built on ``merge_tree``'s helpers; the CPU
tests hold them against the JAX package. On the card the two device
programs are hand kernels (``csrc/axis_apply.cu`` through ``axis_apply``):
K3 for a window with mutations, K4 for a resolve-only window. The visible
lengths (a masked row sum on the read path) and compaction stay plain
torch on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import axis_apply
from ..core.constants import NOT_REMOVED
from .merge_tree import (
    MAX_CLIENTS, OP_FIELDS, StringState, _insert_one, _pick, _prefix,
    _range_one, _visible, compact_string_state,
)
from .schema import OpKind
from .string_store import resolve_device
from ..parallel.sharded import (
    RowShardedStore, ShardedRows, shard_axis_store_state, shard_planes,
    shard_vector, sharded_axis_apply, store_shards,
)

_PLANES = ("seq", "client", "removed_seq", "removers", "length",
           "handle_op", "handle_off")
_I32 = torch.int32
_INS = int(OpKind.STR_INSERT)
_REM = int(OpKind.STR_REMOVE)
_RES = int(OpKind.AXIS_RESOLVE)
_NOOP = int(OpKind.NOOP)
# (D · O · S) elements per chunk of the plain resolve's broadcast planes
_RESOLVE_CHUNK = 1 << 24


def _resolve_one(s, pos, client_idx, ref_seq):
    """(run handle, run offset) per doc of the slot containing perspective
    position ``pos`` — (-1, -1) when out of range."""
    vis = _visible(s, ref_seq, client_idx)
    pre, end = _prefix(s, vis)
    inside = vis & (pre <= pos[:, None]) & (pos[:, None] < end)
    has = inside.any(dim=1)
    hop = torch.where(inside, s["handle_op"], 0).sum(dim=1, dtype=_I32)
    base = torch.where(inside, s["handle_off"], 0).sum(dim=1, dtype=_I32)
    preo = torch.where(inside, pre, 0).sum(dim=1, dtype=_I32)
    return (torch.where(has, hop, -1),
            torch.where(has, base + pos - preo, -1))


def apply_axis_batch(state: StringState, kind, a0, a1, a2, seq, client,
                     ref_seq):
    """Apply a dense (D, O) batch of axis ops; returns (state, res_run,
    res_off), the latter two (D, O) RESOLVE outputs (-1 at non-resolve
    slots and out-of-range resolves). The input state is not modified.

    STR_INSERT: a0=pos, a1=count, a2=run handle. STR_REMOVE: a0=start,
    a1=end. AXIS_RESOLVE: a0=pos (emits output, mutates nothing). An
    insert whose position exceeds its perspective's visible length is
    DROPPED (the oracle raises and the engine drops; appending would
    diverge). Every op sees the state its row's earlier ops left."""
    s = state.fields()
    ops = [torch.as_tensor(x, device=state.seq.device).to(_I32)
           for x in (kind, a0, a1, a2, seq, client, ref_seq)]
    D, O = ops[0].shape
    res_run = torch.full((D, O), -1, dtype=_I32, device=state.seq.device)
    res_off = res_run.clone()
    for o in range(O):
        k, p0, p1, p2, sq, cl, rs = (x[:, o].contiguous() for x in ops)
        is_ins = k == _INS
        if bool(is_ins.any()):
            vis = _visible(s, rs, cl)
            total = torch.where(vis, s["length"], 0).sum(dim=1, dtype=_I32)
            ok = is_ins & (p0 <= total)
            if bool(ok.any()):
                s = _pick(ok, _insert_one(s, p0, p1, p2, sq, cl, rs,
                                          with_props=False), s)
        is_rng = k == _REM
        if bool(is_rng.any()):
            s = _pick(is_rng, _range_one(s, k, p0, p1, p2, sq, cl, rs,
                                         with_props=False), s)
        is_res = k == _RES
        if bool(is_res.any()):
            # a resolve doc's row was not touched by this column's picks
            h, off = _resolve_one(s, p0, cl, rs)
            res_run[:, o] = torch.where(is_res, h, -1)
            res_off[:, o] = torch.where(is_res, off, -1)
    return StringState(**s), res_run, res_off


def resolve_axis_positions(state: StringState, pos, client, ref_seq):
    """Resolve a (D, O) batch of positions against the CURRENT state: no
    interleaved mutations, every op at its own (ref_seq, client). Returns
    (run, off) (D, O) planes, -1 where out of range. (The op axis is taken
    in chunks so the (D, O, S) masks stay bounded.)"""
    dev = state.seq.device
    pos, client, ref_seq = (torch.as_tensor(x, device=dev).to(_I32)
                            for x in (pos, client, ref_seq))
    D, S = state.seq.shape
    O = pos.shape[1]
    run = torch.empty((D, O), dtype=_I32, device=dev)
    off = torch.empty((D, O), dtype=_I32, device=dev)
    step = max(_RESOLVE_CHUNK // max(D * S, 1), 1)
    iota = torch.arange(S, dtype=_I32, device=dev)
    active = (iota[None, :] < state.count[:, None])[:, None, :]
    pl = {k: getattr(state, k)[:, None, :] for k in _PLANES}
    for o0 in range(0, O, step):
        p = pos[:, o0:o0 + step, None]
        cl = client[:, o0:o0 + step, None]
        rs = ref_seq[:, o0:o0 + step, None]
        ins = (pl["seq"] <= rs) | (pl["client"] == cl)
        bit = (pl["removers"] >> cl.clamp(0, MAX_CLIENTS - 1)) & 1
        rem = (pl["removed_seq"] <= rs) | ((bit != 0) & (cl >= 0))
        vis = active & ins & ~rem
        ln = torch.where(vis, pl["length"], 0)
        end = torch.cumsum(ln, dim=2, dtype=_I32)
        pre = end - ln
        inside = vis & (pre <= p) & (p < end)
        has = inside.any(dim=2)
        hop = torch.where(inside, pl["handle_op"], 0).sum(dim=2, dtype=_I32)
        base = torch.where(inside, pl["handle_off"], 0).sum(dim=2,
                                                            dtype=_I32)
        preo = torch.where(inside, pre, 0).sum(dim=2, dtype=_I32)
        run[:, o0:o0 + step] = torch.where(has, hop, -1)
        off[:, o0:o0 + step] = torch.where(has, base + p[:, :, 0] - preo, -1)
    return run, off


def axis_visible_lengths(state: StringState) -> torch.Tensor:
    """(D,) latest-view visible length per axis row (dims read)."""
    S = state.seq.shape[1]
    active = torch.arange(S, device=state.seq.device)[None, :] < \
        state.count[:, None]
    live = active & (state.removed_seq == NOT_REMOVED)
    return torch.where(live, state.length, 0).sum(dim=1, dtype=_I32)


def _outputs(state: StringState, O: int):
    D = state.seq.shape[0]
    return (torch.empty((D, O), dtype=_I32, device=state.seq.device),
            torch.empty((D, O), dtype=_I32, device=state.seq.device))


def apply_axis_batch_fused(state: StringState, kind, a0, a1, a2, seq,
                           client, ref_seq):
    """``apply_axis_batch`` IN PLACE (the JAX program donates its state):
    CUDA tensors launch K3, CPU tensors run the plain version. Returns the
    (D, O) (run, off) outputs on the state's device."""
    ops = (kind, a0, a1, a2, seq, client, ref_seq)
    dev = state.seq.device
    if dev.type == "cpu":
        out, run, off = apply_axis_batch(state, *ops)
        for k, v in state.fields().items():
            v.copy_(getattr(out, k))
        return run, off
    run, off = _outputs(state, kind.shape[1])
    axis_apply.launch_apply(state, ops, run, off)
    return run, off


def resolve_axis_fused(state: StringState, kind, pos, client, ref_seq):
    """The resolve of a whole window: (run, off) of every AXIS_RESOLVE
    slot, -1 elsewhere. CUDA tensors launch K4, CPU tensors run the plain
    version."""
    if state.seq.device.type == "cpu":
        run, off = resolve_axis_positions(state, pos, client, ref_seq)
        is_res = torch.as_tensor(kind).to(_I32) == _RES
        return torch.where(is_res, run, -1), torch.where(is_res, off, -1)
    run, off = _outputs(state, kind.shape[1])
    axis_apply.launch_resolve(state, kind, pos, client, ref_seq, run, off)
    return run, off


class PendingResolve:
    """A resolve window's (run, off) planes on their way to the host. On
    the card the two planes are copied ``non_blocking`` into one pinned
    host buffer behind the launch and a CUDA event is recorded after the
    copy; ``result`` waits on that event before it reads the buffer (read
    earlier, a pinned buffer holds whatever was there: stale values, not
    an error)."""

    def __init__(self, run: torch.Tensor, off: torch.Tensor):
        self._event = None
        if run.is_cuda:
            host = torch.empty((2,) + tuple(run.shape), dtype=_I32,
                               pin_memory=True)
            host[0].copy_(run, non_blocking=True)
            host[1].copy_(off, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(run.device))
            self._device = (run, off)   # alive until the copy has landed
        else:
            host = torch.stack([run, off])
        self._host = host

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
            self._event = self._device = None
        a = self._host.numpy()
        return a[0], a[1]


class PendingResolves:
    """The (run, off) planes of every shard of a sharded window, joined in
    row order when ``result`` is read."""

    def __init__(self, parts: List[PendingResolve]):
        self._parts = parts

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        outs = [p.result() for p in self._parts]
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))


class TensorAxisStore(RowShardedStore):
    """Host facade: 2 permutation axes per matrix doc (rows at ``2·doc``,
    cols at ``2·doc + 1``), resident as one ``StringState`` with one zero
    property plane on ``device`` (default the card; ``device="cpu"`` runs
    the plain versions). Run identities intern (mixed opKey, key_offset) →
    int32 handles; per-axis-row client interning feeds the remover
    bitmask. On the card a capacity the kernels do not take is refused
    before any op is admitted.

    ``mesh`` (a 1-D ``docs`` mesh) splits the axis rows by doc block (a
    doc's two axes stay on one device) and launches each window once a
    shard; ``state`` is then a copy of the whole state on the first
    shard's device, and assigning it re-shards."""

    def __init__(self, n_docs: int, capacity: int = 256, device="cuda",
                 mesh=None):
        self.mesh = mesh
        self.sharded = None
        if mesh is None:
            self.device = resolve_device(device)
            devices = [self.device]
        else:
            devices, docs_per = store_shards(mesh, n_docs)
            self.device = devices[0]
        if any(d.type == "cuda" for d in devices):
            axis_apply.check_capacity(capacity)
        self.n_docs = n_docs
        self.capacity = capacity
        if mesh is None:
            self._state = StringState.create(2 * n_docs, capacity,
                                             n_props=1, device=self.device)
        else:
            self.sharded = ShardedRows(
                [StringState.create(2 * docs_per, capacity, n_props=1,
                                    device=d) for d in devices],
                2 * docs_per)
        self._runs: List[Tuple[int, int]] = [(0, 0)]  # run 0 reserved
        self._run_ids: Dict[Tuple[int, int], int] = {}
        self._runs_np = None  # cached columnar view of _runs
        self._client_idx: List[Dict[int, int]] = [
            dict() for _ in range(2 * n_docs)]

    def _shard_state(self, st) -> list:
        return shard_axis_store_state(st, self.mesh)

    def run_handle(self, mixed: int, key_offset: int) -> int:
        k = (int(mixed), int(key_offset))
        if k not in self._run_ids:
            self._run_ids[k] = len(self._runs)
            self._runs.append(k)
        return self._run_ids[k]

    def run_key(self, handle: int, off: int) -> Tuple[int, int]:
        mixed, base = self._runs[handle]
        return (mixed, base + off)

    def runs_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """The run table as (mixed, base) int64 columns, re-materialised
        only when the table has grown (a resolved-key stream becomes two
        gathers instead of per-op ``run_key`` calls)."""
        cache = self._runs_np
        if cache is None or len(cache[0]) != len(self._runs):
            arr = np.asarray(self._runs, np.int64).reshape(-1, 2)
            cache = self._runs_np = (np.ascontiguousarray(arr[:, 0]),
                                     np.ascontiguousarray(arr[:, 1]))
        return cache

    def client(self, axis_row: int, client_id: int) -> int:
        m = self._client_idx[axis_row]
        if client_id not in m:
            if len(m) >= MAX_CLIENTS:
                raise KeyError(f"axis {axis_row}: client capacity")
            m[client_id] = len(m)
        return m[client_id]

    def _ops(self, planes: dict, names=OP_FIELDS) -> List[torch.Tensor]:
        """(D2, O) numpy planes → contiguous int32 device planes in one
        host→device copy."""
        stack = np.stack([np.asarray(planes[k], np.int32) for k in names])
        dev = torch.from_numpy(stack).to(self.device, copy=True)
        return [dev[i] for i in range(len(names))]

    def _launch(self, planes: dict, resolve_only: bool):
        """One window on the state, or once on each shard (its own block
        of the planes, on its device): a ``PendingResolve`` of its
        outputs."""
        names = ("kind", "a0", "client", "ref_seq") if resolve_only \
            else OP_FIELDS
        if self.sharded is None:
            fn = resolve_axis_fused if resolve_only \
                else apply_axis_batch_fused
            return PendingResolve(*fn(self._state,
                                      *self._ops(planes, names)))
        stack = np.stack([np.asarray(planes[k], np.int32) for k in names])
        outs = sharded_axis_apply(self.mesh, resolve_only)(
            self.sharded.shards,
            [tuple(p) for p in shard_planes(stack, self.mesh,
                                            self.sharded.rows_per)])
        return PendingResolves([PendingResolve(*o) for o in outs])

    def apply(self, planes: dict) -> Tuple[np.ndarray, np.ndarray]:
        """One device dispatch (one a shard); returns host (D2, O) resolve
        outputs (the flush's single device→host read). A window of only
        resolves and NOOPs skips the serial scan (K4, as the JAX store's
        resolve-only branch); any mutation takes the scan (K3)."""
        kind = np.asarray(planes["kind"])
        return self._launch(planes,
                            bool(np.isin(kind, (_RES, _NOOP)).all())).result()

    def resolve_async(self, planes: dict):
        """Mutation-free position resolves whose host copy is started
        behind the launch: the caller harvests them later with
        ``result()``, so the ingest path never blocks on a device round
        trip (the matrix engine's resolve pipelining)."""
        return self._launch(planes, True)

    def visible_lengths(self) -> np.ndarray:
        return self._per_shard(axis_visible_lengths)

    def compact(self, min_seq: np.ndarray) -> None:
        """Zamboni at each axis row's floor: plain torch on either device
        (as the string slice keeps it)."""
        ms = np.asarray(min_seq, np.int32)
        if self.sharded is None:
            self._state = compact_string_state(
                self._state, torch.as_tensor(ms), with_props=False)
            return
        self.sharded.shards = [
            compact_string_state(st, m, with_props=False)
            for st, m in zip(self.sharded.shards, shard_vector(
                ms, self.mesh, self.sharded.rows_per))]

    def overflowed(self) -> np.ndarray:
        return self._per_shard(lambda st: st.overflow)

    # ----------------------------------------------------- snapshot/resume
    # The JAX store's formats: planes trimmed to the widest row's count.

    def snapshot(self) -> dict:
        st = self._state if self.sharded is None \
            else self.sharded.full("cpu")
        counts = st.count.cpu().numpy()
        n = max(int(counts.max()), 1)
        return {
            "planes": {k: getattr(st, k)[:, :n].cpu().numpy().copy()
                       for k in _PLANES},
            "count": counts.copy(),
            "overflow": st.overflow.cpu().numpy().copy(),
            "capacity": self.capacity,
            "runs": [list(r) for r in self._runs],
            "client_idx": [dict(m) for m in self._client_idx],
        }

    def snapshot_rows(self, axis_rows, runs_base: int) -> dict:
        """Incremental snapshot of the given axis rows (2 per dirty doc),
        plus the append-only run-table delta since ``runs_base``."""
        rows = np.ascontiguousarray(axis_rows, np.int32)
        if len(rows) and self.sharded is not None:
            g = self.sharded.gather(rows, _PLANES + ("count", "overflow"),
                                    "cpu")
            counts = g["count"].numpy()
            w = max(int(counts.max()), 1)
            planes = {k: g[k][:, :w].numpy() for k in _PLANES}
            overflow = g["overflow"].numpy()
        elif len(rows):
            st = self._state
            idx = torch.from_numpy(rows).to(self.device).long()
            counts = st.count[idx].cpu().numpy()
            w = max(int(counts.max()), 1)
            planes = {k: getattr(st, k)[idx, :w].cpu().numpy()
                      for k in _PLANES}
            overflow = st.overflow[idx].cpu().numpy()
        else:
            planes = {k: np.zeros((0, 1), np.int32) for k in _PLANES}
            counts = overflow = np.zeros((0,), np.int32)
        return {
            "rows": rows, "planes": planes, "count": counts,
            "overflow": overflow,
            "runs_delta": [list(r) for r in self._runs[runs_base:]],
            "client_idx": {int(r): dict(self._client_idx[int(r)])
                           for r in rows},
        }

    def _write_rows(self, rows: np.ndarray, planes: dict, count,
                    overflow) -> None:
        """Overwrite whole axis rows: each plane padded to the capacity
        with its fill, the property plane zeroed."""
        vals = {}
        for k in _PLANES:
            small = np.asarray(planes[k], np.int32)
            fill = NOT_REMOVED if k == "removed_seq" else 0
            full = np.full((len(rows), self.capacity), fill, np.int32)
            full[:, :small.shape[1]] = small
            vals[k] = torch.from_numpy(full)
        if self.sharded is not None:
            vals["prop_val"] = torch.zeros((len(rows), self.capacity, 1),
                                           dtype=torch.int32)
            vals["count"] = torch.as_tensor(np.asarray(count, np.int32))
            vals["overflow"] = torch.as_tensor(np.asarray(overflow,
                                                          np.int32))
            self.sharded.scatter(rows, vals)
            return
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        st = self._state
        for k in _PLANES:
            getattr(st, k)[idx] = vals[k].to(self.device)
        st.prop_val[idx] = 0
        st.count[idx] = torch.as_tensor(np.asarray(count, np.int32)).to(
            self.device)
        st.overflow[idx] = torch.as_tensor(
            np.asarray(overflow, np.int32)).to(self.device)

    def apply_row_snapshot(self, delta: dict) -> None:
        """Fold one ``snapshot_rows`` delta (this package's or the JAX
        store's) into this restored-base store: extend the run table,
        replace the rows' client maps, overwrite the rows' planes."""
        for r in delta["runs_delta"]:
            k = (int(r[0]), int(r[1]))
            self._run_ids[k] = len(self._runs)
            self._runs.append(k)
        rows = np.asarray(delta["rows"], np.int32)
        if not len(rows):
            return
        for r, m in delta["client_idx"].items():
            self._client_idx[int(r)] = {int(c): v for c, v in m.items()}
        self._write_rows(rows, delta["planes"], delta["count"],
                         delta["overflow"])

    @classmethod
    def restore(cls, snap: dict, device="cuda",
                mesh=None) -> "TensorAxisStore":
        """Rebuild a store from a ``snapshot()`` (this package's or the
        JAX store's numpy planes) on ``device``."""
        store = cls(len(snap["count"]) // 2, snap["capacity"], device, mesh)
        store._write_rows(np.arange(len(snap["count"])), snap["planes"],
                          snap["count"], snap["overflow"])
        store._runs = [tuple(r) for r in snap["runs"]]
        store._run_ids = {r: i for i, r in enumerate(store._runs) if i}
        store._client_idx = [dict(m) for m in snap["client_idx"]]
        return store
