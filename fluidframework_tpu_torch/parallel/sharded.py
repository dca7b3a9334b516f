"""Doc-axis sharding of the serving stores: the multi-card path.

Counterpart of ``fluidframework_tpu/parallel/sharded.py``. Documents are
independent, so a 1-D ``docs`` mesh gives every device a contiguous block
of ``n_docs / n_shards`` doc rows of every store plane. A sharded apply is
the single-device entry point (the hand kernel on a CUDA shard, its plain
version on a CPU shard) called once per shard, on that shard's planes and
that shard's slice of the op batch: nothing crosses devices on the apply
path (``assert_collective_free`` checks it). What does cross: the host's
op buffer to each shard's device, rare row writes (overflow re-upload) and
per-doc reads.

A store keeps one state per shard. ``ShardedRows`` routes a global doc row
to its shard and local row, and gathers / scatters rows across shards in
the caller's row order, so reads, snapshots and digests are those of the
unsharded store, bit for bit (a snapshot concatenates the shards in row
order). Shards are launched one after another without a host sync between
them; the host syncs only where a read needs the data.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .mesh import DOC_AXIS, Mesh, mesh_devices

__all__ = [
    "make_doc_mesh", "doc_shard_count", "shard_of_rows", "shard_bounds",
    "ShardedRows", "RowShardedStore", "split_state", "concat_state",
    "shard_store_state",
    "store_shards", "shard_planes", "shard_vector", "sharded_merge",
    "sharded_compact", "shard_map_store_state", "sharded_map_merge",
    "shard_tree_store_state", "sharded_tree_apply", "shard_axis_store_state",
    "sharded_axis_apply", "sharded_cells_apply", "shard_launches",
    "reset_shard_launches", "shard_scope", "assert_collective_free",
]


def make_doc_mesh(n_devices: Optional[int] = None, device="cuda",
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D ``docs`` mesh: each device owns a contiguous block of doc rows.
    Defaults to every card present; raises without one unless
    ``device="cpu"`` (n CPU shards) is asked for."""
    flat = mesh_devices(n_devices, device, devices)
    grid = np.empty((len(flat),), dtype=object)
    grid[:] = flat
    return Mesh(grid, (DOC_AXIS,))


def doc_shard_count(mesh) -> int:
    """Doc-axis shard count of ``mesh`` (0 when it has no docs axis)."""
    if mesh is None:
        return 0
    return int(mesh.shape.get(DOC_AXIS, 0))


def shard_of_rows(rows, n_docs: int, n_shards: int) -> np.ndarray:
    """Row → doc-shard index by contiguous block."""
    rows_per = max(1, n_docs // n_shards)
    return np.minimum(np.asarray(rows, np.int64) // rows_per, n_shards - 1)


def shard_bounds(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """[lo, hi) row block of each shard; ``n_rows`` must divide evenly
    (a sharded store never quietly becomes one shard)."""
    if n_shards < 1 or n_rows % n_shards:
        raise ValueError(f"n_docs {n_rows} not divisible by mesh size "
                         f"{n_shards}")
    per = n_rows // n_shards
    return [(s * per, (s + 1) * per) for s in range(n_shards)]


# ------------------------------------------------------- state containers
# Every store state is a dataclass whose ``fields()`` are tensors with the
# doc row first (or 0-d scalars for the cell table, which never splits by
# row).

def split_state(state, devices: Sequence[torch.device]):
    """Copies of ``state``'s row blocks, block s on ``devices[s]``."""
    fields = state.fields()
    n = next(iter(fields.values())).shape[0]
    bounds = shard_bounds(n, len(devices))
    return [type(state)(**{k: v[lo:hi].to(dev, copy=True).contiguous()
                           for k, v in fields.items()})
            for (lo, hi), dev in zip(bounds, devices)]


def concat_state(shards: Sequence, device):
    """The whole state on ``device``: the shards' rows in order."""
    names = shards[0].fields().keys()
    return type(shards[0])(**{
        k: torch.cat([getattr(s, k).to(device) for s in shards])
        for k in names})


class ShardedRows:
    """Routing of global doc rows over per-shard states of ``rows_per``
    rows each (shard s holds rows [s·rows_per, (s+1)·rows_per))."""

    def __init__(self, shards: list, rows_per: int):
        self.shards = shards
        self.rows_per = rows_per

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def locate(self, row: int) -> Tuple[object, int]:
        """(shard state, local row) of global row ``row``."""
        s, local = divmod(int(row), self.rows_per)
        if not 0 <= s < len(self.shards):
            raise IndexError(f"row {row} outside {len(self.shards)} shards "
                             f"of {self.rows_per} rows")
        return self.shards[s], local

    def route(self, rows) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """[(shard, positions in ``rows``, local rows)] of the shards that
        ``rows`` touches."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        shard = rows // self.rows_per
        if len(rows) and (shard.min() < 0 or shard.max() >= len(self.shards)):
            raise IndexError("row outside the mesh")
        out = []
        for s in np.unique(shard).tolist():
            pos = np.flatnonzero(shard == s)
            out.append((s, pos, rows[pos] - s * self.rows_per))
        return out

    def gather(self, rows, names: Sequence[str],
               device) -> Dict[str, torch.Tensor]:
        """Rows ``rows`` of the named fields on ``device``, in ``rows``
        order (one index per shard touched, one copy of each result)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        parts = {k: [] for k in names}
        order = []
        for s, pos, local in self.route(rows):
            st = self.shards[s]
            idx = torch.from_numpy(local).to(getattr(st, names[0]).device)
            for k in names:
                parts[k].append(getattr(st, k)[idx].to(device))
            order.append(pos)
        out = {}
        if not order:
            return out
        inv = torch.from_numpy(np.argsort(np.concatenate(order),
                                          kind="stable")).to(device)
        for k in names:
            out[k] = torch.cat(parts[k])[inv]
        return out

    def scatter(self, rows, values: Dict[str, torch.Tensor]) -> None:
        """Write ``values`` (each (len(rows), ...), any device) into rows
        ``rows`` of the named fields."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        for s, pos, local in self.route(rows):
            st = self.shards[s]
            for k, v in values.items():
                plane = getattr(st, k)
                dev = plane.device
                sel = torch.from_numpy(pos).to(v.device)
                plane[torch.from_numpy(local).to(dev)] = v[sel].to(dev)

    def full(self, device):
        return concat_state(self.shards, device)


class RowShardedStore:
    """What the four store families share: the state on one device
    (``_state``; ``sharded`` is None) or one state a doc shard of ``mesh``
    (``sharded``). On a mesh ``state`` is a copy of the whole state on the
    first shard's device (``device``), and assigning it re-shards."""

    def _shard_state(self, st) -> list:
        return shard_store_state(st, self.mesh)

    @property
    def state(self):
        if self.sharded is None:
            return self._state
        return self.sharded.full(self.device)

    @state.setter
    def state(self, st) -> None:
        if self.sharded is None:
            self._state = st
        else:
            self.sharded.shards = self._shard_state(st)

    def _at(self, row: int) -> tuple:
        """(state holding row ``row``, its row there)."""
        if self.sharded is None:
            return self._state, row
        return self.sharded.locate(row)

    def _per_shard(self, fn) -> np.ndarray:
        """``fn(state)`` of the whole state, or of each shard's state
        joined in row order, as a host array."""
        if self.sharded is None:
            return fn(self._state).cpu().numpy()
        return np.concatenate([fn(st).cpu().numpy()
                               for st in self.sharded.shards])


def store_shards(mesh: Mesh, n_rows: int) -> Tuple[list, int]:
    """(doc-shard devices, rows a shard) of a store of ``n_rows`` doc rows
    on ``mesh``, which must be a 1-D ``docs`` mesh whose size divides
    ``n_rows``."""
    if not isinstance(mesh, Mesh) or mesh.axis_names != (DOC_AXIS,):
        raise ValueError("a store shards over a 1-D 'docs' mesh "
                         "(make_doc_mesh)")
    bounds = shard_bounds(n_rows, mesh.size)
    return mesh.doc_devices(), bounds[0][1]


def shard_store_state(state, mesh: Mesh) -> list:
    """A store state's row blocks, one on each doc shard's device."""
    n = next(iter(state.fields().values())).shape[0]
    shard_bounds(n, mesh.size)  # the divisibility check
    return split_state(state, mesh.doc_devices())


def shard_planes(planes, mesh_or_devices, rows_per: int) -> list:
    """Per-shard row slices of (..., D, O) op planes (torch or numpy; the
    doc axis second to last), each copied to its shard's device."""
    devices = mesh_or_devices.doc_devices() \
        if isinstance(mesh_or_devices, Mesh) else list(mesh_or_devices)
    out = []
    for s, dev in enumerate(devices):
        lo, hi = s * rows_per, (s + 1) * rows_per
        p = planes[..., lo:hi, :]
        if isinstance(p, np.ndarray):
            p = torch.from_numpy(np.ascontiguousarray(p))
        out.append(p.to(dev, copy=True).contiguous())
    return out


def shard_vector(vec, mesh_or_devices, rows_per: int) -> list:
    """Per-shard blocks of a (D,) host vector, each on its shard's device
    as int32."""
    devices = mesh_or_devices.doc_devices() \
        if isinstance(mesh_or_devices, Mesh) else list(mesh_or_devices)
    vec = np.ascontiguousarray(vec, np.int32)
    return [torch.from_numpy(vec[s * rows_per:(s + 1) * rows_per]).to(
        dev, copy=True) for s, dev in enumerate(devices)]


# ------------------------------------------- per-shard launch accounting

_COUNTERS = (
    ("string_apply", "string_kernel", "launches"),
    ("map_apply", "map_apply", "launches"),
    ("cell_merge", "cell_merge", "launches"),
    ("axis_apply", "axis_apply", "apply_launches"),
    ("axis_resolve", "axis_apply", "resolve_launches"),
    ("tree_apply", "tree_apply", "apply_launches"),
    ("tree_expand", "tree_apply", "expand_launches"),
)

#: kernel name → {shard index: launches made inside ``shard_scope``}
_LAUNCHES: Dict[str, Dict[int, int]] = {}
_TLS = threading.local()


def _counter_values() -> Dict[str, int]:
    import importlib
    out = {}
    for name, mod, attr in _COUNTERS:
        m = importlib.import_module(f"..ops.{mod}", __package__)
        out[name] = getattr(m, attr)
    return out


def shard_launches() -> Dict[str, Dict[int, int]]:
    """Kernel launches made on each shard since the last reset (kernel
    name → {shard: launches}); kernels not launched are absent."""
    return {k: dict(v) for k, v in _LAUNCHES.items() if v}


def reset_shard_launches() -> None:
    _LAUNCHES.clear()


@contextlib.contextmanager
def shard_scope(shard: int, device: torch.device):
    """The work of one shard: kernel launches inside it count for
    ``shard``, and under ``assert_collective_free``'s mode every tensor an
    operation touches must live on ``device``."""
    before = _counter_values()
    prev = getattr(_TLS, "device", None)
    _TLS.device = torch.device(device)
    try:
        yield
    finally:
        _TLS.device = prev
        after = _counter_values()
        for name, n in after.items():
            if n != before[name]:
                per = _LAUNCHES.setdefault(name, {})
                per[shard] = per.get(shard, 0) + n - before[name]


# ------------------------------------------------------------ string apply

def _string_fused():
    from ..ops.string_kernel import apply_string_batch_fused
    return apply_string_batch_fused


def sharded_merge(mesh: Mesh, with_props: bool, fuse_compact: bool):
    """The sharded columnar / message merge: ``fn(shards, planes[, ms])``
    applies shard s's 7 (rows_per, O) op planes (``planes[s]``, on its
    device) to ``shards[s]`` in place, with zamboni fused through
    ``ms[s]`` when ``fuse_compact``; returns the shards. Body = the
    single-device entry point on each shard (B1 on a CUDA shard)."""
    devices = mesh.doc_devices()
    apply = _string_fused()

    def fn(shards, planes, ms=None):
        if fuse_compact and ms is None:
            raise ValueError("a fused-compact merge needs min_seq")
        for s, (st, dev) in enumerate(zip(shards, devices)):
            with shard_scope(s, dev):
                apply(st, *planes[s],
                      min_seq=ms[s] if fuse_compact else None,
                      with_props=with_props)
        return shards
    return fn


def sharded_compact(mesh: Mesh, with_props: bool):
    """Sharded zamboni: ``fn(shards, ms)`` → new shards, each compacted at
    its own (rows_per,) floors ``ms[s]`` on its device."""
    from ..ops.merge_tree import compact_string_state
    devices = mesh.doc_devices()

    def fn(shards, ms):
        out = []
        for s, (st, dev) in enumerate(zip(shards, devices)):
            with shard_scope(s, dev):
                out.append(compact_string_state(st, ms[s], with_props))
        return out
    return fn


# ------------------------------------------- map, tree, axis and cell applies

#: the map and tree stores' planes shard like the string store's
shard_map_store_state = shard_tree_store_state = shard_store_state


def sharded_map_merge(mesh: Mesh, packed: bool):
    """The doc-sharded map apply: ``fn(shards, args)`` runs K1 (the plain
    version on a CPU shard) on each shard's planes with ``args[s]``: its
    dense (kind, a0, a1, seq) planes, or (word buffer, R, O, wide_vals)
    of its own rows when ``packed``."""
    from ..ops import map_kernel as mk
    devices = mesh.doc_devices()
    apply = mk.map_columnar_apply_fused if packed \
        else mk.apply_map_batch_fused

    def fn(shards, args):
        for s, (st, dev) in enumerate(zip(shards, devices)):
            with shard_scope(s, dev):
                apply(st, *args[s])
        return shards
    return fn


def sharded_tree_apply(mesh: Mesh):
    """The doc-sharded tree record scan: ``fn(shards, planes)`` runs K5
    (planes mode) on each shard with its (9, rows, O) record planes."""
    from ..ops.tree_kernel import apply_tree_planes_fused
    devices = mesh.doc_devices()

    def fn(shards, planes):
        for s, (st, dev) in enumerate(zip(shards, devices)):
            with shard_scope(s, dev):
                apply_tree_planes_fused(st, planes[s])
        return shards
    return fn


def shard_axis_store_state(state, mesh: Mesh) -> list:
    """The matrix axis store's rows (2 a doc, adjacent), by doc block."""
    n_rows = state.seq.shape[0]
    if n_rows % (2 * mesh.size):
        raise ValueError(f"axis rows {n_rows} not divisible by 2×mesh size "
                         f"{2 * mesh.size}")
    return shard_store_state(state, mesh)


def sharded_axis_apply(mesh: Mesh, resolve_only: bool):
    """The doc-sharded axis window: ``fn(shards, ops)`` runs K3 (or, for a
    window of resolves only, K4) on each shard with its block of the op
    planes; returns each shard's (run, off) outputs on its device."""
    from ..ops.axis_kernel import apply_axis_batch_fused, resolve_axis_fused
    devices = mesh.doc_devices()
    apply = resolve_axis_fused if resolve_only else apply_axis_batch_fused

    def fn(shards, ops):
        outs = []
        for s, (st, dev) in enumerate(zip(shards, devices)):
            with shard_scope(s, dev):
                outs.append(apply(st, *ops[s]))
        return outs
    return fn


def sharded_cells_apply(mesh: Mesh, fww: bool):
    """The doc-sharded cell merge: ``fn(pools, batches)`` merges shard s's
    (key, seq, value, L) batch into its own pool (K2; prefix mode on
    ``table[:L]``, full mode when L is None). Cells are doc-scoped, so
    the merge stays on the shard."""
    from ..ops.matrix_kernel import merge_cells_fused
    devices = mesh.doc_devices()

    def fn(pools, batches):
        for s, (st, dev) in enumerate(zip(pools, devices)):
            key, seq, value, L = batches[s]
            with shard_scope(s, dev):
                merge_cells_fused(st, key, seq, value, L, fww)
        return pools
    return fn


# -------------------------------------------------- the collective-free check

_COPY_OPS = ("_to_copy", "copy_", "copy", "_copy_from",
             "_copy_from_and_resize")


class CrossDeviceRecorder(TorchDispatchMode):
    """Records every operation that moves a tensor between devices, and
    every operation inside a ``shard_scope`` that touches a tensor off the
    scope's device."""

    def __init__(self):
        super().__init__()
        self.copies: List[str] = []
        self.misplaced: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        devs = {t.device for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor)}
        if name in _COPY_OPS and len(devs) > 1:
            self.copies.append(f"{name}: {sorted(map(str, devs))}")
        want = getattr(_TLS, "device", None)
        if want is not None and any(d != want for d in devs):
            self.misplaced.append(f"{name}: {sorted(map(str, devs))} in a "
                                  f"shard on {want}")
        return out


def assert_collective_free(mesh: Mesh, n_docs: int, capacity: int,
                           n_ops: int, seed: int = 0) -> str:
    """Run one sharded merge (fused compact) of a typing storm at the given
    shape under ``CrossDeviceRecorder`` and prove the apply path moves no
    tensor between devices: each shard's launch touches only tensors on
    that shard's device. The planes reach the shards before the check
    starts (the host→device op buffer is not part of the apply)."""
    from ..ops.merge_tree import StringState
    from ..testing.synthetic import typing_storm
    devices = mesh.doc_devices()
    rows_per = shard_bounds(n_docs, len(devices))[0][1]
    shards = [StringState.create(rows_per, capacity, 1, device=d)
              for d in devices]
    p, _ = typing_storm(n_docs, n_ops, seed=seed)
    order = ("kind", "a0", "a1", "a2", "seq", "client", "ref_seq")
    stack = np.stack([np.asarray(p[k], np.int32) for k in order])
    per = shard_planes(stack, devices, rows_per)
    planes = [tuple(x[i] for i in range(7)) for x in per]
    ms = [torch.zeros((rows_per,), dtype=torch.int32, device=d)
          for d in devices]
    fn = sharded_merge(mesh, with_props=False, fuse_compact=True)
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)
    with CrossDeviceRecorder() as rec:
        fn(shards, planes, ms)
    bad = rec.copies + rec.misplaced
    if bad:
        raise AssertionError(f"the sharded merge moves tensors across "
                             f"devices: {bad[:8]}")
    return "collective-free"
