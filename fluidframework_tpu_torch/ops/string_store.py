"""Host facade for the batched merge-tree kernel: many SharedString documents
resident on one device (the flat tier).

The serving/replica-side merge engine (sequenced ops only). The store
interns variable-length payloads (text runs, markers) into an int32 handle
table — the device does ordering/position math, never string bytes — and
maps client ids to per-doc indexes for the remover bitmask.

Two apply routes end in the same kernel wrapper
(``string_kernel.apply_string_batch_fused``): ``apply_messages`` (per-op
messages → dense op planes) and ``apply_planes`` (the columnar wire: one
int32 word buffer per batch, unpacked on the device by
``_columnar_unpack``). On the card every capacity and every doc count
takes the kernel; CPU tensors take its plain version. ``apply_messages``
splits a history longer than one launch can stage into op windows.

Overflow recovery re-uploads a rebuilt doc with ``adopt_doc`` (or empties
a graduated doc's row with ``clear_doc``); incremental summaries carry
``snapshot_rows`` deltas, folded back by ``apply_row_snapshot``.

``mesh=`` (a 1-D ``docs`` mesh, ``parallel/sharded.py``) splits every plane
into contiguous doc-row blocks, one on each shard's device: an apply or a
compaction runs the single-device entry point once per shard, and reads,
row writes, snapshots and digests route each row to its shard, so every
result is the unsharded store's, bit for bit.

Intervals (anchored ranges over a doc's text, SlideOnRemove endpoints) are
host-side ``(handle_op, handle_off)`` anchors, so an apply never touches
them. They slide where a doc's window floor crosses a pending tombstone:
both apply routes cut their batch at that op, apply the part before it (a
kernel launch), re-anchor the crossing docs off one fused row gather and go
on; ``compact`` re-anchors before zamboni drops the tombstones.
"""

from __future__ import annotations

import heapq
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.constants import NOT_REMOVED
from .merge_tree import (
    MAX_CLIENTS, PLANES, PROP_HANDLE_BITS, StringState, compact_string_state,
    string_state_digest,
)
from . import string_kernel
from .schema import OpKind, ValueInterner
from .string_kernel import apply_string_batch_fused
from ..parallel.sharded import (
    RowShardedStore, ShardedRows, shard_planes, shard_vector,
    sharded_compact, sharded_merge, store_shards,
)

_TEXT = 0
_MARKER = 1
_I32 = torch.int32
_NOOP = int(OpKind.NOOP)
_INS = int(OpKind.STR_INSERT)
_ANN = int(OpKind.STR_ANNOTATE)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: a CUDA device requires a card
    (no silent CPU fall-back); ``"cpu"`` must be asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return dev


def _columnar_unpack(buf: torch.Tensor, R: int, O: int, pos_wide: bool,
                     ref_wide: bool, rich: int, n_docs: int,
                     fuse_compact: bool, scatter_rows: bool,
                     compact8: bool = False, tab_n: int = 0,
                     row_lo: int = 0, n_rows: Optional[int] = None):
    """Device-side unpack of ONE columnar batch (an int32 word buffer) into
    dense (n_docs or R, O) op planes plus the fused min_seq. A doc shard
    unpacks its own block: rows [row_lo, row_lo + n_rows) of the store
    (scattered; the batch's other rows land on a spare row that is cut
    off) and that block of min_seq.

    Lanes: kind u8, client-idx u8, a0/a1 (u16, or i32 when ``pos_wide``),
    ref (u16 lag behind the op's own seq, or i32 when ``ref_wide``), a2
    (one broadcast i32 handle, an (N,) i32 plane when ``rich`` == 1, or a
    u8/u16 table index into two i32 tables — a2 and insert length — when
    ``rich`` is 2/3), then the per-row seq bases, the row indices and
    min_seq. The 5 B/op ``compact8`` head packs [kind(2b)|cidx(6b)] u8,
    a0 u16, span u8 (insert: length; else a1 - a0) and lag u8.

    seq = base + running count of non-NOOP slots (nacked ops were masked to
    NOOP and consumed no seq); ref = seq - max(lag, 1), or min(ref, seq-1)
    when ``ref_wide``. a2 is zeroed except on insert and annotate. Lanes are
    little-endian in the words; masks apply after the arithmetic shifts."""
    N = R * O

    def take_u8(off, n):
        w = -(-n // 4)
        words = buf[off:off + w]
        v = torch.stack([words & 0xFF, (words >> 8) & 0xFF,
                         (words >> 16) & 0xFF, (words >> 24) & 0xFF],
                        dim=1).reshape(4 * w)[:n]
        return v, off + w

    def take_u16(off, n):
        w = -(-n // 2)
        words = buf[off:off + w]
        v = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF],
                        dim=1).reshape(2 * w)[:n]
        return v, off + w

    def take_i32(off, n):
        return buf[off:off + n], off + n

    if compact8:
        kc, off = take_u8(0, N)
        kind = kc & 0x3
        kind = torch.where(kind == 3, _NOOP, kind)
        client = kc >> 2
        a0, off = take_u16(off, N)
        delta, off = take_u8(off, N)
        a1 = torch.where(kind == _INS, delta, a0 + delta)
        ref, off = take_u8(off, N)
    else:
        take_pos = take_i32 if pos_wide else take_u16
        kind, off = take_u8(0, N)
        client, off = take_u8(off, N)
        a0, off = take_pos(off, N)
        a1, off = take_pos(off, N)
        ref, off = (take_i32 if ref_wide else take_u16)(off, N)
    lenv = None
    if rich in (2, 3):
        ti, off = (take_u8 if rich == 2 else take_u16)(off, N)
        a2tab, off = take_i32(off, tab_n)
        lentab, off = take_i32(off, tab_n)
        # indices at remove/NOOP slots are never validated: clamp like a
        # bounds-clamping gather (their a2 is zeroed below anyway)
        ti = ti.reshape(R, O).clamp(max=tab_n - 1).long()
        a2 = a2tab[ti]
        lenv = lentab[ti]
    else:
        a2, off = take_i32(off, N if rich else 1)
    base, off = take_i32(off, R)
    rows, off = take_i32(off, R)
    min_seq, off = take_i32(off, n_docs if fuse_compact else 1)

    kind = kind.reshape(R, O)
    valid = kind != _NOOP
    seq = base[:, None] + torch.cumsum(valid.to(_I32), dim=1, dtype=_I32)
    a0 = a0.reshape(R, O)
    a1 = a1.reshape(R, O)
    client = client.reshape(R, O)
    if lenv is not None:  # table form: insert a1 = payload length
        a1 = torch.where(kind == _INS, lenv, a1)
    if ref_wide and not compact8:
        ref = torch.minimum(ref.reshape(R, O), seq - 1)
    else:
        ref = seq - torch.clamp(ref.reshape(R, O), min=1)
    if rich == 1:
        a2 = a2.reshape(R, O)
    elif not rich:
        a2 = a2.expand(R, O)
    a2 = torch.where((kind == _INS) | (kind == _ANN), a2, 0)
    planes = (kind, a0, a1, a2, seq, client, ref)
    n_rows = n_docs if n_rows is None else n_rows
    if scatter_rows:
        local = rows.long() - row_lo
        if row_lo or n_rows != n_docs:
            local = torch.where((local >= 0) & (local < n_rows), local,
                                n_rows)

        def full(p, fill):
            out = torch.full((n_rows + 1, O), fill, dtype=_I32,
                             device=buf.device)
            out[local] = p
            return out[:n_rows]
        planes = (full(planes[0], _NOOP),) + \
            tuple(full(p, 0) for p in planes[1:])
    if fuse_compact:
        min_seq = min_seq[row_lo:row_lo + n_rows]
    return tuple(p.to(_I32).contiguous() for p in planes), min_seq


class PrepackedPlanes:
    """The seq-independent half of a columnar apply's host pack: payload/
    props tables interned, wire form chosen, insert lengths resolved.
    Produced by ``TensorStringStore.prepack_planes`` (the pipelined pack
    worker runs it ahead of sequencing) and consumed exactly once, in
    submission order — payload handles allocate at prepack time."""

    __slots__ = ("rich", "rich_mode", "a2_np", "tab_a2", "tab_len",
                 "tab_n", "tidx_eff", "a1")

    def __init__(self):
        self.rich = False
        self.rich_mode = 0
        self.a2_np = None
        self.tab_a2 = None
        self.tab_len = None
        self.tab_n = 0
        self.tidx_eff = None
        self.a1 = None


class StringOpInterner:
    """Host-side message → op-record translation: payload/client/property
    interning and the insert-with-props → insert + same-seq annotate
    expansion."""

    SNAP_PLANES = PLANES + ("prop_val",)

    def _init_interner(self, n_docs: int, n_props: int) -> None:
        self._payloads: List[Tuple[int, str]] = [(_TEXT, "")]  # handle 0
        self._client_idx: List[Dict[int, int]] = [dict()
                                                  for _ in range(n_docs)]
        # property KEYS intern to plane indexes (store-wide), VALUES to
        # handles; handle 0 = key unset (None deletes)
        self._prop_planes: Dict[str, int] = {}
        self._prop_values = ValueInterner()
        self._has_props = False
        self.n_props = n_props
        # packed (plane << 20 | handle) per hashable (key, value)
        self._props_pack_cache: Dict[tuple, int] = {}
        # (rows, client column, lut) of the last single-writer batch
        self._cidx_cache: Optional[tuple] = None
        # pow2 payload-table buffer pool keyed by tab_n
        self._tab_pool: Dict[int, list] = {}

    def _client(self, doc: int, client_id: int) -> int:
        m = self._client_idx[doc]
        if client_id not in m:
            if len(m) >= MAX_CLIENTS:
                raise KeyError(f"doc {doc}: client capacity {MAX_CLIENTS}")
            m[client_id] = len(m)
        return m[client_id]

    def _payload(self, kind: int, text: str) -> int:
        self._payloads.append((kind, text))
        return len(self._payloads) - 1

    def _prop_plane(self, key: str) -> int:
        if key not in self._prop_planes:
            if len(self._prop_planes) >= self.n_props:
                raise KeyError(
                    f"property key capacity {self.n_props} exhausted "
                    f"(recreate the store with a larger n_props)")
            self._prop_planes[key] = len(self._prop_planes)
        return self._prop_planes[key]

    def _prop_handle(self, value) -> int:
        if value is None:
            return 0
        h = self._prop_values.handle(value)
        if h >= (1 << PROP_HANDLE_BITS):
            raise OverflowError("property value table exceeded 2^20 entries")
        return h

    def remap_payload_handles(self, src: "StringOpInterner",
                              handles: np.ndarray) -> np.ndarray:
        """Re-intern ``src``'s payloads referenced by ``handles`` into this
        store's table (one new handle per distinct source handle, in
        first-seen order); returns the remapped handles."""
        hmap: Dict[int, int] = {}
        out = np.empty_like(handles)
        for i, h in enumerate(handles.tolist()):
            if h not in hmap:
                hmap[h] = self._payload(*src._payloads[h])
            out[i] = hmap[h]
        return out

    def remap_props(self, src: "StringOpInterner", tprop: np.ndarray,
                    out: np.ndarray) -> None:
        """Write ``src``'s (n, K_src) per-slot property-value handles into
        ``out`` (n+, K_self) under this store's key planes and value
        table."""
        n = tprop.shape[0]
        for key, tplane in src._prop_planes.items():
            mplane = self._prop_plane(key)
            col = tprop[:, tplane]
            vmap = {int(h): (0 if h == 0 else self._prop_values.handle(
                src._prop_values.value(int(h))))
                for h in np.unique(col)}
            out[:n, mplane] = [vmap[int(h)] for h in col]

    def reserve_props(self, props: dict) -> list:
        """Admission-time reservation of the key planes ``props`` needs
        (atomic: nothing is minted if any key cannot fit) and a headroom
        check of the value table. Returns the minted keys for
        ``release_props``. Raises KeyError when capacity is exhausted."""
        new_keys = [k for k in props if k not in self._prop_planes]
        if len(self._prop_planes) + len(new_keys) > self.n_props:
            raise KeyError(
                f"property key capacity {self.n_props} exhausted")
        n_vals = sum(1 for v in props.values() if v is not None)
        if len(self._prop_values) + n_vals > (1 << PROP_HANDLE_BITS):
            raise KeyError("property value table exhausted")
        for k in new_keys:
            self._prop_plane(k)
        return new_keys

    def reserve_prop_tables(self, keys, values) -> None:
        """Columnar admission: reserve planes for every key (atomic) and
        check value-table headroom for the distinct uninterned values."""
        new_keys = [k for k in keys if k not in self._prop_planes]
        if len(self._prop_planes) + len(new_keys) > self.n_props:
            raise KeyError(
                f"property key capacity {self.n_props} exhausted")
        uniq = {json.dumps(v, sort_keys=True) for v in values
                if v is not None}
        uniq -= set(self._prop_values._ids)
        if len(self._prop_values) + len(uniq) > (1 << PROP_HANDLE_BITS):
            raise KeyError("property value table exhausted")
        for k in new_keys:
            self._prop_plane(k)

    def release_props(self, minted: list) -> None:
        """Undo ``reserve_props`` after a post-admission nack (planes pop
        in reverse mint order, so indexes stay dense)."""
        for k in reversed(minted):
            idx = self._prop_planes.pop(k)
            assert idx == len(self._prop_planes), "interleaved mint"

    def _annotate_rec(self, key, value, start, end, seq, cl, ref_seq):
        self._has_props = True
        packed = (self._prop_plane(key) << PROP_HANDLE_BITS) | \
            self._prop_handle(value)
        return (_ANN, start, end, packed, seq, cl, ref_seq)

    def _records_for(self, doc: int, msg) -> list:
        """Device op records (7-tuples) for one sequenced message."""
        op = msg.contents
        cl = self._client(doc, msg.client_id)
        if op["mt"] == "insert":
            if op["kind"] == 1:  # marker
                handle = self._payload(_MARKER, "")
                length = 1
            else:
                if not op["text"]:
                    return []  # empty insert: no segment anywhere
                handle = self._payload(_TEXT, op["text"])
                length = len(op["text"])
            recs = [(_INS, op["pos"], length, handle, msg.seq, cl,
                     msg.ref_seq)]
            # insert-with-props = insert + same-seq annotate of the new run
            for key in sorted(op.get("props") or {}):
                recs.append(self._annotate_rec(
                    key, op["props"][key], op["pos"], op["pos"] + length,
                    msg.seq, cl, msg.ref_seq))
            return recs
        if op["mt"] == "remove":
            return [(int(OpKind.STR_REMOVE), op["start"], op["end"], 0,
                     msg.seq, cl, msg.ref_seq)]
        if op["mt"] == "annotate":
            # one record per property key, all at the message's seq
            return [self._annotate_rec(key, op["props"][key], op["start"],
                                       op["end"], msg.seq, cl, msg.ref_seq)
                    for key in sorted(op["props"])]
        raise ValueError(f"unknown op {op['mt']!r}")


class TensorStringStore(RowShardedStore, StringOpInterner):
    """D documents × S segment slots of merge-tree state on ``device``, or
    split by doc-row block over the devices of ``mesh``.

    The state's tensors are updated in place by every apply (the JAX store
    donated them); compaction replaces them. On a mesh ``state`` is a copy
    of the whole state on the first shard's device (``self.device``);
    assigning it re-shards."""

    def __init__(self, n_docs: int, capacity: int = 256, n_props: int = 4,
                 device="cuda", mesh=None):
        self.n_docs = n_docs
        self.capacity = capacity
        self.mesh = mesh
        self.sharded: Optional[ShardedRows] = None
        # until the first annotate the kernel runs its no-props mode
        # (all-zero planes are permutation-invariant)
        if mesh is None:
            self.device = resolve_device(device)
            self._state = StringState.create(n_docs, capacity, n_props,
                                             device=self.device)
        else:
            devices, rows_per = store_shards(mesh, n_docs)
            self.device = devices[0]
            self.sharded = ShardedRows(
                [StringState.create(rows_per, capacity, n_props, device=d)
                 for d in devices], rows_per)
        self._init_interner(n_docs, n_props)
        #: wire profile of the last columnar batch (None before the first)
        self.last_profile: Optional[tuple] = None
        #: rich payload wire form of the last batch: plane/tab8/tab16
        self.last_rich_wire: Optional[str] = None
        #: op width of each launch of the last ``apply_messages``
        self.last_op_windows: List[int] = []
        #: segments and their op widths of the last ``apply_planes``
        self.last_apply_stats: dict = {}
        #: fused device→host gathers served (reads, interval anchoring and
        #: slides)
        self.device_reads = 0
        # interval id → (start anchor, end anchor, props) per doc; an
        # anchor is a (handle_op, handle_off) point or None (detached)
        self._intervals: List[Dict[str, tuple]] = [dict()
                                                   for _ in range(n_docs)]
        self._interval_counter = 0
        # highest window floor seen per doc (slides trigger at advances)
        self._iv_min_seq = np.zeros((n_docs,), np.int64)
        # per interval-holding doc, a min-heap of its uncompacted
        # tombstone seqs: tells host-side whether a floor advance dooms
        # a tombstone (only then do anchors slide)
        self._iv_tombs: List[list] = [[] for _ in range(n_docs)]
        # rows holding intervals (an O(1) check on the columnar path)
        self._iv_docs: set = set()

    # ----------------------------------------------------------------- apply

    def apply_messages(self, messages) -> None:
        """messages: iterable of (doc, SequencedDocumentMessage) carrying
        merge-tree op contents. Each doc's records apply in order: in one
        launch, or in consecutive op windows when one launch cannot take
        them all (the apply is an in-order fold per doc and the overflow
        flag is sticky, so the windows leave the same state).

        A doc holding intervals cuts the batch at the message whose window
        floor dooms one of its pending tombstones, and only there: the
        group up to and including that message applies, the doc's anchors
        slide off the state at the crossing, then the rest goes on."""
        self.last_op_windows = []
        msgs = list(messages)
        iv_docs = self._iv_docs
        if not iv_docs:
            self._apply_group(msgs)
            return
        group: list = []
        for doc, msg in msgs:
            group.append((doc, msg))
            if doc in iv_docs:
                if msg.min_seq > self._iv_min_seq[doc]:
                    self._iv_min_seq[doc] = msg.min_seq
                    if self._floor_dooms_tombstone(doc):
                        self._apply_group(group)
                        group = []
                        self._slide_anchors_at_floor(doc)
                if msg.contents["mt"] == "remove":
                    heapq.heappush(self._iv_tombs[doc], msg.seq)
        if group:
            self._apply_group(group)

    def _apply_group(self, msgs) -> None:
        for planes in self._message_planes(msgs):
            if self.sharded is None:
                self._dispatch_apply(tuple(
                    torch.from_numpy(p).to(self.device) for p in planes))
            else:
                per = shard_planes(planes, self.mesh, self.sharded.rows_per)
                self._merge_shards([tuple(p) for p in per], None)

    def _message_planes(self, messages) -> List[np.ndarray]:
        """Intern ``messages`` and lay their device records out as dense
        op planes: one (7, n_docs, O) int32 array per launch, O the power-
        of-two bucket of the widest doc's records (the JAX store's static
        shapes), capped at ``_op_window()``; NOOP pads. Records intern
        here, so every returned window must be applied, in order. Each
        window's O is appended to ``last_op_windows``."""
        per_doc: Dict[int, list] = {}
        for doc, msg in messages:
            recs = self._records_for(doc, msg)
            if recs:
                per_doc.setdefault(doc, []).extend(recs)
        if not per_doc:
            return []
        widest = max(len(v) for v in per_doc.values())
        limit = self._op_window()
        step = widest if limit is None else max(limit, 1)
        out = []
        for lo in range(0, widest, step):
            window = {d: r[lo:lo + step] for d, r in per_doc.items()
                      if len(r) > lo}
            o = 8
            while o < max(len(r) for r in window.values()):
                o *= 2
            o = min(o, step) if limit is not None else o
            planes = np.zeros((7, self.n_docs, o), np.int32)
            planes[0] = _NOOP
            for doc, recs in window.items():
                planes[:, doc, :len(recs)] = np.asarray(recs, np.int32).T
            out.append(planes)
            self.last_op_windows.append(o)
        return out

    def _op_window(self) -> Optional[int]:
        """The widest op batch one launch takes: on the card the kernel's
        shared-memory limit at this store's shape (``None`` when it stages
        no op fields); no limit for the plain version on the CPU."""
        if self.device.type != "cuda":
            return None
        return string_kernel.max_ops(
            self.capacity, self.n_props if self._has_props else 0)

    def _dispatch_apply(self, op_planes: tuple, min_seq=None) -> None:
        """One device merge of dense (D, O) op planes (+ fused zamboni)."""
        apply_string_batch_fused(self._state, *op_planes, min_seq=min_seq,
                                 with_props=self._has_props)

    def _merge_shards(self, planes: list, ms: Optional[list]) -> None:
        """One merge on every shard: shard s's 7 op planes ``planes[s]``
        (+ fused zamboni through ``ms[s]``), all on its device."""
        sharded_merge(self.mesh, self._has_props, ms is not None)(
            self.sharded.shards, planes, ms)

    def _tab_buffers(self, tab_n: int, T: int, P: int):
        """A (tab_a2, tab_len) pair of ``tab_n`` int32 buffers, reused from
        the pow2 pool when available (only the stale tail is re-zeroed)."""
        pool = self._tab_pool.get(tab_n)
        if pool:
            tab_a2, tab_len = pool.pop()
            tab_a2[T + P:] = 0
            tab_len[T:] = 0
            return tab_a2, tab_len
        return np.zeros((tab_n,), np.int32), np.zeros((tab_n,), np.int32)

    def _tab_release(self, pp: PrepackedPlanes) -> None:
        """Return a prepack's table buffers to the pool once the wire
        buffer has been built (the concatenate copied them)."""
        if pp.tab_a2 is not None:
            pool = self._tab_pool.setdefault(pp.tab_n, [])
            if len(pool) < 4:
                pool.append((pp.tab_a2, pp.tab_len))
        pp.tab_a2 = pp.tab_len = None

    def _touches_intervals(self, rows, ins) -> bool:
        """Whether a batch inserts on a row that holds intervals."""
        return bool(self._iv_docs) and bool(ins.any()) and \
            not self._iv_docs.isdisjoint(np.asarray(rows).reshape(-1).tolist())

    def _pack_payload_tables(self, rows, kind, a0, a1, text, texts, tidx,
                             props) -> PrepackedPlanes:
        """The payload/props side of a columnar apply's wire form: intern
        payloads, pack props, choose the rich wire mode, resolve insert
        lengths. Depends only on the raw op planes, never on sequencing;
        mutates the interner, so call in submission order.

        Anchors key by (payload handle, offset), so two same-text inserts
        in one doc must not share a handle: a batch inserting on a row that
        holds intervals mints one handle per insert and ships the resolved
        a2 plane (as the per-message path does); interval-free batches keep
        the deduplicated tables."""
        pp = PrepackedPlanes()
        R, O = kind.shape
        ins = kind == _INS
        ann = kind == _ANN
        if ann.any() and props is None:
            raise ValueError("annotate slots require the props table")
        iv_handles = self._touches_intervals(rows, ins)
        pp.rich = not (texts is None and props is None) or iv_handles
        if not pp.rich:
            # broadcast payload: a2 is one scalar handle
            pp.a2_np = np.array([self._payload(_TEXT, text)], np.int32)
            pp.a1 = np.where(ins, len(text), a1)
            return pp
        if tidx is not None:
            tidx = np.asarray(tidx, np.int32)
        packed_tab = np.zeros((0,), np.int32)
        if props is not None and ann.any():
            self._has_props = True
            packed_tab = np.empty((len(props),), np.int32)
            cache = self._props_pack_cache
            for j, p in enumerate(props):
                (key, value), = p.items()  # single-key by contract
                try:
                    packed = cache.get((key, value))
                except TypeError:   # unhashable value: intern directly
                    packed = None
                if packed is None:
                    packed = (self._prop_plane(key) << PROP_HANDLE_BITS) \
                        | self._prop_handle(value)
                    try:
                        cache[(key, value)] = packed
                    except TypeError:
                        pass
                packed_tab[j] = packed
        if iv_handles:
            # per-op handle mint (anchor identity), resolved a2 plane
            pp.rich_mode = 1
            base_h = len(self._payloads)
            flat_ins = np.flatnonzero(ins.reshape(-1))
            if texts is not None:
                t_list = [texts[j] for j in
                          map(int, tidx.reshape(-1)[flat_ins])]
            else:
                t_list = [text] * len(flat_ins)
            self._payloads.extend((_TEXT, t) for t in t_list)
            a2_np = np.zeros((R, O), np.int32)
            a2_np.reshape(-1)[flat_ins] = np.arange(
                base_h, base_h + len(flat_ins), dtype=np.int32)
            lens = np.zeros((R, O), np.int32)
            lens.reshape(-1)[flat_ins] = np.fromiter(
                map(len, t_list), np.int32, count=len(t_list))
            pp.a1 = np.where(ins, lens, a1)
            if len(packed_tab):
                a2_np[ann] = packed_tab[tidx[ann]]
            pp.a2_np = a2_np
            return pp
        # one interner pass per unique payload/props entry: handles resolve
        # into small per-batch tables (texts first, packed props after)
        if texts is not None:
            base_h = len(self._payloads)
            self._payloads.extend((_TEXT, t) for t in texts)
            handles_tab = np.arange(base_h, base_h + len(texts),
                                    dtype=np.int32)
            lens_tab = np.fromiter(map(len, texts), np.int32,
                                   count=len(texts))
        elif ins.any():
            handles_tab = np.array([self._payload(_TEXT, text)], np.int32)
            lens_tab = np.array([len(text)], np.int32)
        else:
            handles_tab = np.zeros((1,), np.int32)
            lens_tab = np.zeros((1,), np.int32)
        T, P = len(handles_tab), len(packed_tab)
        pp.rich_mode = 2 if T + P <= 256 else 3 if T + P <= 65536 else 1
        if pp.rich_mode != 1:
            # annotate indices shift past the text region
            tidx_eff = np.where(ann, tidx + T, tidx)
            if texts is None and ins.any():
                # broadcast-insert + props: inserts take table entry 0
                tidx_eff = np.where(ins, 0, tidx_eff)
            pp.tidx_eff = tidx_eff
            pp.tab_n = max(8, 1 << (T + P - 1).bit_length())
            pp.tab_a2, pp.tab_len = self._tab_buffers(pp.tab_n, T, P)
            pp.tab_a2[:T] = handles_tab
            pp.tab_a2[T:T + P] = packed_tab
            pp.tab_len[:T] = lens_tab
            # insert a1 on the wire is a placeholder (= a0, so spans stay
            # 0); the device substitutes the table length
            pp.a1 = np.where(ins, a0, a1)
        else:               # huge tables: resolved i32 a2 plane
            a2_np = np.zeros((R, O), np.int32)
            a1_out = a1
            if texts is not None:
                a2_np[ins] = handles_tab[tidx[ins]]
                a1_out = np.where(ins, lens_tab.take(tidx, mode="clip"), a1)
            elif ins.any():
                a2_np[ins] = handles_tab[0]
                a1_out = np.where(ins, lens_tab[0], a1)
            if P:
                a2_np[ann] = packed_tab[tidx[ann]]
            pp.a2_np = a2_np
            pp.a1 = a1_out
        return pp

    def prepack_planes(self, rows, kind, a0, a1, text: str = "",
                       texts=None, tidx=None,
                       props=None) -> Optional[PrepackedPlanes]:
        """Pipelined-ingest hook: the seq-independent pack work for a wave,
        run ahead of its sequencing; hand the result to
        ``apply_planes(prepacked=...)``.

        Returns None when the wave inserts on a row holding intervals: that
        pack mints a handle per acked op, which only sequencing knows, so
        the caller packs inline at dispatch (and a pipeline holds the next
        wave's pack until then, keeping handle order serial)."""
        kind = np.asarray(kind, np.int32)
        if self._touches_intervals(rows, kind == _INS):
            return None
        return self._pack_payload_tables(
            np.asarray(rows), kind, np.asarray(a0, np.int32),
            np.asarray(a1, np.int32), text, texts, tidx, props)

    def apply_planes(self, rows, kind, a0, a1, seq_base, client_id, ref_seq,
                     text: str = "", min_seq=None, texts=None, tidx=None,
                     props=None, min_ops=None, prepacked=None) -> None:
        """Columnar apply: dense (R, O) already-sequenced op planes for the
        doc rows ``rows`` (R,). Ops per doc apply in column order; NOOP
        slots (nacked ops) consumed no seq, so per-op seqs are rebuilt on
        the device from the per-row ``seq_base``.

        Payloads: the broadcast ``text`` (every insert inserts the same
        run) or per-op ``texts`` + ``tidx`` ((R, O) table indices). Single-
        key annotates ride ``props`` (indexed by ``tidx``). ``min_seq``
        (n_docs,) fuses zamboni into the same kernel launch.

        The whole batch crosses to the device as ONE int32 word buffer, in
        the tightest of three wire profiles: ``compact8`` (5 B/op when
        spans, lags and client indexes fit a byte), ``lag16`` (u16 lag
        behind the op's own seq) or ``ref_wide`` (i32 ref).

        Rows holding intervals take this path too. ``min_ops`` is the
        (R, O) per-op window floor the sequencer stamped: the batch is cut
        after each column where a doc's floor crosses a pending tombstone,
        each segment is packed and launched on its own (its seq base the
        seq before its first column), and the crossing docs' anchors slide
        off one fused row gather right after their segment. Without
        ``min_ops`` the floor is taken not to move inside the batch (removes
        still feed the tombstone heaps). While any row holds intervals
        zamboni is not fused: ``compact`` runs after the segments, since it
        re-anchors first. ``last_apply_stats`` holds the segment count and
        widths."""
        rows = np.ascontiguousarray(rows, np.int32)
        R, O = kind.shape
        if len(np.unique(rows)) != R:
            raise ValueError("duplicate rows in columnar batch (the device "
                             "scatter would silently drop ops)")
        kind = np.asarray(kind, np.int32)
        ins = kind == _INS
        a0 = np.asarray(a0, np.int32)
        a1 = np.asarray(a1, np.int32)
        pp = prepacked
        if pp is None:
            pp = self._pack_payload_tables(rows, kind, a0, a1, text, texts,
                                           tidx, props)
        rich, rich_mode, a1 = pp.rich, pp.rich_mode, pp.a1

        # client interning. Fast path: one writer per doc row (R dict hits,
        # cached across batches by a memcmp of rows and clients). General
        # path: one dict hit per unique (row, client) pair; nacked/NOOP
        # slots never mint an index.
        valid = kind != _NOOP
        cidx = np.zeros((R, O), np.int32)
        cid = np.asarray(client_id, np.int32)
        cmax = 0
        if (cid == cid[:, :1]).all():
            cid0 = np.ascontiguousarray(cid[:, 0])
            rkey, ckey = rows.tobytes(), cid0.tobytes()
            cached = self._cidx_cache
            rows_any = valid.any(axis=1)
            all_rows_valid = bool(rows_any.all())
            if cached is not None and all_rows_valid \
                    and cached[0] == rkey and cached[1] == ckey:
                lut = cached[2]
            else:
                # an all-NOOP row must not consume a client slot
                lut = np.zeros(R, np.int32)
                rows_l, cid_l = rows.tolist(), cid0.tolist()
                for i in map(int, np.flatnonzero(rows_any)):
                    lut[i] = self._client(rows_l[i], cid_l[i])
                if all_rows_valid:
                    self._cidx_cache = (rkey, ckey, lut)
            cidx[:] = lut[:, None]
            cmax = int(lut.max(initial=0))
        elif valid.any():
            rr = np.broadcast_to(rows[:, None], (R, O))[valid]
            cc = cid.astype(np.int64)[valid]
            key = (rr.astype(np.int64) << 32) | (cc & 0xFFFFFFFF)
            uniq, inv = np.unique(key, return_inverse=True)
            lut = np.array(
                [self._client(int(k >> 32), int(np.int32(k & 0xFFFFFFFF)))
                 for k in uniq], np.int32)
            cidx[valid] = lut[inv]
            cmax = int(lut.max(initial=0))

        # u16 packing would alias a negative position to ~65535: minima
        # force such inputs onto the sign-preserving wide lanes
        narrow = int(a0.max(initial=0)) < 32767 and \
            int(a1.max(initial=0)) < 32767 and \
            int(a0.min(initial=0)) >= 0 and int(a1.min(initial=0)) >= 0
        seq_base = np.asarray(seq_base, np.int32)
        seq = seq_base[:, None] + np.cumsum(valid, axis=1, dtype=np.int32)
        lag = np.subtract(seq, np.asarray(ref_seq, np.int32))
        np.maximum(lag, 1, out=lag)
        ref_wide = bool((lag > 65535).any())
        scatter_rows = not (R == self.n_docs
                            and np.array_equal(rows, np.arange(R)))
        fuse = min_seq is not None and not self._iv_docs
        ms = np.asarray(min_seq, np.int32) if fuse \
            else np.zeros((1,), np.int32)
        span = np.where(ins, a1, a1 - a0) if rich_mode < 2 \
            else np.where(ins, 0, a1 - a0)
        kinds_ok = bool(((kind >= 0) & ((kind <= _ANN) | ~valid)).all())
        compact8 = bool(
            narrow and not ref_wide and kinds_ok and cmax < 64
            and int(lag.max(initial=0)) < 256
            and int(span.max(initial=0)) < 256
            and int(span.min(initial=0)) >= 0)
        self.last_profile = (
            "compact8" if compact8 else
            "ref_wide" if ref_wide else "lag16",
            "pos16" if narrow else "pos32",
            "rich" if rich else "broadcast")
        self.last_rich_wire = (None if not rich else
                               {1: "plane", 2: "tab8", 3: "tab16"}
                               [rich_mode])

        # the crossing scan: a segment ends after every column where an
        # interval doc's floor crosses a pending tombstone
        segments = [(0, O, ())]
        if self._iv_docs:
            splits = self._interval_scan(
                rows, kind, seq, None if min_ops is None
                else np.asarray(min_ops))
            if splits:
                segments, prev = [], 0
                for b in sorted(splits):
                    segments.append((prev, b, splits[b]))
                    prev = b
                if prev < O:
                    segments.append((prev, O, ()))

        def seg_u8(arr):
            b = np.ascontiguousarray(arr, np.uint8).reshape(-1)
            if len(b) % 4:
                b = np.concatenate([b, np.zeros((-len(b)) % 4, np.uint8)])
            return b.view("<i4")

        def seg_u16(arr):
            b = np.ascontiguousarray(arr, "<u2").reshape(-1)
            if len(b) % 2:
                b = np.concatenate([b, np.zeros(1, "<u2")])
            return b.view("<i4")

        seg_pos = seg_u16 if narrow else \
            (lambda a: np.ascontiguousarray(a, "<i4").reshape(-1))
        for c0, c1, slides in segments:
            cut = (slice(None), slice(c0, c1))
            base = seq_base if c0 == 0 else seq[:, c0 - 1]
            kind_s, a0_s, a1_s = kind[cut], a0[cut], a1[cut]
            cidx_s, lag_s = cidx[cut], lag[cut]
            if compact8:
                kc = np.where(kind_s == _NOOP, 3, kind_s) | (cidx_s << 2)
                head = [seg_u8(kc), seg_u16(a0_s), seg_u8(span[cut]),
                        seg_u8(lag_s)]
            elif ref_wide:
                head = [seg_u8(kind_s), seg_u8(cidx_s), seg_pos(a0_s),
                        seg_pos(a1_s), np.ascontiguousarray(
                            np.asarray(ref_seq)[cut], "<i4").reshape(-1)]
            else:  # ship the u16 lag; the device rebuilds ref = seq - lag
                head = [seg_u8(kind_s), seg_u8(cidx_s), seg_pos(a0_s),
                        seg_pos(a1_s), seg_u16(lag_s)]
            if rich_mode >= 2:
                tail = [(seg_u8 if rich_mode == 2 else seg_u16)(
                            pp.tidx_eff[cut]),
                        pp.tab_a2.astype("<i4", copy=False),
                        pp.tab_len.astype("<i4", copy=False)]
            elif rich_mode == 1:
                tail = [np.ascontiguousarray(pp.a2_np[cut],
                                             "<i4").reshape(-1)]
            else:
                tail = [pp.a2_np.astype("<i4", copy=False)]
            buf = np.concatenate(head + tail + [
                np.ascontiguousarray(base, "<i4"),
                rows.astype("<i4", copy=False),
                ms.astype("<i4", copy=False),
            ])
            unpack = dict(R=R, O=c1 - c0, pos_wide=not narrow,
                          ref_wide=ref_wide, rich=rich_mode,
                          n_docs=self.n_docs, fuse_compact=fuse,
                          compact8=compact8, tab_n=pp.tab_n)
            if self.sharded is None:
                planes, ms_dev = _columnar_unpack(
                    torch.from_numpy(buf).to(self.device),
                    scatter_rows=scatter_rows, **unpack)
                self._dispatch_apply(planes, ms_dev if fuse else None)
            else:
                # the word buffer goes to each shard's device once; every
                # shard unpacks its own row block there
                on_dev: dict = {}
                per, per_ms = [], []
                rp = self.sharded.rows_per
                for s, dev in enumerate(self.mesh.doc_devices()):
                    if dev not in on_dev:
                        on_dev[dev] = torch.from_numpy(buf).to(dev)
                    planes, ms_dev = _columnar_unpack(
                        on_dev[dev], scatter_rows=True, row_lo=s * rp,
                        n_rows=rp, **unpack)
                    per.append(planes)
                    per_ms.append(ms_dev)
                self._merge_shards(per, per_ms if fuse else None)
            if slides:
                self._slide_docs(slides)
        self._tab_release(pp)
        self.last_apply_stats = {"segments": len(segments),
                                 "widths": [c1 - c0 for c0, c1, _ in
                                            segments]}
        if min_seq is not None and not fuse:
            self.compact(np.asarray(min_seq))

    def compact(self, min_seq) -> None:
        """Zamboni: free tombstones below the collaboration window
        (``min_seq`` scalar or (n_docs,))."""
        ms = np.full((self.n_docs,), int(min_seq), np.int32) \
            if np.isscalar(min_seq) else np.asarray(min_seq, np.int32)
        self._reanchor_for_compact(ms)
        if self.sharded is None:
            self._state = compact_string_state(
                self._state, torch.from_numpy(ms).to(self.device),
                with_props=self._has_props)
        else:
            self.sharded.shards = sharded_compact(
                self.mesh, self._has_props)(
                    self.sharded.shards,
                    shard_vector(ms, self.mesh, self.sharded.rows_per))
        for doc in self._iv_docs:
            self._prune_tombs(doc, int(ms[doc]))

    # ----------------------------------------------------------------- reads

    def _pull_doc(self, doc: int):
        """One fused device→host gather of a doc's read planes
        (removed_seq, handle_op, handle_off, length, seq), trimmed to its
        slot count."""
        self.device_reads += 1
        st, r = self._at(doc)
        S = st.seq.shape[1]
        arr = torch.stack([
            st.removed_seq[r], st.handle_op[r], st.handle_off[r],
            st.length[r], st.seq[r], st.count[r].expand(S),
        ]).cpu().numpy()
        n = int(arr[5, 0])
        return tuple(arr[i, :n] for i in range(5))

    def read_text(self, doc: int) -> str:
        rem, hop, hoff, length, _ = self._pull_doc(doc)
        parts = []
        for i in range(len(rem)):
            if rem[i] != NOT_REMOVED:
                continue
            kind, text = self._payloads[hop[i]]
            if kind == _TEXT:
                parts.append(text[hoff[i]:hoff[i] + length[i]])
        return "".join(parts)

    def visible_length(self, doc: int) -> int:
        rem, _, _, length, _ = self._pull_doc(doc)
        return int(length[rem == NOT_REMOVED].sum())

    @staticmethod
    def _slot_in_planes(rem, length, pos: int) -> int:
        """Slot holding visible position ``pos`` in pulled planes (skip
        tombstones, accumulate live lengths)."""
        at = 0
        for i in range(len(rem)):
            if rem[i] != NOT_REMOVED:
                continue
            if at <= pos < at + length[i]:
                return i
            at += length[i]
        raise IndexError(f"position {pos} beyond visible length {at}")

    def _slot_at(self, doc: int, pos: int) -> int:
        rem, _, _, length, _ = self._pull_doc(doc)
        return self._slot_in_planes(rem, length, pos)

    def seq_at(self, doc: int, pos: int) -> int:
        """Insert seq of the slot holding visible position ``pos``."""
        rem, _, _, length, seqp = self._pull_doc(doc)
        return int(seqp[self._slot_in_planes(rem, length, pos)])

    def get_properties(self, doc: int, pos: int) -> dict:
        """Properties of the character at visible position ``pos``."""
        i = self._slot_at(doc, pos)
        st, r = self._at(doc)
        pv = st.prop_val[r, i].cpu().numpy()
        return {key: self._prop_values.value(int(pv[plane]))
                for key, plane in self._prop_planes.items()
                if pv[plane] != 0}

    def visible_lengths(self) -> np.ndarray:
        """(D,) visible lengths of every doc in one device round trip (one
        a shard)."""
        def lengths(st):
            S = st.seq.shape[1]
            active = torch.arange(S, device=st.seq.device)[None, :] < \
                st.count[:, None]
            live = active & (st.removed_seq == NOT_REMOVED)
            return torch.where(live, st.length, 0).sum(dim=1, dtype=_I32)
        return self._per_shard(lengths)

    # -------------------------------------------------------------- intervals
    # Anchored ranges over the served text (reference: IntervalCollection /
    # SequenceInterval with SlideOnRemove endpoints).

    def _gather_rows(self, rows):
        """(removed_seq, length, handle_op, handle_off, count) of doc rows
        ``rows`` as numpy arrays, from ONE device→host copy."""
        self.device_reads += 1
        if self.sharded is not None:
            g = self.sharded.gather(rows, ("removed_seq", "length",
                                           "handle_op", "handle_off",
                                           "count"), "cpu")
            return tuple(v.numpy() for v in g.values())
        st = self._state
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        S = st.seq.shape[1]
        g = torch.stack([st.removed_seq[idx], st.length[idx],
                         st.handle_op[idx], st.handle_off[idx],
                         st.count[idx, None].expand(-1, S)]).cpu().numpy()
        return g[0], g[1], g[2], g[3], g[4][:, 0]

    def _doc_slots(self, doc: int):
        """(handle_op, handle_off, length, live) of active slots."""
        rem, hop, hoff, length, _ = self._pull_doc(doc)
        return hop, hoff, length, rem == NOT_REMOVED

    @staticmethod
    def _anchor_in(slots, pos: int):
        """Anchor of the visible character at ``pos`` in pulled slots (at
        or past the doc's end: its last visible char; empty doc: None,
        detached), as the oracle's _anchor."""
        hop, hoff, length, live = slots
        at = 0
        last = None
        for i in range(len(hop)):
            if not live[i]:
                continue
            if at <= pos < at + length[i]:
                return (int(hop[i]), int(hoff[i]) + (pos - at))
            at += int(length[i])
            last = (int(hop[i]), int(hoff[i]) + int(length[i]) - 1)
        return last

    def _anchor_position(self, doc: int, anchor, slots=None) -> int:
        """Resolve an anchor with slide semantics: a tombstoned anchor
        resolves to the live prefix at its slot (the nearest following
        live position), as the oracle's get_position. ``slots`` lets a
        caller resolving many anchors pull the doc once."""
        if anchor is None:
            return 0  # detached parks at document start
        h, off = anchor
        hop, hoff, length, live = slots if slots is not None \
            else self._doc_slots(doc)
        at = 0
        for i in range(len(hop)):
            if hop[i] == h and hoff[i] <= off < hoff[i] + length[i]:
                return at + (off - int(hoff[i])) if live[i] else at
            if live[i]:
                at += int(length[i])
        return at  # the anchor's slot is gone

    def _floor_dooms_tombstone(self, doc: int) -> bool:
        """Does the doc's window floor reach a pending tombstone?"""
        tombs = self._iv_tombs[doc]
        return bool(tombs) and tombs[0] <= self._iv_min_seq[doc]

    def _slide_anchors_at_floor(self, doc: int) -> None:
        """Slide the doc's anchors off slots its floor dooms, then drop
        those tombstones from its heap (a slid tombstone needs no other
        slide)."""
        self._reanchor_for_compact(self._iv_min_seq, only_doc=doc)
        self._prune_tombs(doc, int(self._iv_min_seq[doc]))

    def _prune_tombs(self, doc: int, floor: int) -> None:
        tombs = self._iv_tombs[doc]
        while tombs and tombs[0] <= floor:
            heapq.heappop(tombs)

    def _seed_from(self, doc: int, removed) -> None:
        """The doc's tombstone heap from its pulled removed_seq plane:
        every tombstone above its floor, which a later advance could
        doom."""
        floor = self._iv_min_seq[doc]
        tombs = [int(s) for s in removed[removed != NOT_REMOVED]
                 if s > floor]
        heapq.heapify(tombs)
        self._iv_tombs[doc] = tombs

    def _seed_tombs(self, doc: int) -> None:
        """Rebuild the doc's tombstone heap from the device planes (at its
        first interval, after a restore or a re-upload)."""
        st, r = self._at(doc)
        n = int(st.count[r])
        self._seed_from(doc, st.removed_seq[r, :n].cpu().numpy())

    def add_intervals_bulk(self, spans: Dict[int, list]
                           ) -> Dict[int, List[str]]:
        """Anchor many intervals across many docs off ONE fused gather of
        every target row: ``spans`` maps doc row → [(start, end, props)];
        returns doc row → the new interval ids."""
        rows = np.asarray(sorted(spans), np.int32)
        if not len(rows):
            return {}
        removed_g, length_g, hop_g, hoff_g, count_g = self._gather_rows(rows)
        out: Dict[int, List[str]] = {}
        for j, row in enumerate(rows.tolist()):
            cnt = int(count_g[j])
            removed = removed_g[j, :cnt]
            slots = (hop_g[j, :cnt], hoff_g[j, :cnt], length_g[j, :cnt],
                     removed == NOT_REMOVED)
            if not self._intervals[row]:
                self._seed_from(row, removed)
            ids = []
            for start, end, props in spans[row]:
                self._interval_counter += 1
                iid = f"iv{self._interval_counter}"
                self._intervals[row][iid] = (self._anchor_in(slots, start),
                                             self._anchor_in(slots, end),
                                             dict(props or {}))
                ids.append(iid)
            self._iv_docs.add(row)
            out[row] = ids
        return out

    def add_interval(self, doc: int, start: int, end: int,
                     props: Optional[dict] = None) -> str:
        return self.add_intervals_bulk({doc: [(start, end, props)]})[doc][0]

    def remove_interval(self, doc: int, iid: str) -> None:
        del self._intervals[doc][iid]
        if not self._intervals[doc]:
            self._iv_docs.discard(doc)

    def interval_endpoints(self, doc: int, iid: str):
        a, b, _props = self._intervals[doc][iid]
        slots = self._doc_slots(doc)
        return (self._anchor_position(doc, a, slots),
                self._anchor_position(doc, b, slots))

    def intervals(self, doc: int) -> dict:
        """Interval id → (start, end, props) of a doc's intervals."""
        slots = self._doc_slots(doc)
        return {iid: (self._anchor_position(doc, a, slots),
                      self._anchor_position(doc, b, slots), dict(props))
                for iid, (a, b, props) in self._intervals[doc].items()}

    def advance_min_seq(self, doc: int, min_seq: int) -> None:
        """A window-floor advance that arrived outside the op stream (a
        heartbeat): slide the doc's anchors now, as an in-stream advance
        would."""
        if not self._intervals[doc] or min_seq <= self._iv_min_seq[doc]:
            return
        self._iv_min_seq[doc] = min_seq
        if self._floor_dooms_tombstone(doc):
            self._slide_anchors_at_floor(doc)

    def _interval_scan(self, rows, kind, seq, min_ops):
        """The columnar batch's crossing scan (``apply_messages``'s
        bookkeeping over planes): walk each interval row's op columns,
        advance the doc's floor from ``min_ops`` and, where the floor
        crosses a pending tombstone, cut a segment AFTER that column (the
        crossing op lands before the slide). A remove feeds the heap after
        the check (its own seq is never at or below the floor it carries).

        Returns {boundary column: ((doc, floor at the crossing), ...)};
        updates the heaps and floors. With ``min_ops=None`` only the heaps
        are fed."""
        splits: Dict[int, list] = {}
        rem_k = int(OpKind.STR_REMOVE)
        iv = self._iv_docs
        for i, d in enumerate(map(int, rows)):
            if d not in iv:
                continue
            krow = kind[i]
            rem_mask = krow == rem_k
            if min_ops is None:
                tombs = self._iv_tombs[d]
                for j in map(int, np.flatnonzero(rem_mask)):
                    heapq.heappush(tombs, int(seq[i, j]))
                continue
            mrow = min_ops[i]
            floor = self._iv_min_seq[d]
            cand = np.flatnonzero(rem_mask
                                  | ((krow != _NOOP) & (mrow > floor)))
            if not len(cand):
                continue
            tombs = self._iv_tombs[d]
            for j in map(int, cand):
                m = int(mrow[j])
                if m > floor:
                    floor = m
                    if tombs and tombs[0] <= floor:
                        splits.setdefault(j + 1, []).append((d, floor))
                        while tombs and tombs[0] <= floor:
                            heapq.heappop(tombs)
                if rem_mask[j]:
                    heapq.heappush(tombs, int(seq[i, j]))
            self._iv_min_seq[d] = floor
        return {b: tuple(v) for b, v in splits.items()}

    def _slide_docs(self, pairs) -> None:
        """Re-anchor (doc, floor) crossings off the current state with ONE
        fused row gather for all of them."""
        if not pairs:
            return
        removed_g, length_g, hop_g, hoff_g, count_g = self._gather_rows(
            [d for d, _ in pairs])
        for j, (d, floor) in enumerate(pairs):
            cnt = int(count_g[j])
            self._reanchor_arrays(d, floor, removed_g[j, :cnt],
                                  hop_g[j, :cnt], hoff_g[j, :cnt],
                                  length_g[j, :cnt])

    def _reanchor_arrays(self, doc: int, floor: int, removed, hop, hoff,
                         length) -> None:
        """Slide the doc's anchors off slots doomed at ``floor`` (pulled
        planes): to the first following live char, else the last
        preceding one, else detach (the oracle's _slide_refs rules)."""
        doomed = removed <= floor
        if not doomed.any():
            return
        live_idx = np.flatnonzero(removed == NOT_REMOVED)
        hi = hoff + length

        def slide(i):
            k = np.searchsorted(live_idx, i + 1)
            if k < len(live_idx):           # first following live char
                j = live_idx[k]
                return (int(hop[j]), int(hoff[j]))
            k = np.searchsorted(live_idx, i) - 1
            if k >= 0:                      # last preceding live char
                j = live_idx[k]
                return (int(hop[j]), int(hi[j]) - 1)
            return None                     # no live text: detach

        for iid, (a, b, props) in list(self._intervals[doc].items()):
            new = []
            for anchor in (a, b):
                if anchor is not None:
                    h, off = anchor
                    hit = np.flatnonzero((hop == h) & (hoff <= off)
                                         & (off < hi))
                    if len(hit) and doomed[hit[0]]:
                        anchor = slide(int(hit[0]))
                new.append(anchor)
            self._intervals[doc][iid] = (new[0], new[1], props)

    def _reanchor_for_compact(self, min_seq, only_doc: Optional[int] = None
                              ) -> None:
        """Before zamboni drops the tombstones at or below ``min_seq``
        (per doc), move anchors off them. Only docs whose heap the floor
        dooms are gathered, all in one gather."""
        docs = self._iv_docs if only_doc is None else (only_doc,)
        pairs = []
        for doc in docs:
            if not self._intervals[doc]:
                continue
            floor = int(min_seq[doc])
            tombs = self._iv_tombs[doc]
            if tombs and tombs[0] <= floor:
                pairs.append((doc, floor))
        self._slide_docs(pairs)

    def _restore_intervals(self, snap: dict) -> None:
        """Interval state from a snapshot (either package's), heaps
        re-seeded from the planes."""
        self._intervals = [
            {iid: (tuple(a) if a else None, tuple(b) if b else None,
                   dict(props))
             for iid, (a, b, props) in per_doc.items()}
            for per_doc in snap.get("intervals",
                                    [{} for _ in range(self.n_docs)])]
        self._interval_counter = snap.get("interval_counter", 0)
        self._iv_min_seq = np.asarray(
            snap.get("iv_min_seq", [0] * self.n_docs), np.int64)
        self._iv_tombs = [[] for _ in range(self.n_docs)]
        self._iv_docs = {d for d in range(self.n_docs)
                         if self._intervals[d]}
        for d in self._iv_docs:
            self._seed_tombs(d)

    def _interval_snapshot(self) -> dict:
        return {
            "intervals": [{iid: [list(a) if a else None,
                                 list(b) if b else None, props]
                           for iid, (a, b, props) in per_doc.items()}
                          for per_doc in self._intervals],
            "interval_counter": self._interval_counter,
            "iv_min_seq": self._iv_min_seq.tolist(),
        }

    # ----------------------------------------------------- overflow recovery

    def _write_rows(self, rows, planes: np.ndarray, prop: np.ndarray,
                    count, overflow) -> None:
        """Overwrite whole doc rows ``rows``: ``planes`` (7, n, S) in PLANES
        order, ``prop`` (n, S, K), ``count`` and ``overflow`` (n,)."""
        rows = np.asarray(rows, np.int64)
        if self.sharded is not None:
            vals = {k: torch.from_numpy(np.ascontiguousarray(planes[i]))
                    for i, k in enumerate(PLANES)}
            vals["prop_val"] = torch.from_numpy(np.ascontiguousarray(prop))
            vals["count"] = torch.as_tensor(np.asarray(count, np.int32))
            vals["overflow"] = torch.as_tensor(np.asarray(overflow,
                                                          np.int32))
            self.sharded.scatter(rows, vals)
            return
        st, dev = self._state, self.device
        rows = torch.from_numpy(rows).to(dev)
        planes = torch.from_numpy(np.ascontiguousarray(planes)).to(dev)
        for i, k in enumerate(PLANES):
            getattr(st, k)[rows] = planes[i]
        st.prop_val[rows] = torch.from_numpy(prop).to(dev)
        st.count[rows] = torch.as_tensor(count, dtype=_I32, device=dev)
        st.overflow[rows] = torch.as_tensor(overflow, dtype=_I32, device=dev)

    def _empty_rows(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(planes, prop) of ``n`` empty rows: fill everywhere."""
        planes = np.zeros((len(PLANES), n, self.capacity), np.int32)
        planes[PLANES.index("removed_seq")] = NOT_REMOVED
        return planes, np.zeros((n, self.capacity, self.n_props), np.int32)

    def adopt_doc(self, row: int, tmp: "TensorStringStore",
                  src_row: int = 0) -> None:
        """Adopt row ``src_row`` of ``tmp`` (a rebuilt store) into ``row``:
        the re-upload step of overflow recovery. Payload handles re-intern
        into this store's table, the doc's client map moves over whole
        (client indexes are doc-local, so the client and removers planes
        carry over as they are), property planes remap by key. The row's
        tail is padded with fill, ``count`` written and the sticky
        overflow flag cleared. The source row must fit this store."""
        n = int(tmp.state.count[src_row])
        if n > self.capacity or int(tmp.state.overflow[src_row]):
            raise ValueError(f"row {src_row} of the rebuild ({n} slots) "
                             f"does not fit capacity {self.capacity}")
        src = torch.stack([getattr(tmp.state, k)[src_row, :n]
                           for k in PLANES]).cpu().numpy()
        planes, prop = self._empty_rows(1)
        planes[:, 0, :n] = src
        hop = PLANES.index("handle_op")
        planes[hop, 0, :n] = self.remap_payload_handles(tmp, src[hop])
        self._client_idx[row] = dict(tmp._client_idx[src_row])
        self._cidx_cache = None  # the row's client map changed
        if tmp._has_props:
            self._has_props = True
            self.remap_props(tmp, tmp.state.prop_val[src_row, :n].cpu()
                             .numpy(), prop[0])
        self._write_rows([row], planes, prop, [n], [0])
        # interval bookkeeping restarts from the rebuilt planes
        if self._intervals[row]:
            self._seed_tombs(row)

    def clear_doc(self, row: int) -> None:
        """Empty a row (its doc graduated off this store): fill planes,
        count 0, overflow flag cleared, and its interval state reset, so
        a doc that reuses the row starts with none of it (the JAX engine
        keeps the row's floor, heap and membership: ROADMAP C8)."""
        planes, prop = self._empty_rows(1)
        self._write_rows([row], planes, prop, [0], [0])
        self._cidx_cache = None
        self._intervals[row] = {}
        self._iv_tombs[row] = []
        self._iv_min_seq[row] = 0
        self._iv_docs.discard(row)

    def overflowed(self) -> np.ndarray:
        return self._per_shard(lambda st: st.overflow)

    def overflow_flags(self) -> torch.Tensor:
        """A copy of the (D,) overflow flags on ``self.device``, taken in
        stream order (no host sync)."""
        if self.sharded is None:
            return self._state.overflow.clone()
        return torch.cat([st.overflow.to(self.device)
                          for st in self.sharded.shards])

    def slot_usage(self) -> np.ndarray:
        return self._per_shard(lambda st: st.count)

    def digests(self) -> np.ndarray:
        return self._per_shard(string_state_digest)

    # ----------------------------------------------------- snapshot / resume

    def snapshot(self) -> dict:
        """Device→host gather of the merged state plus the host interning
        tables, in the JAX store's snapshot format (planes trimmed to the
        widest doc's slot count). A sharded store's shards concatenate in
        row order: the snapshot does not depend on the mesh."""
        st = self._state if self.sharded is None \
            else self.sharded.full("cpu")
        counts = st.count.cpu().numpy()
        n = max(int(counts.max()), 1)
        return {
            "planes": {k: getattr(st, k)[:, :n].cpu().numpy().copy()
                       for k in self.SNAP_PLANES},
            "count": counts.copy(),
            "overflow": st.overflow.cpu().numpy().copy(),
            "capacity": self.capacity,
            "n_props": self.n_props,
            "payloads": list(self._payloads),
            "client_idx": [dict(m) for m in self._client_idx],
            "prop_planes": dict(self._prop_planes),
            "prop_values": self._prop_values.export(),
            "has_props": self._has_props,
            **self._interval_snapshot(),
        }

    def snapshot_rows(self, rows, payloads_base: int,
                      prop_values_base: int) -> dict:
        """Incremental snapshot: only the given doc rows' planes (one
        gather per plane, trimmed to their widest slot count) plus the
        append-only interner deltas since the table lengths
        ``payloads_base`` / ``prop_values_base`` of the last summary, and
        the interval state in full (it changes outside the op stream). The
        JAX store's ``snapshot_rows`` layout."""
        rows = np.ascontiguousarray(rows, np.int32)
        if len(rows) and self.sharded is not None:
            g = self.sharded.gather(
                rows, self.SNAP_PLANES + ("count", "overflow"), "cpu")
            counts = g["count"].numpy()
            w = max(int(counts.max()), 1)
            planes = {k: g[k][:, :w].numpy() for k in self.SNAP_PLANES}
            overflow = g["overflow"].numpy()
        elif len(rows):
            st = self._state
            idx = torch.from_numpy(rows).to(self.device).long()
            counts = st.count[idx].cpu().numpy()
            w = max(int(counts.max()), 1)
            planes = {k: getattr(st, k)[idx, :w].cpu().numpy()
                      for k in self.SNAP_PLANES}
            overflow = st.overflow[idx].cpu().numpy()
        else:
            planes = {k: np.zeros((0, 1), np.int32)
                      for k in self.SNAP_PLANES}
            counts = overflow = np.zeros((0,), np.int32)
        return {
            "rows": rows,
            "planes": planes,
            "count": counts,
            "overflow": overflow,
            "payloads_delta": list(self._payloads[payloads_base:]),
            "client_idx": {int(r): dict(self._client_idx[int(r)])
                           for r in rows},
            "prop_planes": dict(self._prop_planes),
            "prop_values_delta":
                self._prop_values.export_from(prop_values_base),
            "has_props": self._has_props,
            **self._interval_snapshot(),
        }

    def apply_row_snapshot(self, delta: dict) -> None:
        """Fold one ``snapshot_rows`` delta (this package's or the JAX
        store's) into this restored-base store: extend the append-only
        interner tables, overwrite the dirty rows and replace the interval
        state."""
        self._payloads.extend(tuple(p) for p in delta["payloads_delta"])
        self._prop_planes = dict(delta["prop_planes"])
        self._prop_values.extend_from(delta["prop_values_delta"])
        self._has_props = self._has_props or bool(delta["has_props"])
        # the plane map and the dirty rows' client maps are replaced
        self._props_pack_cache = {}
        self._cidx_cache = None
        rows = np.asarray(delta["rows"], np.int32)
        if len(rows):
            for r, m in delta["client_idx"].items():
                self._client_idx[int(r)] = dict(m)
            n = len(rows)
            planes, prop = self._empty_rows(n)
            for i, k in enumerate(PLANES):
                small = np.asarray(delta["planes"][k], np.int32)
                planes[i, :, :small.shape[1]] = small
            if "prop_val" in delta["planes"]:
                pv = np.asarray(delta["planes"]["prop_val"], np.int32)
                prop[:, :pv.shape[1]] = pv
            self._write_rows(rows, planes, prop,
                             np.asarray(delta["count"], np.int32),
                             np.asarray(delta["overflow"], np.int32))
        self._restore_intervals(delta)

    @classmethod
    def from_jax_snapshot(cls, snap: dict, device="cuda",
                          mesh=None) -> "TensorStringStore":
        """Rebuild a store from the plain dict that the JAX
        ``TensorStringStore.snapshot()`` returns (numpy planes plus the
        interner tables and intervals) — or from this store's own
        ``snapshot()`` — so both packages continue from the same state.
        ``mesh`` shards the restored planes (either package's snapshot, of
        a sharded store or not)."""
        n_docs = len(snap["count"])
        store = cls(n_docs, snap["capacity"], snap["n_props"], device, mesh)
        fields = {}
        for k in cls.SNAP_PLANES:
            small = np.asarray(snap["planes"][k], np.int32)
            fill = NOT_REMOVED if k == "removed_seq" else 0
            plane = np.full((n_docs, store.capacity) + small.shape[2:],
                            fill, np.int32)
            plane[:, :small.shape[1]] = small
            fields[k] = plane
        fields["count"] = snap["count"]
        fields["overflow"] = snap["overflow"]
        # copies: the state is updated in place and must not write
        # through to the snapshot's arrays (on a mesh the split copies)
        fields = {k: torch.as_tensor(np.asarray(v, np.int32))
                  for k, v in fields.items()}
        store.state = StringState(**fields if mesh is not None else {
            k: v.to(store.device, copy=True) for k, v in fields.items()})
        store._payloads = [tuple(p) for p in snap["payloads"]]
        store._client_idx = [dict(m) for m in snap["client_idx"]]
        store._prop_planes = dict(snap["prop_planes"])
        store._prop_values = ValueInterner.restore(snap["prop_values"])
        store._has_props = bool(snap["has_props"])
        store._restore_intervals(snap)
        return store
