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
"""

from __future__ import annotations

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
                     compact8: bool = False, tab_n: int = 0):
    """Device-side unpack of ONE columnar batch (an int32 word buffer) into
    dense (n_docs or R, O) op planes plus the fused min_seq.

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
    if scatter_rows:
        def full(p, fill):
            out = torch.full((n_docs, O), fill, dtype=_I32, device=buf.device)
            out[rows.long()] = p
            return out
        planes = (full(planes[0], _NOOP),) + \
            tuple(full(p, 0) for p in planes[1:])
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


class TensorStringStore(StringOpInterner):
    """D documents × S segment slots of merge-tree state on ``device``.

    The state's tensors are updated in place by every apply (the JAX store
    donated them); compaction replaces them."""

    def __init__(self, n_docs: int, capacity: int = 256, n_props: int = 4,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.capacity = capacity
        # until the first annotate the kernel runs its no-props mode
        # (all-zero planes are permutation-invariant)
        self.state = StringState.create(n_docs, capacity, n_props,
                                        device=self.device)
        self._init_interner(n_docs, n_props)
        #: wire profile of the last columnar batch (None before the first)
        self.last_profile: Optional[tuple] = None
        #: rich payload wire form of the last batch: plane/tab8/tab16
        self.last_rich_wire: Optional[str] = None
        #: op width of each launch of the last ``apply_messages``
        self.last_op_windows: List[int] = []

    # ----------------------------------------------------------------- apply

    def apply_messages(self, messages) -> None:
        """messages: iterable of (doc, SequencedDocumentMessage) carrying
        merge-tree op contents. Each doc's records apply in order: in one
        launch, or in consecutive op windows when one launch cannot take
        them all (the apply is an in-order fold per doc and the overflow
        flag is sticky, so the windows leave the same state)."""
        for planes in self._message_planes(messages):
            self._dispatch_apply(tuple(torch.from_numpy(p).to(self.device)
                                       for p in planes))

    def _message_planes(self, messages) -> List[np.ndarray]:
        """Intern ``messages`` and lay their device records out as dense
        op planes: one (7, n_docs, O) int32 array per launch, O the power-
        of-two bucket of the widest doc's records (the JAX store's static
        shapes), capped at ``_op_window()``; NOOP pads. Records intern
        here, so every returned window must be applied, in order."""
        per_doc: Dict[int, list] = {}
        for doc, msg in messages:
            recs = self._records_for(doc, msg)
            if recs:
                per_doc.setdefault(doc, []).extend(recs)
        self.last_op_windows = []
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
        apply_string_batch_fused(self.state, *op_planes, min_seq=min_seq,
                                 with_props=self._has_props)

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

    def _pack_payload_tables(self, kind, a0, a1, text, texts, tidx,
                             props) -> PrepackedPlanes:
        """The payload/props side of a columnar apply's wire form: intern
        payloads, pack props, choose the rich wire mode, resolve insert
        lengths. Depends only on the raw op planes, never on sequencing;
        mutates the interner, so call in submission order."""
        pp = PrepackedPlanes()
        R, O = kind.shape
        ins = kind == _INS
        ann = kind == _ANN
        if ann.any() and props is None:
            raise ValueError("annotate slots require the props table")
        pp.rich = not (texts is None and props is None)
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

    def prepack_planes(self, kind, a0, a1, text: str = "", texts=None,
                       tidx=None, props=None) -> PrepackedPlanes:
        """Pipelined-ingest hook: the seq-independent pack work for a wave,
        run ahead of its sequencing; hand the result to
        ``apply_planes(prepacked=...)``."""
        return self._pack_payload_tables(
            np.asarray(kind, np.int32), np.asarray(a0, np.int32),
            np.asarray(a1, np.int32), text, texts, tidx, props)

    def apply_planes(self, rows, kind, a0, a1, seq_base, client_id, ref_seq,
                     text: str = "", min_seq=None, texts=None, tidx=None,
                     props=None, prepacked=None) -> None:
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
        behind the op's own seq) or ``ref_wide`` (i32 ref)."""
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
            pp = self._pack_payload_tables(kind, a0, a1, text, texts, tidx,
                                           props)
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
        fuse = min_seq is not None
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
        if compact8:
            kc = np.where(kind == _NOOP, 3, kind) | (cidx << 2)
            head = [seg_u8(kc), seg_u16(a0), seg_u8(span), seg_u8(lag)]
        elif ref_wide:
            head = [seg_u8(kind), seg_u8(cidx), seg_pos(a0), seg_pos(a1),
                    np.ascontiguousarray(ref_seq, "<i4").reshape(-1)]
        else:  # ship the u16 lag; the device rebuilds ref = seq - lag
            head = [seg_u8(kind), seg_u8(cidx), seg_pos(a0), seg_pos(a1),
                    seg_u16(lag)]
        if rich_mode >= 2:
            tail = [(seg_u8 if rich_mode == 2 else seg_u16)(pp.tidx_eff),
                    pp.tab_a2.astype("<i4", copy=False),
                    pp.tab_len.astype("<i4", copy=False)]
        else:
            tail = [np.ascontiguousarray(pp.a2_np, "<i4").reshape(-1)]
        buf = np.concatenate(head + tail + [
            seq_base.astype("<i4", copy=False),
            rows.astype("<i4", copy=False),
            ms.astype("<i4", copy=False),
        ])
        self._tab_release(pp)
        planes, ms_dev = _columnar_unpack(
            torch.from_numpy(buf).to(self.device), R=R, O=O,
            pos_wide=not narrow, ref_wide=ref_wide, rich=rich_mode,
            n_docs=self.n_docs, fuse_compact=fuse, scatter_rows=scatter_rows,
            compact8=compact8, tab_n=pp.tab_n)
        self._dispatch_apply(planes, ms_dev if fuse else None)

    def compact(self, min_seq) -> None:
        """Zamboni: free tombstones below the collaboration window
        (``min_seq`` scalar or (n_docs,))."""
        ms = np.full((self.n_docs,), int(min_seq), np.int32) \
            if np.isscalar(min_seq) else np.asarray(min_seq, np.int32)
        self.state = compact_string_state(
            self.state, torch.from_numpy(ms).to(self.device),
            with_props=self._has_props)

    # ----------------------------------------------------------------- reads

    def _pull_doc(self, doc: int):
        """One fused device→host gather of a doc's read planes
        (removed_seq, handle_op, handle_off, length, seq), trimmed to its
        slot count."""
        st = self.state
        S = st.seq.shape[1]
        arr = torch.stack([
            st.removed_seq[doc], st.handle_op[doc], st.handle_off[doc],
            st.length[doc], st.seq[doc], st.count[doc].expand(S),
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
        pv = self.state.prop_val[doc, i].cpu().numpy()
        return {key: self._prop_values.value(int(pv[plane]))
                for key, plane in self._prop_planes.items()
                if pv[plane] != 0}

    def visible_lengths(self) -> np.ndarray:
        """(D,) visible lengths of every doc in one device round trip."""
        st = self.state
        S = st.seq.shape[1]
        active = torch.arange(S, device=self.device)[None, :] < \
            st.count[:, None]
        live = active & (st.removed_seq == NOT_REMOVED)
        return torch.where(live, st.length, 0).sum(
            dim=1, dtype=_I32).cpu().numpy()

    # ----------------------------------------------------- overflow recovery

    def _write_rows(self, rows: torch.Tensor, planes: np.ndarray,
                    prop: np.ndarray, count, overflow) -> None:
        """Overwrite whole doc rows: ``planes`` (7, n, S) in PLANES order,
        ``prop`` (n, S, K), ``count`` and ``overflow`` (n,)."""
        st, dev = self.state, self.device
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
        self._write_rows(torch.tensor([row], device=self.device), planes,
                         prop, [n], [0])

    def clear_doc(self, row: int) -> None:
        """Empty a row (its doc graduated off this store): fill planes,
        count 0, overflow flag cleared."""
        planes, prop = self._empty_rows(1)
        self._write_rows(torch.tensor([row], device=self.device), planes,
                         prop, [0], [0])
        self._cidx_cache = None

    def overflowed(self) -> np.ndarray:
        return self.state.overflow.cpu().numpy()

    def slot_usage(self) -> np.ndarray:
        return self.state.count.cpu().numpy()

    def digests(self) -> np.ndarray:
        return string_state_digest(self.state).cpu().numpy()

    # ----------------------------------------------------- snapshot / resume

    def snapshot(self) -> dict:
        """Device→host gather of the merged state plus the host interning
        tables, in the JAX store's snapshot format (planes trimmed to the
        widest doc's slot count)."""
        st = self.state
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
        }

    def snapshot_rows(self, rows, payloads_base: int,
                      prop_values_base: int) -> dict:
        """Incremental snapshot: only the given doc rows' planes (one
        gather per plane, trimmed to their widest slot count) plus the
        append-only interner deltas since the table lengths
        ``payloads_base`` / ``prop_values_base`` of the last summary. The
        JAX store's ``snapshot_rows`` layout, without interval state."""
        rows = np.ascontiguousarray(rows, np.int32)
        st = self.state
        if len(rows):
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
        }

    def apply_row_snapshot(self, delta: dict) -> None:
        """Fold one ``snapshot_rows`` delta (this package's or the JAX
        store's) into this restored-base store: extend the append-only
        interner tables and overwrite the dirty rows. A delta holding
        interval segments is refused."""
        if any(delta.get("intervals") or []):
            raise ValueError("row snapshot holds interval segments, which "
                             "the PyTorch store does not support yet")
        self._payloads.extend(tuple(p) for p in delta["payloads_delta"])
        self._prop_planes = dict(delta["prop_planes"])
        self._prop_values.extend_from(delta["prop_values_delta"])
        self._has_props = self._has_props or bool(delta["has_props"])
        # the plane map and the dirty rows' client maps are replaced
        self._props_pack_cache = {}
        self._cidx_cache = None
        rows = np.asarray(delta["rows"], np.int32)
        if not len(rows):
            return
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
        self._write_rows(torch.from_numpy(rows).to(self.device).long(),
                         planes, prop, np.asarray(delta["count"], np.int32),
                         np.asarray(delta["overflow"], np.int32))

    @classmethod
    def from_jax_snapshot(cls, snap: dict,
                          device="cuda") -> "TensorStringStore":
        """Rebuild a store from the plain dict that the JAX
        ``TensorStringStore.snapshot()`` returns (numpy planes plus the
        interner tables) — or from this store's own ``snapshot()`` — so
        both packages continue from the same state. Interval segments are
        not ported: a snapshot holding intervals is refused."""
        if any(snap.get("intervals") or []):
            raise ValueError("snapshot holds interval segments, which the "
                             "PyTorch store does not support yet")
        n_docs = len(snap["count"])
        store = cls(n_docs, snap["capacity"], snap["n_props"], device)
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
        # through to the snapshot's arrays
        store.state = StringState(**{
            k: torch.as_tensor(np.asarray(v, np.int32)).to(store.device,
                                                            copy=True)
            for k, v in fields.items()})
        store._payloads = [tuple(p) for p in snap["payloads"]]
        store._client_idx = [dict(m) for m in snap["client_idx"]]
        store._prop_planes = dict(snap["prop_planes"])
        store._prop_values = ValueInterner.restore(snap["prop_values"])
        store._has_props = bool(snap["has_props"])
        return store
