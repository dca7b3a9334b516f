"""The read plane: encode-once window fanout and catch-up through
generation diffs.

Counterpart of ``fluidframework_tpu/server/read_plane.py`` (Routerlicious'
Broadcaster → Redis → socket.io fan-out: a sequenced op is encoded once
and the pub/sub tier fans the bytes to every listening client). The
bytes this module writes for a window are the JAX package's bytes for
the same log records.

Three surfaces:

- **window encoding** (:func:`encode_window`): the durable log's
  columnar records become wire frames straight from their planes. A
  string ``ColumnarOps`` re-enters the columnar door's own ``B`` / ``R``
  layout (``server/columnar_ingress.py``): ``row`` holds the
  record-local doc index (the ``docs`` table rides in a ``J`` meta
  frame), ``cseq`` the sequenced seq, ``ref`` the writing client,
  chunked at the u8 table bounds. A ``TreeRecordOps`` ships its raw
  record planes and batch-local tables as one binary ``T`` frame. Map,
  matrix and per-op records fall back to a JSON ``rec`` frame through
  ``expand()``.
- **the pump** (:class:`ReadPlane`): per-partition cursors over the
  engine's log cut everything new into one window a pump; the engine
  pumps after every flush and string columnar wave that applied ops
  (``ServingEngineBase.attach_read_plane``), so windows land at ingest
  pace.
- **catch-up** (:func:`build_generation_diff` /
  :func:`apply_generation_diff`): two full summary generations of one
  engine lineage diff into a synthetic incremental-summary delta (the TO
  store restored on ``device``, only its dirty rows gathered, against the
  FROM generation's append-only table lengths); a joiner at the FROM
  generation resolves it with the engines' own delta machinery
  (``resolve_summary_chain`` → ``apply_row_snapshot``) and replays only
  the TO generation's log tail.

A :class:`ReadReplica` samples its drain lag into a
``StalenessTracker`` (``server/observer.py``) behind
``read_staleness_p99_s``.
"""

from __future__ import annotations

import json
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.protocol import ColumnarWireKind, MessageType
from ..ops.axis_kernel import TensorAxisStore
from ..ops.map_kernel import TensorMapStore
from ..ops.matrix_kernel import TensorMatrixStore
from ..ops.string_store import TensorStringStore
from ..ops.tree_store import TensorTreeStore
from ..parallel.replicated import OplogFollower
from ..utils.telemetry import REGISTRY
from .columnar_ingress import (
    _OP_DTYPE, encode_frame, encode_json, encode_op_batch,
)
from .observer import STALENESS, ObserverHub, StalenessTracker
from .serving import DedupLedger, engine_class, restore_sequencer

#: the binary tree-window frame: u32 header length + JSON header (tables
#: and sequencing columns) + raw int32 ``rec_op`` (R,) + ``recs`` (R, 8)
_U32 = struct.Struct("<I")

#: u8 table bound of the B / R layouts (table counts are single bytes on
#: the wire): frames chunk at this many distinct texts or props
_TABLE_MAX = 255
#: u16 bound of the row / a0 / a1 record slots
_U16_MAX = 0xFFFF

_WIRE_OK = {int(ColumnarWireKind.INSERT), int(ColumnarWireKind.REMOVE),
            int(ColumnarWireKind.ANNOTATE)}


# ---------------------------------------------------------------- encoding

def _encode_json_ops(rec, wid: int) -> List[bytes]:
    """JSON fallback: a log record expanded to per-op rows. Map, matrix
    and generic batches and per-op messages take this path."""
    ops = []
    msgs = rec.expand() if hasattr(rec, "expand") else (rec,)
    for m in msgs:
        if m.type != MessageType.OP:
            continue
        ops.append([m.doc_id, m.seq, m.client_id, m.contents])
    if not ops:
        return []
    return [encode_json({"t": "rec", "fmt": "json", "wid": wid,
                         "ops": ops})]


def _encode_string_cops(rec, wid: int) -> List[bytes]:
    """One string ``ColumnarOps`` record → a ``J`` meta frame (the doc
    table) and ``B`` / ``R`` frames encoded straight from the planes.
    ``row`` carries the record-local doc index, ``cseq`` the sequenced
    seq, ``ref`` the writing client; ``kind`` / ``a0`` / ``a1`` / ``tidx``
    keep their write-path meaning, so an observer parses the frames with
    the door's ``parse_op_tables``. Chunks where a chunk's distinct
    texts or props would pass the u8 table bound; falls back to JSON when
    a plane does not fit its wire slot (a doc index past u16 among
    them: a window over more than 65,536 docs)."""
    n = len(rec.seq)
    kind = np.asarray(rec.kind, np.int64)
    a0 = np.asarray(rec.a0, np.int64)
    a1 = np.asarray(rec.a1, np.int64)
    doc = np.asarray(rec.doc, np.int64)
    seq = np.asarray(rec.seq, np.int64)
    client = np.asarray(rec.client, np.int64)
    if (not set(np.unique(kind).tolist()) <= _WIRE_OK
            or (a0 < 0).any() or a0.max(initial=0) > _U16_MAX
            or (a1 < 0).any() or a1.max(initial=0) > _U16_MAX
            or doc.max(initial=0) > _U16_MAX
            or seq.max(initial=0) > 0xFFFFFFFF
            or (client < 0).any() or client.max(initial=0) > 0xFFFFFFFF):
        return _encode_json_ops(rec, wid)

    # per-op payload-table handle: a broadcast text is handle 0 everywhere
    texts = rec.texts if rec.texts is not None else [rec.text]
    tidx = (np.asarray(rec.tidx, np.int64) if rec.tidx is not None
            else np.zeros(n, np.int64))
    props = rec.props
    if any(len(t.encode()) > _U16_MAX for t in texts):
        return _encode_json_ops(rec, wid)

    frames = [encode_json({"t": "rec", "fmt": "cops", "wid": wid,
                           "docs": list(rec.doc_ids), "n": int(n)})]
    is_ann = kind == int(ColumnarWireKind.ANNOTATE)
    tidx_l = tidx.tolist()
    ann_l = is_ann.tolist()
    # texts and props share the tidx plane but index different tables:
    # each chunk's distinct handles of each must fit the u8 counts
    start = 0
    while start < n:
        t_seen: Dict[int, int] = {}
        p_seen: Dict[int, int] = {}
        end = start
        while end < n:
            h = tidx_l[end]
            seen = p_seen if ann_l[end] else t_seen
            if h not in seen:
                if len(seen) >= _TABLE_MAX:
                    break
                seen[h] = len(seen)
            end += 1
        sl = slice(start, end)
        out = np.zeros(end - start, _OP_DTYPE)
        out["row"] = doc[sl]
        out["kind"] = kind[sl]
        out["a0"] = a0[sl]
        out["a1"] = a1[sl]
        out["cseq"] = seq[sl]
        out["ref"] = client[sl]
        out["tidx"] = [(p_seen if a else t_seen)[h]
                       for h, a in zip(tidx_l[sl], ann_l[sl])]
        chunk_texts = [texts[h] for h in t_seen]
        chunk_props = [props[h] for h in p_seen] if p_seen else None
        frames.append(encode_op_batch(chunk_texts, out, props=chunk_props))
        start = end
    return frames


def _encode_tree_recs(rec, wid: int) -> List[bytes]:
    """One ``TreeRecordOps`` record → one binary ``T`` frame: a JSON
    header with the batch-local tables (ids / fields / types / values)
    and the per-op sequencing columns, then the raw int32 record planes
    (``rec_op``, ``recs``) as recovery replays them."""
    rec_op = np.ascontiguousarray(rec.rec_op, np.int32)
    recs = np.ascontiguousarray(rec.recs, np.int32)
    header = {
        "t": "tree", "wid": wid, "docs": list(rec.doc_ids),
        "doc": np.asarray(rec.doc).tolist(),
        "seq": np.asarray(rec.seq).tolist(),
        "client": np.asarray(rec.client).tolist(),
        "ids": list(rec.ids), "fields": list(rec.fields),
        "types": list(rec.types), "values": list(rec.values),
        "n_recs": int(recs.shape[0]),
    }
    hb = json.dumps(header).encode()
    payload = b"".join([_U32.pack(len(hb)), hb,
                        rec_op.tobytes(), recs.tobytes()])
    return [encode_frame(b"T", payload)]


def decode_tree_frame(payload) -> Tuple[dict, np.ndarray, np.ndarray]:
    """Inverse of :func:`_encode_tree_recs`: (header, rec_op, recs)."""
    (hlen,) = _U32.unpack_from(payload, 0)
    header = json.loads(bytes(payload[4:4 + hlen]))
    r = int(header["n_recs"])
    off = 4 + hlen
    rec_op = np.frombuffer(payload, np.int32, count=r, offset=off)
    recs = np.frombuffer(payload, np.int32, count=r * 8,
                         offset=off + r * 4).reshape(r, 8)
    return header, rec_op, recs


def encode_record(rec, wid: int) -> Tuple[List[bytes], int]:
    """One durable-log record → its observer frames and its op count."""
    if getattr(rec, "family", None) == "str":
        return _encode_string_cops(rec, wid), len(rec.seq)
    if hasattr(rec, "recs"):          # TreeRecordOps
        return _encode_tree_recs(rec, wid), len(rec.seq)
    frames = _encode_json_ops(rec, wid)
    if hasattr(rec, "expand"):
        n = len(rec.seq)
    else:
        n = 1 if rec.type == MessageType.OP else 0
    return frames, n


def encode_window(records, wid: int) -> Tuple[bytes, int]:
    """Encode one sequenced window (the records a flush made durable) as
    one byte run: a ``J`` window header, then every record's frames, the
    records in the order of their first seq (partitions interleave; a
    doc's seqs rise across its records). Once a window: the hub hands
    the same bytes to every subscriber."""
    frames: List[bytes] = []
    n_ops = 0
    keyed = []
    for rec in records:
        seqs = getattr(rec, "seq", 0)
        if isinstance(seqs, (int, np.integer)):
            first = int(seqs)
        else:
            first = int(np.min(seqs)) if len(seqs) else 0
        keyed.append((first, len(keyed), rec))
    keyed.sort(key=lambda kr: (kr[0], kr[1]))
    for _, _, rec in keyed:
        fs, n = encode_record(rec, wid)
        frames.extend(fs)
        n_ops += n
    header = encode_json({"t": "window", "wid": wid, "n_ops": n_ops,
                          "n_frames": len(frames)})
    return header + b"".join(frames), n_ops


# ------------------------------------------------------------- the pump

class ReadPlane:
    """Log → observer pump of one serving engine: per-partition offset
    cursors over the engine's log; each :meth:`pump` cuts everything new
    into one window, encodes it once and publishes the bytes to the hub.
    The cursors start at the log's current end."""

    def __init__(self, engine, hub=None):
        self.engine = engine
        self.hub = hub if hub is not None else ObserverHub()
        self.log = engine.log
        self._offsets = [self.log.size(p)
                         for p in range(self.log.n_partitions)]
        self._lock = threading.Lock()
        self.windows = 0
        self.ops_published = 0

    def pump(self) -> int:
        """Encode and publish one window of everything newly durable;
        returns the ops published (0: nothing new, no window). Only
        records below each partition's size at read time are taken, so a
        writer appending meanwhile is never read half-way."""
        with self._lock:
            records = []
            for p in range(self.log.n_partitions):
                size = self.log.size(p)
                if size <= self._offsets[p]:
                    continue
                records.extend(self.log.read(
                    p, from_offset=self._offsets[p], to_offset=size))
                self._offsets[p] = size
            if not records:
                return 0
            wid = self.hub.next_wid()
            payload, n_ops = encode_window(records, wid)
            self.hub.publish(wid, payload, n_ops)
            self.windows += 1
            self.ops_published += n_ops
            REGISTRY.inc("read_windows_total")
        return n_ops


# ---------------------------------------------------------------- catch-up

def summary_doc_seqs(summary: dict) -> Dict[str, int]:
    """Per-doc sequenced seq of a summary's sequencer checkpoint, read on
    the host: the Python checkpoint directly, a native one through a
    throwaway sequencer restored from it."""
    ckpt = summary["deli"]
    if isinstance(ckpt, dict) and "native" not in ckpt:
        return {d: int(s["seq"]) for d, s in ckpt.items()}
    seqr = restore_sequencer(ckpt)
    return {d: int(seqr.doc_seq(d)) for d in summary["doc_rows"]}


def _changed(from_summary: dict, to_summary: dict) -> Tuple[set, set]:
    """(changed doc ids, dirty TO-store rows) between two generations:
    docs whose seq moved, and rows whose doc ↔ row mapping moved (their
    planes were rewritten outside the op stream: graduation, reuse)."""
    from_seqs = summary_doc_seqs(from_summary)
    to_seqs = summary_doc_seqs(to_summary)
    to_rows = to_summary["doc_rows"]
    from_rows = from_summary["doc_rows"]
    changed_docs = {d for d, s in to_seqs.items() if from_seqs.get(d) != s}
    dirty = {to_rows[d] for d in changed_docs if d in to_rows}
    dirty |= {r for d, r in from_rows.items() if to_rows.get(d) != r}
    dirty |= {r for d, r in to_rows.items() if from_rows.get(d) != r}
    return changed_docs, dirty


def _interner_len(snap) -> int:
    """Table length of an exported interner (a dict with ``names``, or a
    list)."""
    if isinstance(snap, dict):
        return len(snap["names"])
    return len(snap)


def build_generation_diff(family: str, from_summary: dict,
                          to_summary: dict, device="cuda") -> dict:
    """Diff two FULL generations of one engine lineage into a synthetic
    incremental-summary delta: the TO store restored on ``device``, only
    its dirty rows gathered (``snapshot_rows`` / ``snapshot_delta``)
    against the FROM generation's append-only table lengths. The result
    is what a live ``summarize(incremental=True)`` would have captured
    between the two checkpoints; :func:`apply_generation_diff` resolves
    it. A delta summary, or a doc-sharded matrix pool, is refused."""
    for s, name in ((from_summary, "from"), (to_summary, "to")):
        if s.get("kind") == "delta":
            raise ValueError(f"{name}_summary is a delta — generation "
                             "diffs run between FULL generations")
    changed_docs, dirty_rows = _changed(from_summary, to_summary)
    diff = {k: to_summary[k] for k in
            ("deli", "log_offsets", "chain_heads", "doc_rows", "min_seq")}
    if "attribution" in to_summary:
        diff["attribution"] = to_summary["attribution"]
    diff["kind"] = "delta"
    diff["base"] = None           # the reader attaches its local base
    diff["dedup"] = DedupLedger.load(
        to_summary.get("dedup")).snapshot(docs=changed_docs)
    base_m = {(d, int(c)) for d, c in from_summary.get("members") or []}
    cur_m = {(d, int(c)) for d, c in to_summary.get("members") or []}
    diff["members_delta"] = {
        "join": sorted([d, c] for d, c in cur_m - base_m),
        "leave": sorted([d, c] for d, c in base_m - cur_m)}
    dirty = sorted(dirty_rows)

    if family == "string":
        store = TensorStringStore.from_jax_snapshot(to_summary["store"],
                                                    device)
        diff["store_delta"] = store.snapshot_rows(
            dirty, len(from_summary["store"]["payloads"]),
            _interner_len(from_summary["store"]["prop_values"]))
        # the small tiers ride in full, as in live deltas
        diff["mega_store"] = to_summary.get("mega_store")
        diff["mega_rows"] = dict(to_summary.get("mega_rows", {}))
        if "free_mega_rows" in to_summary:
            diff["free_mega_rows"] = list(to_summary["free_mega_rows"])
        diff["graduated"] = to_summary.get("graduated", {})
    elif family == "map":
        store = TensorMapStore.restore(to_summary["store"], device)
        diff["store_delta"] = store.snapshot_rows(
            dirty, _interner_len(from_summary["store"]["values"]))
    elif family == "matrix":
        if "sharded_docs" in to_summary["store"]:
            raise ValueError("sharded matrix generations cannot diff — "
                             "restore the full summary onto the mesh")
        store = TensorMatrixStore.restore(to_summary["store"], device)
        axis = TensorAxisStore.restore(to_summary["axis_store"], device)
        diff["cells_delta"] = store.snapshot_delta({
            "cell_ids": len(from_summary["store"]["cell_ids"]),
            "values": _interner_len(from_summary["store"]["values"]),
        }) if dirty else None
        axis_rows = [a for r in dirty for a in (2 * r, 2 * r + 1)]
        diff["axis_delta"] = axis.snapshot_rows(
            axis_rows, len(from_summary["axis_store"]["runs"]))
        fww = to_summary["fww"]
        meta = to_summary["cell_meta"]
        diff["fww_delta"] = {r: fww.get(r) for r in dirty}
        diff["cell_meta_delta"] = {r: meta.get(r) for r in dirty}
        diff["n_docs"] = to_summary["n_docs"]
    elif family == "tree":
        store = TensorTreeStore.restore(to_summary["store"], device)
        diff["store_delta"] = store.snapshot_rows(dirty, {
            k: _interner_len(from_summary["store"][k])
            for k in ("ids", "fields", "types", "values")})
        diff["graduated"] = to_summary.get("graduated", {})
    else:
        raise ValueError(f"unknown family {family!r}")
    REGISTRY.inc("read_catchup_diffs_total")
    return diff


def apply_generation_diff(family: str, diff: dict, base_summary: dict,
                          log, device="cuda"):
    """Catch a joiner up: attach its local base generation to the diff
    and load through the engine's own path on ``device`` — base restore,
    the dirty rows written over it, the sequencer at the TO checkpoint,
    then the tail replayed from the TO generation's ``log_offsets`` only.
    Returns the caught-up engine."""
    d = dict(diff)
    d["base"] = base_summary
    return engine_class(family).load(d, log, device=device)


# ----------------------------------------------------------------- replicas

class ReadReplica:
    """A read replica riding ``OplogFollower.catch_up``: each
    :meth:`poll` drains the leader's new durable records into the
    replica engine (built on ``device``) and samples how stale the
    replica was when the drain began (the age of the oldest record it
    had not applied, from the records' append timestamps)."""

    def __init__(self, leader, summary: Optional[dict] = None,
                 tracker: Optional[StalenessTracker] = None,
                 device="cuda", **engine_kw):
        self.follower = OplogFollower(leader, summary=summary,
                                      device=device, **engine_kw)
        self.engine = self.follower.engine
        self.tracker = tracker if tracker is not None else STALENESS
        self.polls = 0
        self.ops_applied = 0

    def poll(self) -> int:
        """One catch-up beat; returns the ops applied, samples staleness
        when it applied any."""
        t0 = time.time()
        oldest = None
        log = self.follower.log
        for p in range(log.n_partitions):
            off = self.follower._offsets[p]
            if log.size(p) <= off:
                continue
            # only the oldest unapplied record of each partition
            for rec in log.read(p, from_offset=off, to_offset=off + 1):
                ts = getattr(rec, "timestamp", 0.0) or 0.0
                if ts > 0:
                    oldest = ts if oldest is None else min(oldest, ts)
        n = self.follower.catch_up()
        self.polls += 1
        self.ops_applied += n
        if n:
            self.tracker.observe(max(0.0, t0 - oldest) if oldest else 0.0)
        return n
