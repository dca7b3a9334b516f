"""ctypes binding for the native durable op log + the binary op codec.

The C++ log (``native/oplog.cpp``) owns the IO hot path: CRC-framed
append-only partition segments with torn-tail truncation on open — the
durable-ordered-log role Kafka plays in Routerlicious. This module adds
the record codec (a fixed struct header + JSON contents blob for a
message; width-coded planes for a columnar or tree record batch) and
exposes the same API as ``oplog.PartitionedLog`` so the serving engines
take either: ``NativePartitionedLog`` survives a process crash, and
``sync()`` is its group-commit point (an fsync per partition).

The library builds at first use (``native/build.py``); a failed build
raises. Nothing falls back to the in-memory log when this one was asked
for. The segment files, the chain frame and the fence file are the JAX
package's format, byte for byte.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import threading
from typing import Any, Callable, List, Optional

import numpy as np

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..native.build import ensure_built
from ..utils.faultpoints import SITE_OPLOG_MID_APPEND, fault_point
from ..utils.telemetry import REGISTRY
from .oplog import OplogCorruptionError, _FencedChainLog, chain_step

_lib = None


def _load():
    """The library's ctypes handle, built at first use (raises when the
    build fails). Loaded with ctypes' default ``RTLD_LOCAL``: another
    library exporting the same ``oplog_*`` symbols in this process
    never shadows these."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built("liboplog.so"))
    lib.oplog_open.restype = ctypes.c_void_p
    lib.oplog_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.oplog_close.argtypes = [ctypes.c_void_p]
    lib.oplog_append.restype = ctypes.c_int64
    lib.oplog_append.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 ctypes.c_char_p, ctypes.c_int64]
    lib.oplog_sync.restype = ctypes.c_int32
    lib.oplog_sync.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.oplog_size.restype = ctypes.c_int64
    lib.oplog_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.oplog_record_len.restype = ctypes.c_int64
    lib.oplog_record_len.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                     ctypes.c_int64]
    lib.oplog_read.restype = ctypes.c_int64
    lib.oplog_read.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                               ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_int64]
    _lib = lib
    return lib


def _is_columnar(record: Any) -> bool:
    from .serving import ColumnarOps  # lazy: serving does not import us
    return isinstance(record, ColumnarOps)


def _is_tree_records(record: Any) -> bool:
    from .serving import TreeRecordOps  # lazy: serving does not import us
    return isinstance(record, TreeRecordOps)


# ------------------------------------------------------------------- codec
# Fixed header (little-endian): client_id, client_seq, ref_seq, seq,
# min_seq as int64, type as int32, doc_id length as int32, service
# timestamp as float64 (NaN = unset) — then doc_id bytes, then the
# JSON-encoded contents blob. The ints the device kernels consume ride in
# fixed slots; only the variable payload needs JSON.

_HEADER = struct.Struct("<qqqqqiid")
_NO_TS = float("nan")

# Columnar record (tag b"D"): the struct-of-arrays ``ColumnarOps`` batch
# framed directly — n_ops + timestamp + two length-prefixed blobs (doc-id
# table as JSON, broadcast text as UTF-8) followed by the nine planes,
# n_ops each, then a length-prefixed JSON extras blob and, when present,
# the tidx plane. Every plane is width-coded integers: no JSON, no reprs,
# losslessly recoverable (a ``default=str`` fallback would turn them into
# elided numpy reprs).
_COL_HEADER = struct.Struct("<qdqq")
_COL_FIELDS = ("doc", "client", "client_seq", "ref_seq", "seq", "min_seq",
               "kind", "a0", "a1")


def _plane_width(plane) -> int:
    """Smallest signed byte width ∈ {1, 2, 4, 8} holding the plane."""
    if plane.size == 0:
        return 1
    lo, hi = int(plane.min()), int(plane.max())
    for w, bound in ((1, 1 << 7), (2, 1 << 15), (4, 1 << 31)):
        if -bound <= lo and hi < bound:
            return w
    return 8


def _encode_plane(plane, n: int) -> bytes:
    plane = np.asarray(plane)
    assert plane.shape == (n,), "plane length mismatch"
    w = _plane_width(plane)
    return bytes([w]) + np.ascontiguousarray(
        plane, dtype=f"<i{w}").tobytes()


def _decode_plane(data: bytes, off: int, n: int):
    w = data[off]
    arr = np.frombuffer(data, dtype=f"<i{w}", count=n,
                        offset=off + 1).astype(np.int64)
    return arr, off + 1 + w * n


def encode_columnar(rec) -> bytes:
    """Each plane prefixed by ONE width byte and stored at the smallest
    signed width that holds its values: all-int64 planes would cost
    72 B/op, width coding brings a typical batch to ~16 B/op."""
    doc_ids = json.dumps(rec.doc_ids).encode()
    text = rec.text.encode()
    n = len(rec.seq)
    parts = [_COL_HEADER.pack(n, float(rec.timestamp), len(doc_ids),
                              len(text)), doc_ids, text]
    for f in _COL_FIELDS:
        parts.append(_encode_plane(getattr(rec, f), n))
    # extras: payload/annotate/map tables + op family; the tidx plane
    # follows only when present (has_tidx)
    extras = json.dumps({"texts": rec.texts, "props": rec.props,
                         "family": rec.family, "keys": rec.keys,
                         "values": rec.values,
                         "has_tidx": rec.tidx is not None}).encode()
    parts.append(struct.pack("<q", len(extras)))
    parts.append(extras)
    if rec.tidx is not None:
        parts.append(_encode_plane(rec.tidx, n))
    return b"".join(parts)


# Tree record batch (tag b"T"): n_ops + n_recs + timestamp + one JSON
# tables blob (doc ids + the 1-based id/field/type/value wire tables),
# then width-coded per-op planes (doc, client, client_seq, ref_seq, seq,
# min_seq), the rec_op plane, and the 8 record columns — every plane at
# its smallest signed width, like the columnar frame.
_TREE_HEADER = struct.Struct("<qqdq")
_TREE_OP_FIELDS = ("doc", "client", "client_seq", "ref_seq", "seq",
                   "min_seq")


def decode_columnar(data: bytes):
    from .serving import ColumnarOps  # lazy: serving does not import us
    n, ts, dlen, tlen = _COL_HEADER.unpack_from(data)
    off = _COL_HEADER.size
    doc_ids = json.loads(data[off:off + dlen])
    off += dlen
    text = data[off:off + tlen].decode()
    off += tlen
    planes = {}
    for f in _COL_FIELDS:
        planes[f], off = _decode_plane(data, off, n)
    (elen,) = struct.unpack_from("<q", data, off)
    off += 8
    extras = json.loads(data[off:off + elen])
    off += elen
    tidx = _decode_plane(data, off, n)[0] if extras["has_tidx"] else None
    return ColumnarOps(doc_ids=doc_ids, text=text, timestamp=ts,
                       texts=extras["texts"], props=extras["props"],
                       tidx=tidx, family=extras["family"],
                       keys=extras["keys"], values=extras["values"],
                       **planes)


def encode_tree_records(rec) -> bytes:
    n, r = len(rec.seq), len(rec.rec_op)
    tables = json.dumps({"doc_ids": rec.doc_ids, "ids": rec.ids,
                         "fields": rec.fields, "types": rec.types,
                         "values": rec.values}).encode()
    parts = [_TREE_HEADER.pack(n, r, float(rec.timestamp), len(tables)),
             tables]
    for f in _TREE_OP_FIELDS:
        parts.append(_encode_plane(getattr(rec, f), n))
    parts.append(_encode_plane(rec.rec_op, r))
    for col in range(8):
        parts.append(_encode_plane(rec.recs[:, col], r))
    return b"".join(parts)


def decode_tree_records(data: bytes):
    from .serving import TreeRecordOps  # lazy: serving does not import us
    n, r, ts, tlen = _TREE_HEADER.unpack_from(data)
    off = _TREE_HEADER.size
    tables = json.loads(data[off:off + tlen])
    off += tlen
    planes = {}
    for f in _TREE_OP_FIELDS:
        planes[f], off = _decode_plane(data, off, n)
    rec_op, off = _decode_plane(data, off, r)
    cols = []
    for _c in range(8):
        col, off = _decode_plane(data, off, r)
        cols.append(col.astype(np.int32))
    recs = (np.stack(cols, axis=1) if r
            else np.zeros((0, 8), np.int32))
    return TreeRecordOps(
        doc_ids=tables["doc_ids"], ids=tables["ids"],
        fields=tables["fields"], types=tables["types"],
        values=tables["values"], rec_op=rec_op, recs=recs,
        timestamp=ts, **planes)


def encode_message(msg: SequencedDocumentMessage) -> bytes:
    doc = msg.doc_id.encode()
    contents = json.dumps(
        {"c": msg.contents, "a": msg.address, "m": msg.metadata},
        default=str).encode()
    ts = _NO_TS if msg.timestamp is None else float(msg.timestamp)
    return _HEADER.pack(msg.client_id, msg.client_seq, msg.ref_seq,
                        msg.seq, msg.min_seq, int(msg.type),
                        len(doc), ts) + doc + contents


def decode_message(data: bytes) -> SequencedDocumentMessage:
    (client_id, client_seq, ref_seq, seq, min_seq, mtype,
     doc_len, ts) = _HEADER.unpack_from(data)
    doc_id = data[_HEADER.size:_HEADER.size + doc_len].decode()
    blob = json.loads(data[_HEADER.size + doc_len:])
    msg = SequencedDocumentMessage(
        doc_id=doc_id, client_id=client_id, client_seq=client_seq,
        ref_seq=ref_seq, seq=seq, min_seq=min_seq,
        type=MessageType(mtype), contents=blob["c"],
        metadata=blob.get("m"), address=blob.get("a"),
        timestamp=None if ts != ts else ts)
    return msg


# --------------------------------------------------------------------- log


class NativePartitionedLog(_FencedChainLog):
    """Durable PartitionedLog on the C++ segment files: same API surface
    (append/read/size/subscribe), crash-safe — reopen the same directory
    and every record before a torn tail is back.

    Integrity plane: appended payloads are wrapped as
    ``b"H" + <4-byte LE chain word> + <tagged record>`` where
    ``chain_i = crc32(tagged_record_i, chain_{i-1})`` (seed 0) — the same
    hash chain as ``oplog.PartitionedLog``'s spill, layered on top of the
    C side's per-frame CRC (which catches a flipped bit in one frame but
    not a spliced/reordered/regrown stream). The chain is verified on
    open. The C side's open cuts a partition at its first frame whose
    CRC fails, wherever it lies: a flipped bit in a middle frame drops
    that frame and every later one without an error (the reference's
    behaviour; ROADMAP C9). The log also carries the persisted epoch
    fence word (``fence.json``) with the same ``open_for_append`` /
    ``bump_fence`` contract as the Python log."""

    def __init__(self, directory: str, n_partitions: int = 8):
        lib = _load()
        os.makedirs(directory, exist_ok=True)
        self._lib = lib
        self.n_partitions = n_partitions
        self.directory = directory
        self._label = directory
        self._paths = [os.path.join(directory, f"p{p}.log")
                       for p in range(n_partitions)]
        self._h = lib.oplog_open(directory.encode(), n_partitions)
        if not self._h:
            raise RuntimeError(f"oplog_open failed for {directory}")
        self._subs: List[List[Callable[[int, int, Any], None]]] = [
            [] for _ in range(n_partitions)]
        # per-partition locks, as in oplog.PartitionedLog: the C side's
        # fseek/fwrite pairs and the shared FILE* cursor are not
        # thread-safe — an unlocked concurrent append would tear frames,
        # which the CRC scan then silently truncates on reopen. The
        # explicit cursor contract: under the partition lock, the next
        # append's offset is exactly the record count (`len(_chains[p])`,
        # kept in lockstep with the C side and asserted on every append),
        # so the chain verifier can never race the FILE* cursor.
        self._plocks = [threading.RLock() for _ in range(n_partitions)]
        self._chains: List[List[int]] = [
            self._rebuild_chain(p) for p in range(n_partitions)]
        self._init_fence(os.path.join(directory, "fence.json"))

    def _rebuild_chain(self, partition: int) -> List[int]:
        """Walk the partition's surviving records (the C side already
        truncated any torn tail on open), rebuild the hash chain from the
        raw frame payloads and verify every word of it."""
        chains: List[int] = []
        chain = 0
        for off in range(self.size(partition)):
            raw = self._raw(partition, off)
            stored = int.from_bytes(raw[1:5], "little")
            if raw[:1] != b"H" or stored != chain_step(raw[5:], chain):
                REGISTRY.inc("oplog_chain_verify_failures_total")
                raise OplogCorruptionError(
                    f"chain break mid-file in {self.directory} "
                    f"p{partition} record {off}: stored "
                    f"{stored:#010x} != expected chain — not a crash "
                    f"torn-tail", path=self.directory, index=off,
                    reason="chain mismatch")
            chain = stored
            chains.append(chain)
        return chains

    def append(self, partition: int, record: Any,
               epoch: Optional[int] = None) -> int:
        # tags: b"N" = message, b"D" = columnar batch, b"T" = tree record
        # batch, b"J" = plain JSON control record; the stored payload
        # wraps the tagged record in the b"H" chain frame
        if epoch is not None:
            self._check_epoch(partition, epoch)
        if isinstance(record, SequencedDocumentMessage):
            tag, data = b"N", encode_message(record)
        elif _is_columnar(record):
            tag, data = b"D", encode_columnar(record)
        elif _is_tree_records(record):
            tag, data = b"T", encode_tree_records(record)
        else:
            # STRICT json — a silently-lossy str() fallback here would
            # corrupt recovery (oplog._spill_json's docstring names the
            # failure); anything unencodable must fail the append loudly
            try:
                data = json.dumps(record).encode()
            except (TypeError, ValueError) as e:
                raise TypeError(
                    f"record {type(record).__name__} is not losslessly "
                    f"loggable (need SequencedDocumentMessage, ColumnarOps "
                    f"or JSON-safe data): {e}") from None
            tag = b"J"
        with self._plocks[partition]:
            chains = self._chains[partition]
            expected_off = len(chains)
            inner = tag + data
            chain = chain_step(inner, chains[-1] if chains else 0)
            payload = b"H" + chain.to_bytes(4, "little") + inner
            # crash here = nothing of the record on disk, NOT acked
            fault_point(SITE_OPLOG_MID_APPEND, partition=partition,
                        offset=expected_off, nbytes=8 + len(payload),
                        path=self._paths[partition])
            offset = self._lib.oplog_append(self._h, partition, payload,
                                            len(payload))
            if offset < 0:
                raise IOError(f"append to partition {partition} failed")
            # the explicit FILE*-cursor invariant: the C append cursor and
            # our chain list advance in lockstep under the partition lock
            assert offset == expected_off, (
                f"oplog cursor desync on p{partition}: C side returned "
                f"offset {offset}, chain tracks {expected_off}")
            chains.append(chain)
            for fn in list(self._subs[partition]):
                fn(partition, offset, record)
        return offset

    def sync(self, partition: Optional[int] = None) -> None:
        """fsync barrier (group-commit point) for one or all partitions."""
        parts = range(self.n_partitions) if partition is None else (partition,)
        for p in parts:
            with self._plocks[p]:
                if self._lib.oplog_sync(self._h, p) != 0:
                    raise IOError(f"fsync of partition {p} failed")

    def size(self, partition: int) -> int:
        return int(self._lib.oplog_size(self._h, partition))

    def _raw(self, partition: int, offset: int) -> bytes:
        """Read one record's raw frame payload (chain wrapper intact)."""
        with self._plocks[partition]:
            n = self._lib.oplog_record_len(self._h, partition, offset)
            if n < 0:
                raise IndexError((partition, offset))
            buf = (ctypes.c_uint8 * n)()
            got = self._lib.oplog_read(self._h, partition, offset, buf, n)
            if got != n:
                raise IOError(f"read p{partition}@{offset} failed (CRC?)")
        return bytes(buf)

    def _record(self, partition: int, offset: int) -> Any:
        # chain frame: b"H", the 4-byte LE word, then the tagged record
        raw = self._raw(partition, offset)[5:]
        if raw[:1] == b"N":
            return decode_message(raw[1:])
        if raw[:1] == b"D":
            return decode_columnar(raw[1:])
        if raw[:1] == b"T":
            return decode_tree_records(raw[1:])
        return json.loads(raw[1:])

    def read(self, partition: int, from_offset: int = 0):
        for off in range(from_offset, self.size(partition)):
            yield self._record(partition, off)

    def subscribe(self, partition: int,
                  fn: Callable[[int, int, Any], None],
                  from_offset: int = 0) -> None:
        with self._plocks[partition]:  # no append between backlog & register
            for off in range(from_offset, self.size(partition)):
                fn(partition, off, self._record(partition, off))
            self._subs[partition].append(fn)

    def close(self) -> None:
        if self._h:
            self._lib.oplog_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
