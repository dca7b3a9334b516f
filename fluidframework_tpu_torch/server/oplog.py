"""Partitioned, durable, ordered op log — the Kafka analog.

Reference counterpart: Kafka as Routerlicious' ordering backbone: topics
are partitioned, each partition is an ordered durable log, documents map
to partitions by a stable hash, consumers track offsets. Here: an
in-process partitioned log with optional JSONL spill to disk. The
serving engines append every sequenced op to it before they ack, and
recover from it: a summary records each partition's offset, and a load
replays the tail past it.

Without ``spill_dir`` the log lives in memory only: no chain, no JSON,
no fence file — an append is a list append, a byte charge and a counter
bump. ``server/native_oplog.py`` holds the same API on CRC-framed C++
segment files with an fsync barrier (``sync``).

Recovery (``PartitionedLog.recover``) tolerates a TORN TAIL: a crash mid-
write leaves the last JSONL line truncated; recovery skips it, truncates
the file back to the last complete record, and continues — the same
semantics as the native log's CRC-checked tail truncation. An op lost to
a torn tail was by construction never acked (``append`` returns — and
the caller acks — only after the line is fully written and flushed).

**Checksum chain.** Every spilled line is prefixed with an 8-hex-digit
chain word: ``chain_i = crc32(payload_i, chain_{i-1})`` (zlib CRC-32,
seeded with the previous record's chain word, ``chain_{-1} = 0``). The
word covers the exact payload bytes on disk — never a re-serialization —
so a flipped bit, a mid-file truncation that regrows, or a spliced /
reordered record all break the chain at a detectable offset. Verification
runs on ``recover()`` and whenever a reader anchors a tail replay against
a summary's recorded chain head (``chain_at``). Legacy lines (bare JSON,
no prefix) are accepted unverified so pre-chain spills still replay. The
chain protects bytes on disk: a memory-only log has no chain and
``chain_head``/``chain_at`` return ``None``.

**Epoch fence.** The log carries a monotonic fence word (persisted next
to the spill as ``{name}-fence.json``). ``open_for_append(epoch)`` hands
out a fenced writer; an append stamped with an epoch below the fence
raises :class:`FencedWriterError` instead of interleaving seqs — the
Kafka zombie-producer fence. ``bump_fence()`` is the takeover edge; an
engine takes it through ``acquire_write_authority()``.

The files are the JAX package's format, byte for byte: either package
recovers the other's spill directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils import capacity
from ..utils.atomicfile import atomic_write_json, read_json
from ..utils.faultpoints import (
    SITE_OPLOG_MID_APPEND, SITE_OPLOG_MID_SPILL, fault_point,
)
from ..utils.telemetry import REGISTRY


class OplogCorruptionError(ValueError):
    """A durable record failed its checksum chain (or is unparseable in a
    position a crash cannot produce). Carries the evidence a scrubber or
    an operator needs: file, record index, byte offset, reason."""

    def __init__(self, message: str, *, path: str = "",
                 index: int = -1, offset: int = -1, reason: str = ""):
        super().__init__(message)
        self.path = path
        self.index = index
        self.offset = offset
        self.reason = reason


class FencedWriterError(RuntimeError):
    """An append carried an epoch below the log's fence word — the caller
    is a deposed writer (split-brain) and must not extend the stream."""

    def __init__(self, message: str, *, epoch: int = -1, fence: int = -1):
        super().__init__(message)
        self.epoch = epoch
        self.fence = fence


def chain_step(payload: bytes, prev: int) -> int:
    """One link of the checksum chain: CRC-32 of the record's exact
    on-disk payload bytes, seeded with the previous record's chain word."""
    return zlib.crc32(payload, prev & 0xFFFFFFFF) & 0xFFFFFFFF


def _spill_json(o):
    """Lossless JSONL spill encoding: numpy arrays become full lists (the
    default str() repr elides long arrays — unrecoverable), dataclass
    records (SequencedDocumentMessage, ColumnarOps) become dicts."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return {"__type__": type(o).__name__, **dataclasses.asdict(o)}
    return str(o)


def _spill_decode(obj: Any) -> Any:
    """Revive a spilled record: ``__type__``-tagged dicts become their
    dataclasses again (array fields back to np arrays, enum fields back
    to enums) so a recovered log replays through the same code paths as
    the in-memory one."""
    if not (isinstance(obj, dict) and "__type__" in obj):
        return obj
    kind = obj.pop("__type__")
    if kind == "SequencedDocumentMessage":
        from ..core.protocol import MessageType, SequencedDocumentMessage
        obj["type"] = MessageType(obj["type"])
        return SequencedDocumentMessage(**obj)
    if kind == "ColumnarOps":
        from .serving import ColumnarOps
        for k in ("doc", "client", "client_seq", "ref_seq", "seq",
                  "min_seq", "kind", "a0", "a1"):
            obj[k] = np.asarray(obj[k], np.int64)
        if obj.get("tidx") is not None:
            obj["tidx"] = np.asarray(obj["tidx"], np.int64)
        return ColumnarOps(**obj)
    if kind == "TreeRecordOps":
        from .serving import TreeRecordOps
        for k in ("doc", "client", "client_seq", "ref_seq", "seq",
                  "min_seq", "rec_op"):
            obj[k] = np.asarray(obj[k], np.int64)
        obj["recs"] = np.asarray(obj["recs"], np.int32)
        return TreeRecordOps(**obj)
    obj["__type__"] = kind  # unknown dataclass: keep the tagged dict
    return obj


def partition_of(doc_id: str, n_partitions: int) -> int:
    """Stable doc → partition mapping (document-level parallelism axis)."""
    h = 2166136261
    for ch in doc_id.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h % n_partitions


def scan_chained_spill(path: str, decode: bool = False) -> Dict[str, Any]:
    """Scan one partition's JSONL spill, verifying the checksum chain.

    Never raises on corrupt content — callers decide policy. Returns::

        {"records": [...],     # parsed (decode=True revives dataclasses)
         "chains":  [...],     # cumulative chain word after each record
         "offsets": [...],     # byte offset each record starts at
         "good_end": int,      # byte end of the verified prefix
         "torn": bool,         # unterminated junk tail dropped (crash)
         "problems": [...]}    # [{"index","offset","reason"}] — scan
                               # stops at the first problem (the chain is
                               # meaningless past a break)

    Line grammar: ``<8 hex chain word><space><json payload>\\n``. Lines
    starting with ``{`` are legacy (pre-chain) records: parsed, chain
    carried through unchanged, never verified. A parse/verify failure on
    the LAST, unterminated line is a torn tail (crash artifact); the same
    failure anywhere else — or on a newline-terminated last line — is a
    problem (real corruption)."""
    records: List[Any] = []
    chains: List[int] = []
    offsets: List[int] = []
    problems: List[Dict[str, Any]] = []
    good_end = 0
    torn = False
    chain = 0
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        # an empty spill is clean (a partition that never wrote), not a
        # torn tail — split() would otherwise yield one unterminated
        # empty "line" here
        return {"records": records, "chains": chains, "offsets": offsets,
                "good_end": 0, "torn": False, "problems": problems}
    lines = data.split(b"\n")
    terminated = data.endswith(b"\n")
    n_lines = len(lines) - (1 if terminated else 0)
    for i in range(n_lines):
        line = lines[i]
        if i == n_lines - 1 and not terminated:
            # an unterminated final line is a torn tail even when it
            # parses: its flush never completed (so it was never acked),
            # and keeping it would fuse the next append onto the same
            # physical line
            torn = True
            break
        reason = None
        payload = line
        stored = None
        if line[:1] != b"{":
            # chained line: 8-hex chain word, space, payload
            if len(line) >= 10 and line[8:9] == b" ":
                try:
                    stored = int(line[:8], 16)
                except ValueError:
                    reason = "bad chain word"
                payload = line[9:]
            else:
                reason = "unparseable line"
        if reason is None:
            try:
                obj = json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                reason = "unparseable record"
            else:
                if stored is not None:
                    expect = chain_step(payload, chain)
                    if stored != expect:
                        reason = "chain mismatch"
        if reason is not None:
            problems.append(
                {"index": i, "offset": good_end, "reason": reason})
            break
        offsets.append(good_end)
        chain = chain if stored is None else stored
        chains.append(chain)
        records.append(_spill_decode(obj) if decode else obj)
        good_end += len(line) + 1
    return {"records": records, "chains": chains, "offsets": offsets,
            "good_end": good_end, "torn": torn, "problems": problems}


def _read_spill_tolerant(path: str) -> Tuple[List[Any], int, bool, List[int]]:
    """Parse one partition's JSONL spill, verifying the checksum chain.
    Returns (records, byte offset of the end of the last verified record,
    whether a torn tail was dropped, per-record chain words). A decode or
    chain failure on any line but an unterminated last one is real
    corruption (not a crash artifact) and raises
    :class:`OplogCorruptionError`."""
    scan = scan_chained_spill(path, decode=True)
    if scan["problems"]:
        p = scan["problems"][0]
        REGISTRY.inc("oplog_chain_verify_failures_total")
        raise OplogCorruptionError(
            f"corrupt spill record mid-file in {path} "
            f"(record {p['index'] + 1}, byte {p['offset']}): "
            f"{p['reason']} — not a crash torn-tail",
            path=path, index=p["index"], offset=p["offset"],
            reason=p["reason"])
    return scan["records"], scan["good_end"], scan["torn"], scan["chains"]


class _FencedWriter:
    """Append handle bound to one epoch — every append it forwards is
    fence-checked against the log's current fence word."""

    def __init__(self, log: "PartitionedLog", epoch: int):
        self.log = log
        self.epoch = epoch

    def append(self, partition: int, record: Any) -> int:
        return self.log.append(partition, record, epoch=self.epoch)


class _FencedChainLog:
    """The epoch fence and the chain index, shared by ``PartitionedLog``
    and ``native_oplog.NativePartitionedLog``. A log sets
    ``n_partitions``, ``_plocks``, ``_label`` (the name its errors
    carry) and ``_chains`` (the cumulative chain word of each record,
    per partition; ``None`` when the log keeps no chain), then calls
    ``_init_fence`` with its fence file (``None``: memory-only, the word
    lives in this object alone)."""

    def _init_fence(self, path: Optional[str]) -> None:
        self._fence_file = path
        self._fence_mtime: Optional[int] = None
        self.fence_epoch = 0
        if path is not None and os.path.exists(path):
            self._fence_mtime = os.stat(path).st_mtime_ns
            self.fence_epoch = int(read_json(path).get("epoch", 0))

    def _refresh_fence(self) -> None:
        """Pick up a fence bump written by ANOTHER process/instance on
        the same directory (one stat per fenced append — the split-brain
        case is a separate recovered service, not just a shared log
        object). Monotone: the file can only raise the in-memory word."""
        path = self._fence_file
        if path is None:
            return
        try:
            m = os.stat(path).st_mtime_ns
        except OSError:
            return
        if m != self._fence_mtime:
            self._fence_mtime = m
            try:
                self.fence_epoch = max(
                    self.fence_epoch, int(read_json(path).get("epoch", 0)))
            except (OSError, ValueError):
                pass

    def fence(self, epoch: int) -> int:
        """Raise the fence word to ``epoch`` (monotone; persisted when the
        log has a fence file). Appends stamped below the fence are
        rejected."""
        self._refresh_fence()
        self.fence_epoch = max(self.fence_epoch, int(epoch))
        path = self._fence_file
        if path is not None:
            atomic_write_json(path, {"epoch": self.fence_epoch})
            self._fence_mtime = os.stat(path).st_mtime_ns
        return self.fence_epoch

    def bump_fence(self) -> int:
        """The takeover edge: advance the fence by one and return the new
        epoch — the caller is now the sole legitimate writer; any handle
        still stamping the old epoch gets :class:`FencedWriterError`."""
        return self.fence(self.fence_epoch + 1)

    def open_for_append(self, epoch: int) -> _FencedWriter:
        """Return a fenced append handle bound to ``epoch``. The epoch
        must be current (>= the fence word) at open time."""
        self._refresh_fence()
        if epoch < self.fence_epoch:
            REGISTRY.inc("fenced_appends_rejected_total")
            raise FencedWriterError(
                f"{self._label}: epoch {epoch} is behind fence "
                f"{self.fence_epoch}", epoch=epoch, fence=self.fence_epoch)
        return _FencedWriter(self, epoch)

    def _check_epoch(self, partition: int, epoch: int) -> None:
        """An append's epoch against the fence word, BEFORE any mutation
        — a deposed writer changes nothing. An epoch that passes on the
        in-memory word is checked against the persisted one too (a
        recovered instance in another process bumps the file, not this
        object)."""
        if epoch >= self.fence_epoch:
            self._refresh_fence()
        if epoch < self.fence_epoch:
            REGISTRY.inc("fenced_appends_rejected_total")
            raise FencedWriterError(
                f"{self._label}/p{partition}: append from stale epoch "
                f"{epoch} (fence {self.fence_epoch})",
                epoch=epoch, fence=self.fence_epoch)

    def chain_head(self, partition: int) -> Optional[int]:
        """Current chain word of the partition (0 when empty); ``None``
        for a log that keeps no chain (no durable bytes)."""
        if self._chains is None:
            return None
        with self._plocks[partition]:
            ch = self._chains[partition]
            return ch[-1] if ch else 0

    def chain_at(self, partition: int, offset: int) -> Optional[int]:
        """Chain word after the first ``offset`` records (``offset=0`` →
        the seed 0); ``None`` when unavailable (no chain kept, or the
        partition is shorter than ``offset`` — truncation!)."""
        if self._chains is None:
            return None
        with self._plocks[partition]:
            ch = self._chains[partition]
            if offset == 0:
                return 0
            if offset > len(ch):
                return None
            return ch[offset - 1]


class PartitionedLog(_FencedChainLog):
    def __init__(self, n_partitions: int = 8,
                 spill_dir: Optional[str] = None, name: str = "log"):
        self.n_partitions = n_partitions
        self.spill_dir = spill_dir
        self.name = name
        self._label = name
        self._parts: List[List[Any]] = [[] for _ in range(n_partitions)]
        # host bytes of each partition's in-memory tail, charged O(1)
        # per append (recomputed on recover) so mem_stats never walks
        # the record lists
        self._mem_bytes: List[int] = [0] * n_partitions
        self._subs: List[List[Callable[[int, int, Any], None]]] = [
            [] for _ in range(n_partitions)]
        # per-partition locks: each partition's list, spill handle, and
        # subscriber list are independent — appends on different partitions
        # never contend (the Kafka-partition parallelism this log models).
        # The lock is reentrant and held across append+notify so consumers
        # observe offsets in order.
        self._plocks = [threading.RLock() for _ in range(n_partitions)]
        self._spill = None
        # cumulative chain word per appended record, per partition; only
        # maintained when a spill exists (the chain covers disk bytes)
        self._chains: Optional[List[List[int]]] = None
        if spill_dir is None:
            self._init_fence(None)
            return
        os.makedirs(spill_dir, exist_ok=True)
        self._spill = [
            open(os.path.join(spill_dir, f"{name}-p{i}.jsonl"), "a")
            for i in range(n_partitions)
        ]
        self._chains = [[] for _ in range(n_partitions)]
        self._init_fence(os.path.join(spill_dir, f"{name}-fence.json"))

    # ------------------------------------------------------------------
    @classmethod
    def recover(cls, n_partitions: int, spill_dir: str,
                name: str = "log") -> "PartitionedLog":
        """Rebuild a log from its JSONL spill after a crash. Torn tails
        (partial last line from a mid-write kill) are dropped and the
        file truncated back to the last complete record, so subsequent
        appends continue a clean stream — matching ``native_oplog``'s
        CRC tail truncation. Every surviving record's checksum chain is
        verified; a mid-file break raises :class:`OplogCorruptionError`
        (repair = truncate the file to the verified prefix that
        ``scan_chained_spill`` reports). Returns a log with spill
        re-attached."""
        records: List[List[Any]] = []
        chains: List[List[int]] = []
        for i in range(n_partitions):
            path = os.path.join(spill_dir, f"{name}-p{i}.jsonl")
            if not os.path.exists(path):
                records.append([])
                chains.append([])
                continue
            recs, good_end, torn, ch = _read_spill_tolerant(path)
            if torn:
                REGISTRY.inc("oplog_torn_tails_recovered")
                with open(path, "r+b") as f:
                    f.truncate(good_end)
            records.append(recs)
            chains.append(ch)
        log = cls(n_partitions, spill_dir, name)
        for i, recs in enumerate(records):
            log._parts[i] = recs
            log._chains[i] = chains[i]
            log._mem_bytes[i] = sum(map(capacity.record_nbytes, recs))
        return log

    def append(self, partition: int, record: Any,
               epoch: Optional[int] = None) -> int:
        """Append; returns the record's offset. Notifies subscribers inline,
        in offset order (in-process stand-in for the consumer poll loop).
        ``epoch`` (from a fenced writer) is checked against the fence word
        BEFORE any mutation — a deposed writer changes nothing."""
        if epoch is not None and (epoch < self.fence_epoch
                                  or self._fence_file is not None):
            self._check_epoch(partition, epoch)
        with self._plocks[partition]:
            part = self._parts[partition]
            offset = len(part)
            part.append(record)
            self._mem_bytes[partition] += capacity.record_nbytes(record)
            REGISTRY.inc("oplog_appends")
            # crash here = record in memory, nothing durable, NOT acked
            fault_point(SITE_OPLOG_MID_APPEND, partition=partition,
                        offset=offset)
            if self._spill is not None:
                payload = json.dumps(record, default=_spill_json)
                prev = self._chains[partition]
                chain = chain_step(
                    payload.encode("utf-8"), prev[-1] if prev else 0)
                line = f"{chain:08x} {payload}\n"
                # crash mid-line = the torn tail recovery must tolerate;
                # an armed plan may ask for a partial write (realistic
                # kill between write syscalls)
                fault_point(SITE_OPLOG_MID_SPILL, partition=partition,
                            offset=offset, line=line,
                            fh=self._spill[partition])
                self._spill[partition].write(line)
                self._spill[partition].flush()
                prev.append(chain)
                REGISTRY.inc("oplog_spill_lines")
                REGISTRY.inc("oplog_spill_bytes", len(line))
            subs = self._subs[partition]
            if subs:
                for fn in list(subs):
                    fn(partition, offset, record)
        return offset

    def subscribe(self, partition: int,
                  fn: Callable[[int, int, Any], None],
                  from_offset: int = 0) -> None:
        """Register a consumer; replays records from ``from_offset`` first
        (the rebalance/recovery path)."""
        with self._plocks[partition]:
            backlog = list(self._parts[partition][from_offset:])
            self._subs[partition].append(fn)
            for i, rec in enumerate(backlog):
                fn(partition, from_offset + i, rec)

    def close(self) -> None:
        if self._spill is not None:
            for f in self._spill:
                f.close()
            self._spill = None

    def read(self, partition: int, from_offset: int = 0,
             to_offset: Optional[int] = None) -> List[Any]:
        with self._plocks[partition]:
            return list(self._parts[partition][from_offset:to_offset])

    def size(self, partition: int) -> int:
        with self._plocks[partition]:
            return len(self._parts[partition])

    def mem_stats(self) -> dict:
        """In-memory tail bytes and record counts per partition,
        O(n_partitions) — the byte counters are maintained at append
        time, never recomputed."""
        parts = []
        for i in range(self.n_partitions):
            with self._plocks[i]:
                parts.append({"partition": i,
                              "records": len(self._parts[i]),
                              "bytes": int(self._mem_bytes[i])})
        return {"parts": parts,
                "records": sum(p["records"] for p in parts),
                "total_bytes": sum(p["bytes"] for p in parts)}
