"""The columnar front door: N client sockets → ONE batched
``ingest_planes`` call a window.

Reference counterpart: Alfred's ingress + Kafka's batch aggregation in
front of Deli. Clients speak a width-coded BINARY op frame (16 B an op +
shared payload tables); the server aggregates every connection's ops
into per-window planes and drives the serving engine's columnar path
(``StringServingEngine.ingest_planes``), so socket fan-in composes with
the device's one B1 launch a window.

Protocol (little-endian, own framing: u8 type + u32 len + payload +
crc32):

- type ``J``: JSON control — {"t": "join", "docs": [...], "tenant"?,
  "client_id"?} → {"t": "joined", "client_id", "rows": {doc: row}, "lcs":
  {doc: last acked clientSeq}} (the reference's restart ``epoch`` is
  not sent: this door has no restart generation); ack frames {"t": "acks",
  "acks": [[client_seq, seq], ...], "rows": [...]} (seq < 0 = nack code);
  admission-shed ops answer with {"t": "throttled", "rows": [...],
  "cseqs": [...], "retry_after_ms"}: resubmit the SAME cseqs after the
  hint (``server/admission.py``); {"t": "bye"} closes.
- type ``B``: op batch — u8 n_texts, per text (u16 len + utf-8 bytes),
  then N × 16-byte records ``row u16 | kind u8 | a0 u16 | a1 u16 |
  tidx u8 | cseq u32 | ref u32`` (kind codes:
  ``core.protocol.ColumnarWireKind`` — 0 = insert of texts[tidx] at a0,
  1 = remove [a0, a1)).
- type ``R``: rich op batch — the ``B`` layout with a props table
  between the text table and the records: u8 n_props, per prop (u16
  len + utf-8 JSON of a SINGLE-key {key: value} dict). Adds kind 2 =
  annotate [a0, a1) with props[tidx].

Ingest path (accumulate, then drain): per-client readers do NOT parse
frames; they append raw ``recv`` chunks to a per-connection buffer and
poke the flusher. A drain pass then decodes EVERY connection's bytes at
once: frame split + CRC check and the gather of op records into int32
planes (``native/ingress.cpp`` through ``server/native_ingress.py``),
per-frame payload tables interned across the pass, and the backlog
carved into unique-row windows (a stable sort by row and a per-row
occurrence level: per-doc FIFO across windows is the sort's stability).
Each window is one ``ingest_planes`` call (O = 1), through the
``PipelinedIngestExecutor`` when ``pipeline_depth > 0``; acks go back
only after the window's log append. A partial frame stays buffered for
the next pass.

``decode`` picks the drain tier: ``"native"`` (the default) is the
native library, built at first use (a failed build or load raises;
nothing falls back); ``"numpy"`` is the pure-Python tier, reached only
when asked for by name.

The door takes one engine. The reference's partitioned door (an engine
a partition, each with its executor) and its replica digest tap, and
its live operations HTTP plane (``start_ops``), are not ported yet.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.protocol import ColumnarWireKind
from ..utils import capacity, tracing
from ..utils.backoff import Backoff, retry
from ..utils.telemetry import REGISTRY, MetricsRegistry
from . import native_ingress
from .ingest_pipeline import PipelinedIngestExecutor
from .opsd import SpaceSaving, observe_window_timeline
from .wire import BufferedSocketReader, WireError

_HDR = struct.Struct("<BI")
_OP_DTYPE = np.dtype([("row", "<u2"), ("kind", "u1"), ("a0", "<u2"),
                      ("a1", "<u2"), ("tidx", "u1"), ("cseq", "<u4"),
                      ("ref", "<u4")])
assert _OP_DTYPE.itemsize == 16

_FT_J, _FT_B, _FT_R = ord("J"), ord("B"), ord("R")

#: bound on one frame's payload: how many bytes a single frame may hold
#: hostage in the rx buffer
MAX_PAYLOAD = native_ingress.MAX_PAYLOAD
SCAN_BAD_CRC = native_ingress.SCAN_BAD_CRC
SCAN_TOO_LARGE = native_ingress.SCAN_TOO_LARGE

_K_INS = int(ColumnarWireKind.INSERT)
_K_ANN = int(ColumnarWireKind.ANNOTATE)

#: decode tiers a door takes
DECODES = ("native", "numpy")
#: bytes a connection's reader asks for at a time
_READ_CHUNK = 256 << 10
#: rx bytes past which a reader pauses until the drain pass catches up
_MAX_RX_BYTES = 8 << 20


def encode_frame(ftype: bytes, payload: bytes) -> bytes:
    return _HDR.pack(ftype[0], len(payload)) + payload + \
        struct.pack("<I", zlib.crc32(payload))


def encode_json(obj: dict) -> bytes:
    return encode_frame(b"J", json.dumps(obj).encode())


def encode_op_batch(texts: List[str], ops: np.ndarray,
                    props: Optional[List[dict]] = None) -> bytes:
    """ops: structured array of _OP_DTYPE records. ``props`` (a table of
    single-key dicts indexed by annotate tidx) upgrades the frame to the
    rich ``R`` layout; without it the plain ``B`` frame is emitted."""
    parts = [bytes([len(texts)])]
    for t in texts:
        b = t.encode()
        parts.append(struct.pack("<H", len(b)))
        parts.append(b)
    if props is not None:
        parts.append(bytes([len(props)]))
        for p in props:
            b = json.dumps(p).encode()
            parts.append(struct.pack("<H", len(b)))
            parts.append(b)
    parts.append(np.ascontiguousarray(ops).tobytes())
    return encode_frame(b"R" if props is not None else b"B",
                        b"".join(parts))


def read_frame(sock) -> Tuple[int, bytes]:
    """One frame from a blocking socket: ``(ftype, payload)``. Raises
    ``WireError`` on a CRC mismatch or a peer that closed mid-frame."""
    hdr = _recv_exact(sock, _HDR.size)
    ftype, length = _HDR.unpack(hdr)
    payload = _recv_exact(sock, length)
    (crc,) = struct.unpack("<I", _recv_exact(sock, 4))
    if crc != zlib.crc32(payload):
        raise WireError("frame CRC mismatch")
    return ftype, payload


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WireError("peer closed")
        buf += chunk
    return buf


# ------------------------------------------------------- batch decode core
#
# Pure functions shared by the drain pass, the reference decoder, and the
# byte-split tests. No view of the input buffer survives a call (the
# caller trims a live ``bytearray`` right after: a surviving numpy or
# memoryview export would make the resize raise BufferError).

def _py_split_frames(buf) -> Tuple[List[Tuple[int, int, int]], int, int]:
    """Numpy-tier frame splitter: scan ``buf`` for complete
    ``[u8 type | u32 len | payload | u32 crc32]`` frames. Same contract
    as ``native_ingress.scan`` (see ``split_frames``)."""
    frames: List[Tuple[int, int, int]] = []
    off, n, status = 0, len(buf), 0
    mv = memoryview(buf)
    try:
        # 5 buffered bytes = a full header: enough to vet the length
        # field (oversized frames fault before their payload arrives)
        while n - off >= 5:
            ftype, length = _HDR.unpack_from(buf, off)
            if length > MAX_PAYLOAD:
                status = SCAN_TOO_LARGE
                break
            total = 5 + length + 4
            if n - off < total:
                break  # torn frame: wait for more bytes
            (crc,) = struct.unpack_from("<I", buf, off + 5 + length)
            if zlib.crc32(mv[off + 5:off + 5 + length]) != crc:
                status = SCAN_BAD_CRC
                break
            frames.append((ftype, off + 5, length))
            off += total
    finally:
        mv.release()
    return frames, off, status


def split_frames(buf, native: bool = True
                 ) -> Tuple[List[Tuple[int, int, int]], int, int]:
    """Split an accumulated rx buffer into complete CRC-valid frames,
    with the native library or (``native=False``) the numpy tier.

    Returns ``(frames, consumed, status)``: ``frames`` holds
    ``(ftype, payload_off, payload_len)`` per frame, ``consumed`` the
    bytes they cover (a trailing partial frame stays in the buffer for
    the next drain), and ``status`` is 0 / SCAN_BAD_CRC /
    SCAN_TOO_LARGE. On a poisoned frame the scan stops AT it: the good
    prefix is still returned so earlier frames take effect before the
    connection is faulted."""
    if native:
        return native_ingress.scan(buf)
    return _py_split_frames(buf)


def parse_op_tables(payload, rich: bool
                    ) -> Tuple[List[str], List[dict], int]:
    """Parse an op frame's payload tables (text table; props table when
    ``rich``): returns ``(texts, props, rec_off)`` where ``rec_off`` is
    the byte offset of the 16-byte record section. Raises with the
    protocol's diagnostics on malformed tables or a ragged record
    section. Accepts bytes or memoryview."""
    try:
        n_texts = payload[0]
    except IndexError:
        raise IndexError("index out of range") from None
    off = 1
    texts: List[str] = []
    for _ in range(n_texts):
        (ln,) = struct.unpack_from("<H", payload, off)
        off += 2
        texts.append(bytes(payload[off:off + ln]).decode())
        off += ln
    props: List[dict] = []
    if rich:
        try:
            n_props = payload[off]
        except IndexError:
            raise IndexError("index out of range") from None
        off += 1
        for _ in range(n_props):
            (ln,) = struct.unpack_from("<H", payload, off)
            off += 2
            p = json.loads(bytes(payload[off:off + ln]))
            off += ln
            if not isinstance(p, dict) or len(p) != 1:
                raise ValueError("props entries must be single-key dicts")
            props.append(p)
    if (len(payload) - off) % _OP_DTYPE.itemsize:
        raise ValueError("record section not a whole number "
                         "of op records")
    return texts, props, off


def _validate_op_planes(kind: np.ndarray, tidx: np.ndarray, rich: bool,
                        n_texts: int, n_props: int) -> Optional[str]:
    """One frame's whole-frame validation on its gathered planes.
    Returns the reject message or None."""
    top = _K_ANN if rich else int(ColumnarWireKind.REMOVE)
    if kind.size and int(kind.max()) > top:
        return "op kind out of range for this frame type"
    ins = kind == _K_INS
    if ins.any() and (n_texts == 0 or int(tidx[ins].max()) >= n_texts):
        return "tidx out of text-table range"
    ann = kind == _K_ANN
    if ann.any() and (n_props == 0 or int(tidx[ann].max()) >= n_props):
        return "tidx out of props-table range"
    return None


def reference_decode_op_frame(payload: bytes, rich: bool
                              ) -> Tuple[List[str], List[dict],
                                         np.ndarray]:
    """The per-frame decoder, kept as the drain path's oracle: parse +
    validate ONE op frame (whole-frame reject semantics, the drain's
    diagnostics). Returns ``(texts, props, ops)`` or raises."""
    texts, props, off = parse_op_tables(payload, rich)
    ops = np.frombuffer(payload, dtype=_OP_DTYPE, offset=off)
    bad = _validate_op_planes(ops["kind"].astype(np.int32),
                              ops["tidx"].astype(np.int32), rich,
                              len(texts), len(props))
    if bad is not None:
        raise ValueError(bad)
    return texts, props, ops


#: plane names a drained part carries (all 1-D int32, equal length)
_PLANES = ("row", "kind", "a0", "a1", "gidx", "cseq", "ref", "client")


class _ColSession:
    """One accepted socket. The reader ONLY accumulates: raw recv chunks
    append to ``rx`` and poke the server's flusher — every byte of
    protocol decode happens in the drain pass. Outbound frames ride a
    bounded queue (slow-client policy: evict)."""

    def __init__(self, server: "ColumnarAlfred", reader, writer):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.client_id: Optional[int] = None
        self.out: asyncio.Queue = asyncio.Queue(maxsize=4096)
        self.evicted = False
        self.dead = False
        self.rx = bytearray()
        #: perf_counter of the first undrained byte: the rx-buffer
        #: crossing of the latency timeline
        self.rx_t0: Optional[float] = None
        #: cleared while the rx buffer is over budget — reader
        #: backpressure until a drain trims it
        self._resume = asyncio.Event()
        self._resume.set()

    async def run(self) -> None:
        srv = self.server
        srv._sessions.add(self)
        sender = asyncio.create_task(self._send_loop())
        try:
            while not self.dead:
                try:
                    chunk = await self.reader.read(_READ_CHUNK)
                except (ConnectionError, OSError):
                    break
                if not chunk:
                    break
                self.rx += chunk
                srv._note_rx(self, len(chunk))
                if len(self.rx) >= _MAX_RX_BYTES:
                    self._resume.clear()
                    # count every pause episode, gauge the readers
                    # parked now
                    srv.rx_pauses += 1
                    srv._rx_paused_now += 1
                    REGISTRY.inc("columnar_rx_paused_total")
                    REGISTRY.set_gauge("rx_paused",
                                       float(srv._rx_paused_now))
                    srv._wake_soon()
                    await self._resume.wait()
                    srv._rx_paused_now -= 1
                    REGISTRY.set_gauge("rx_paused",
                                       float(srv._rx_paused_now))
        finally:
            srv._sessions.discard(self)
            # complete frames that arrived before EOF still drain; their
            # acks go to a closed socket, which resubmit + dedup absorbs
            sender.cancel()
            self.writer.close()

    async def _send_loop(self) -> None:
        while True:
            frame = await self.out.get()
            self.writer.write(frame)
            await self.writer.drain()

    def _push(self, frame: bytes) -> None:
        if self.evicted or self.dead:
            return
        try:
            self.out.put_nowait(frame)
        except asyncio.QueueFull:
            # slow-client policy: evict (the Broadcaster's slow-consumer
            # disconnect); the client reconnects and resumes
            self.evicted = True
            self.server.evictions += 1
            self.writer.close()

    def _push_json(self, obj: dict) -> None:
        self._push(encode_json(obj))

    def _fatal(self, message: Optional[str]) -> None:
        """Protocol-fatal close from the drain pass: flush whatever the
        sender has queued (acks of frames that preceded the poison),
        append the diagnostic, close. ``message=None`` is the orderly
        ``bye`` close."""
        if self.dead:
            return
        self.dead = True
        try:
            while not self.out.empty():
                self.writer.write(self.out.get_nowait())
            if message is not None:
                self.writer.write(encode_json({"t": "error",
                                               "message": message}))
        except (ConnectionError, OSError, RuntimeError,
                asyncio.QueueEmpty):
            pass
        try:
            self.writer.close()
        except (ConnectionError, OSError, RuntimeError):
            pass
        self._resume.set()   # wake a paused reader so run() can exit

    def _handle_json(self, payload: bytes) -> Optional[str]:
        """One control frame (join / resume / bye). Returns None to keep
        serving, or a close reason ("" = orderly bye, non-empty =
        diagnostic)."""
        srv = self.server
        req = json.loads(payload)
        if req.get("t") == "join":
            resume = req.get("client_id")
            if self.client_id is None and resume is not None:
                # session resumption: the client reclaims its identity so
                # the sequencer's dedup cursor still applies to its
                # resubmits
                self.client_id = int(resume)
                srv._next_client = max(srv._next_client,
                                       self.client_id + 1)
                REGISTRY.inc("session_reconnects_total")
            if self.client_id is None:
                self.client_id = srv._next_client
                srv._next_client += 1
            if srv.admission is not None:
                srv.admission.bind(self.client_id, req.get("tenant"))
            rows = {}
            lcs = {}
            for d in req["docs"]:
                if not srv.engine.is_member(d, self.client_id):
                    # re-joining a seated client would RESET its dedup
                    # cursor: resumed members keep their seat
                    srv.engine.connect(d, self.client_id)
                rows[d] = srv.engine.doc_row(d)
                lcs[d] = srv.engine.last_client_seq(d, self.client_id)
            self._push_json({"t": "joined",
                             "client_id": self.client_id,
                             "rows": rows, "lcs": lcs})
            return None
        if req.get("t") == "bye":
            return ""
        return f"unknown {req.get('t')!r}"


class ColumnarAlfred:
    """Binary columnar ingress over a ``StringServingEngine``: aggregates
    every connection's ops into per-window planes, one sequencer call +
    one device dispatch a window.

    ``window_min_rows`` caps a window's rows, ``window_ms`` paces the
    flusher, ``pipeline_depth`` > 0 runs windows through a
    ``PipelinedIngestExecutor`` of that depth (0: one serial
    ``ingest_planes`` a window), ``decode`` picks the drain tier (see
    the module docstring), ``admission`` an optional
    ``AdmissionController``."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 window_min_rows: int = 512, window_ms: float = 2.0,
                 pipeline_depth: int = 2, decode: str = "native",
                 admission=None):
        if decode not in DECODES:
            raise ValueError(f"decode must be one of {DECODES}")
        self._use_native = decode != "numpy"
        if self._use_native:
            native_ingress.load()   # build now: a failure raises here
        self.engine = engine
        #: optional ``AdmissionController``: decoded op planes are offered
        #: to it in the drain pass, BEFORE windows reach the executor;
        #: shed suffixes get a throttled frame
        self.admission = admission
        #: (client_id, row) → lowest shed-but-unreadmitted cseq (suffix
        #: discipline across drain passes — see _admit_planes)
        self._shed_fence: Dict[Tuple[int, int], int] = {}
        #: highest cseq shed in each (client, row) fence run: a full
        #: readmit of a PREFIX of the run advances the fence instead of
        #: clearing it (retry waves may resend only part of the run)
        self._shed_high: Dict[Tuple[int, int], int] = {}
        self.throttled_ops = 0
        self.rx_pauses = 0
        self._rx_paused_now = 0
        self.host = host
        self.port = port
        self.window_min_rows = window_min_rows
        self.window_ms = window_ms
        self.pipeline_depth = pipeline_depth
        self.evictions = 0
        self.windows_flushed = 0
        self.ops_ingested = 0
        self.drain_passes = 0
        self.drained_bytes = 0
        self._drain_ms: deque = deque(maxlen=512)
        self._drain_bytes: deque = deque(maxlen=512)
        self._next_client = 1
        self._sessions: set = set()
        #: sessions with undrained rx bytes (dict = ordered set)
        self._dirty: Dict[_ColSession, None] = {}
        self._rx_backlog = 0
        self._wake_bytes = max(1, window_min_rows) * _OP_DTYPE.itemsize
        #: decoded-but-unwindowed parts from the current drain pass
        self._parts: List[dict] = []
        self._pending_ops = 0
        # pass-scoped payload interners: frame tables dedupe across every
        # connection in the pass; windows re-table compacted slices
        self._texts: List[str] = []
        self._text_of: Dict[str, int] = {}
        self._props: List[dict] = []
        self._prop_of: Dict[Tuple, int] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._wake: Optional[asyncio.Event] = None
        self._executor: Optional[PipelinedIngestExecutor] = None
        self._waves_inflight = 0
        self._capacity: Optional[asyncio.Event] = None
        self._pipeline_error: Optional[BaseException] = None
        #: this door's own stage-latency histograms (the timeline is
        #: observed into the process REGISTRY and here)
        self.metrics = MetricsRegistry()
        #: heavy-hitter sketch over (doc, tenant), fed by the drain pass:
        #: the hot-doc routing / eviction signal
        self.hotdocs = SpaceSaving(capacity=256)
        #: per-row last-touch clock, stamped from the same ``np.unique``
        #: pass that feeds the hot-doc sketch (one scatter a drained part)
        self.idle_ages = capacity.IdleAgeTracker()
        capacity.LEDGER.add_idle_tracker(
            "ColumnarAlfred", self.idle_ages, row_doc_id=self._doc_of_row)
        #: latency timeline of the current drain pass: rx / drain /
        #: decode / admit crossings that every window of the pass
        #: inherits (the engine's stage marks and the ack fan complete it)
        self._pass_tl: Optional[dict] = None
        self._pass_admit_ms = 0.0

    # ------------------------------------------------------------ ingest side

    def _note_rx(self, sess: _ColSession, n: int) -> None:
        """Reader hook: bytes landed on a session. Wake the flusher once
        roughly a window's worth of records is waiting; smaller dribbles
        ride the ``window_ms`` tick."""
        if sess.rx_t0 is None:
            sess.rx_t0 = time.perf_counter()
        self._dirty[sess] = None
        self._rx_backlog += n
        if self._rx_backlog >= self._wake_bytes and self._wake is not None:
            self._wake.set()

    def _wake_soon(self) -> None:
        if self._wake is not None:
            self._wake.set()

    def _intern_text(self, s: str) -> int:
        h = self._text_of.get(s)
        if h is None:
            h = self._text_of[s] = len(self._texts)
            self._texts.append(s)
        return h

    def _intern_prop(self, p: dict) -> int:
        (key, value), = p.items()
        pk = (key, value if not isinstance(value, (dict, list))
              else json.dumps(value, sort_keys=True))
        h = self._prop_of.get(pk)
        if h is None:
            h = self._prop_of[pk] = len(self._props)
            self._props.append(p)
        return h

    def _drain(self) -> None:
        """One whole-buffer decode pass over every dirty connection:
        split frames, verify CRCs, gather op planes, intern tables."""
        if not self._dirty:
            return
        t0 = time.perf_counter()
        sessions = list(self._dirty)
        self._dirty.clear()
        self._rx_backlog = 0
        self._pass_admit_ms = 0.0
        total = 0
        rx_min: Optional[float] = None
        for sess in sessions:
            if sess.dead or not sess.rx:
                continue
            if sess.rx_t0 is not None and (rx_min is None
                                           or sess.rx_t0 < rx_min):
                rx_min = sess.rx_t0
            total += self._drain_session(sess)
        if total:
            t1 = time.perf_counter()
            # pass-level timeline crossings every window of the pass
            # inherits (t_rx = the oldest undrained byte: the worst op's
            # wait)
            self._pass_tl = {"t_rx": rx_min if rx_min is not None else t0,
                             "t_drain0": t0,
                             "admit_ms": self._pass_admit_ms,
                             "t_ready": t1}
            self._drain_ms.append((t1 - t0) * 1e3)
            self._drain_bytes.append(total)
            self.drain_passes += 1
            self.drained_bytes += total
            REGISTRY.inc("columnar_drain_passes")
            REGISTRY.inc("columnar_drained_bytes", total)

    def _drain_session(self, sess: _ColSession) -> int:
        rx = sess.rx
        frames, consumed, status = split_frames(rx,
                                                native=self._use_native)
        fatal: Optional[str] = None
        bye = False
        # per op frame: (abs record offset, count, tmap, pmap, rich,
        # client_id, n_texts, n_props) — gathered in ONE pass below
        runs: List[tuple] = []
        mv = memoryview(rx)
        try:
            for ftype, off, ln in frames:
                if ftype == _FT_B or ftype == _FT_R:
                    if sess.client_id is None:
                        fatal = "join first"
                        break
                    rich = ftype == _FT_R
                    try:
                        texts, props, rec_off = parse_op_tables(
                            mv[off:off + ln], rich)
                    except (ValueError, IndexError, struct.error,
                            UnicodeDecodeError) as e:
                        fatal = f"malformed op frame: {e}"
                        break
                    tmap = np.array([self._intern_text(t) for t in texts],
                                    np.int32)
                    pmap = np.array([self._intern_prop(p) for p in props],
                                    np.int32)
                    runs.append((off + rec_off,
                                 (ln - rec_off) // _OP_DTYPE.itemsize,
                                 tmap, pmap, rich, sess.client_id,
                                 len(texts), len(props)))
                elif ftype == _FT_J:
                    reason = sess._handle_json(bytes(mv[off:off + ln]))
                    if reason is not None:
                        bye, fatal = True, (reason or None)
                        break
                else:
                    fatal = "unknown frame type"
                    break
            else:
                if status == SCAN_BAD_CRC:
                    fatal = "bad crc"
                elif status == SCAN_TOO_LARGE:
                    fatal = "frame too large"
        finally:
            mv.release()
        if runs:
            self._decode_runs(sess, rx, runs)
        # no view of rx survives _decode_runs (planes are copies): the
        # bytearray is free to resize
        if fatal is not None or bye:
            sess._fatal(fatal)
            rx.clear()
            sess.rx_t0 = None
        else:
            del rx[:consumed]
            # leftover bytes are a torn frame whose tail has not arrived:
            # restart its rx clock at the drain
            sess.rx_t0 = time.perf_counter() if rx else None
            if not sess._resume.is_set() \
                    and len(rx) < _MAX_RX_BYTES:
                sess._resume.set()
        return consumed

    def _decode_runs(self, sess: _ColSession, rx: bytearray,
                     runs: List[tuple]) -> None:
        """Gather one session's validated op-frame runs into int32
        planes, map per-frame table indices to pass-global interned ids,
        and queue the part for windowing. Whole-frame reject semantics:
        the first invalid frame faults the connection and discards
        itself plus everything after it; earlier frames stand."""
        if self._use_native:
            planes = native_ingress.gather(rx, [(r[0], r[1])
                                                for r in runs])
            row, kind = planes["row"], planes["kind"]
            a0, a1 = planes["a0"], planes["a1"]
            tidx, cseq, ref = planes["tidx"], planes["cseq"], planes["ref"]
        else:
            views = [np.frombuffer(rx, _OP_DTYPE, count=r[1], offset=r[0])
                     for r in runs]
            rec = np.concatenate(views) if len(views) > 1 \
                else views[0].copy()
            del views
            row = rec["row"].astype(np.int32)
            kind = rec["kind"].astype(np.int32)
            a0 = rec["a0"].astype(np.int32)
            a1 = rec["a1"].astype(np.int32)
            tidx = rec["tidx"].astype(np.int32)
            cseq = rec["cseq"].astype(np.int32)
            ref = rec["ref"].astype(np.int32)
        gidx = np.zeros(row.size, np.int32)
        client = np.empty(row.size, np.int32)
        pos = 0
        keep_until = row.size
        fatal = None
        for _ro, cnt, tmap, pmap, rich, cid, n_texts, n_props in runs:
            sl = slice(pos, pos + cnt)
            bad = _validate_op_planes(kind[sl], tidx[sl], rich,
                                      n_texts, n_props)
            if bad is not None:
                fatal = f"malformed op frame: {bad}"
                keep_until = pos
                break
            if tmap.size:
                m = kind[sl] == _K_INS
                if m.any():
                    gidx[sl][m] = tmap[tidx[sl][m]]
            if pmap.size:
                m = kind[sl] == _K_ANN
                if m.any():
                    gidx[sl][m] = pmap[tidx[sl][m]]
            client[sl] = cid
            pos += cnt
        if keep_until < row.size:
            row, kind, a0, a1 = (x[:keep_until]
                                 for x in (row, kind, a0, a1))
            gidx, cseq, ref, client = (x[:keep_until]
                                       for x in (gidx, cseq, ref, client))
        # per-op row check: a row past the engine, or one that holds no
        # document, errors individually and drops; the rest of the frame
        # stands (the row space is the server's, not the frame layout's).
        # The reference checks only the first: an op on a row no join
        # allocated fails the whole pipeline there (ROADMAP C11).
        n_docs, docs = self.engine.n_docs, self.engine._row_doc_id
        bad = [r for r in np.unique(row).tolist()
               if r >= n_docs or docs[r] is None]
        if bad:
            oob = np.isin(row, bad)
            for r in row[oob].tolist():
                sess._push_json({"t": "error", "message":
                                 f"row {r} out of range" if r >= n_docs
                                 else f"row {r} has no document"})
            ok = ~oob
            row, kind, a0, a1 = (x[ok] for x in (row, kind, a0, a1))
            gidx, cseq, ref, client = (x[ok] for x in
                                       (gidx, cseq, ref, client))
        if row.size and self.admission is not None:
            _t_adm = time.perf_counter()
            row, kind, a0, a1, gidx, cseq, ref, client = \
                self._admit_planes(sess, row, kind, a0, a1, gidx,
                                   cseq, ref, client)
            self._pass_admit_ms += (time.perf_counter() - _t_adm) * 1e3
        if row.size:
            self._note_hotdocs(row, int(client[0]))
            self._parts.append({"sess": sess, "row": row, "kind": kind,
                                "a0": a0, "a1": a1, "gidx": gidx,
                                "cseq": cseq, "ref": ref,
                                "client": client})
            self._pending_ops += int(row.size)
        if fatal is not None:
            sess._fatal(fatal)
            rx.clear()

    def _admit_planes(self, sess: _ColSession, row, kind, a0, a1,
                      gidx, cseq, ref, client):
        """Offer one session's decoded planes to admission, per (client,
        row) group in arrival order; shed suffixes only (the sequencer
        nacks clientSeq gaps) and answer every shed op with ONE
        throttled frame carrying the worst retry hint. A shed fence per
        (client, row) persists across drain passes: higher cseqs keep
        shedding until the fenced cseq itself is readmitted, so the
        client's ordered resubmit can never land behind a gap."""
        adm = self.admission
        keep = np.ones(row.size, bool)
        shed_rows: List[int] = []
        shed_cseqs: List[int] = []
        retry_ms = 0.0
        cid = int(client[0])     # one session = one client a part
        for r in np.unique(row).tolist():
            idx = np.flatnonzero(row == r)
            key = (cid, r)
            fence = self._shed_fence.get(key)
            if fence is not None:
                if int(cseq[idx[0]]) > fence:
                    # the fenced cseq has not been resubmitted yet: the
                    # whole group is behind the gap — shed it all
                    # without offering (tokens stay for the fence's
                    # resubmit)
                    keep[idx] = False
                    shed_rows += [r] * idx.size
                    shed_cseqs += cseq[idx].tolist()
                    self._shed_high[key] = max(
                        self._shed_high.get(key, 0),
                        int(cseq[idx[-1]]))
                    retry_ms = max(retry_ms,
                                   adm.retry_after_ms(cid, idx.size))
                    continue
                # cseqs below the fence are stale duplicates of already
                # sequenced ops: keep them for the dedup ledger UNCHARGED
                # and offer only the fenced suffix (offering a duplicate
                # could admit it and clear the fence, letting a higher
                # live cseq skip the still-shed fenced op into a
                # clientSeq-gap nack)
                idx = idx[cseq[idx] >= fence]
                if idx.size == 0:
                    continue
            res = adm.admit(cid, int(idx.size))
            k = res.admitted
            if k < idx.size:
                self._shed_fence[key] = int(cseq[idx[k]])
                self._shed_high[key] = max(self._shed_high.get(key, 0),
                                           int(cseq[idx[-1]]))
                shed = idx[k:]
                keep[shed] = False
                shed_rows += row[shed].tolist()
                shed_cseqs += cseq[shed].tolist()
                retry_ms = max(retry_ms, res.retry_after_ms)
            elif fence is not None:
                # whole group admitted — but a retry wave may carry only
                # a PREFIX of the shed run; advance the fence past what
                # just landed until the run's high-water readmits, so a
                # racing live cseq cannot skip the parked rest
                last = int(cseq[idx[-1]])
                if last < self._shed_high.get(key, 0):
                    self._shed_fence[key] = last + 1
                else:
                    del self._shed_fence[key]
                    self._shed_high.pop(key, None)
        if shed_cseqs:
            self.throttled_ops += len(shed_cseqs)
            REGISTRY.inc("columnar_throttled_ops", len(shed_cseqs))
            sess._push_json({"t": "throttled", "rows": shed_rows,
                             "cseqs": shed_cseqs,
                             "retry_after_ms": round(
                                 max(retry_ms, 1.0), 3)})
            row, kind, a0, a1 = (x[keep] for x in (row, kind, a0, a1))
            gidx, cseq, ref, client = (x[keep] for x in
                                       (gidx, cseq, ref, client))
        return row, kind, a0, a1, gidx, cseq, ref, client

    def _doc_of_row(self, r: int):
        """Row index → doc id for the capacity census's coldest docs (a
        bound method, so the ledger's weak registration never pins the
        door)."""
        docs = self.engine._row_doc_id
        return docs[r] if 0 <= r < len(docs) else None

    def _note_hotdocs(self, row: np.ndarray, cid: int) -> None:
        """Feed the heavy-hitter sketch from one session's admitted
        planes: one ``offer`` per unique (doc, tenant) in the part, not
        per op. The same unique pass stamps the idle-age clock: one
        scatter."""
        if self.admission is not None:
            tenant = self.admission.tenant_of(cid)
        else:
            tenant = f"client-{cid}"
        docs = self.engine._row_doc_id
        u, counts = np.unique(row, return_counts=True)
        self.idle_ages.touch(u)
        for r, n in zip(u.tolist(), counts.tolist()):
            doc = docs[r] if r < len(docs) else None
            self.hotdocs.offer((doc if doc is not None else f"row-{r}",
                                tenant), n)

    def _build_windows(self) -> List[dict]:
        """Carve the pass's decoded backlog into unique-row windows:
        stable sort by row, split by per-row occurrence level (level k =
        every row's k-th pending op — per-doc FIFO is the sort's
        stability), chunk levels to ``window_min_rows``. Each window
        compacts its own text / props tables from the pass interner and
        captures its rows' doc ids for the ack ledger."""
        parts = self._parts
        if not parts:
            return []
        self._parts = []
        tab: List[_ColSession] = []
        idx_of: Dict[int, int] = {}
        sessi_parts = []
        for p in parts:
            s = p["sess"]
            i = idx_of.get(id(s))
            if i is None:
                i = idx_of[id(s)] = len(tab)
                tab.append(s)
            sessi_parts.append(np.full(p["row"].size, i, np.int32))
        if len(parts) == 1:
            f = {k: parts[0][k] for k in _PLANES}
            sessi = sessi_parts[0]
        else:
            f = {k: np.concatenate([p[k] for p in parts])
                 for k in _PLANES}
            sessi = np.concatenate(sessi_parts)
        row = f["row"]
        n = row.size
        order = np.argsort(row, kind="stable")
        srow = row[order]
        new = np.empty(n, bool)
        new[0] = True
        new[1:] = srow[1:] != srow[:-1]
        starts = np.flatnonzero(new)
        occ = np.arange(n) - np.repeat(starts,
                                       np.diff(np.append(starts, n)))
        lvl_order = np.argsort(occ, kind="stable")
        cuts = np.flatnonzero(np.diff(occ[lvl_order])) + 1
        chunks: List[np.ndarray] = []
        for lvl in np.split(order[lvl_order], cuts):
            for s in range(0, lvl.size, self.window_min_rows):
                chunks.append(lvl[s:s + self.window_min_rows])
        texts_g, props_g = self._texts, self._props
        doc_of = self.engine._row_doc_id
        windows = []
        for w in chunks:
            kind_w = f["kind"][w]
            gidx_w = f["gidx"][w]
            tidx_w = np.zeros(w.size, np.int32)
            ins = kind_w == _K_INS
            texts_w: List[str] = []
            if ins.any():
                u, inv = np.unique(gidx_w[ins], return_inverse=True)
                tidx_w[ins] = inv.astype(np.int32)
                texts_w = [texts_g[i] for i in u.tolist()]
            props_w: List[dict] = []
            ann = kind_w == _K_ANN
            if ann.any():
                u, inv = np.unique(gidx_w[ann], return_inverse=True)
                tidx_w[ann] = inv.astype(np.int32)
                props_w = [props_g[i] for i in u.tolist()]
            rows_w = row[w]
            windows.append({
                "rows": rows_w, "kind": kind_w.reshape(-1, 1),
                "a0": f["a0"][w].reshape(-1, 1),
                "a1": f["a1"][w].reshape(-1, 1),
                "tidx": tidx_w.reshape(-1, 1),
                "cseq": f["cseq"][w].reshape(-1, 1),
                "ref": f["ref"][w].reshape(-1, 1),
                "client": f["client"][w].reshape(-1, 1),
                "cseq_flat": f["cseq"][w], "sessi": sessi[w],
                "docs": [doc_of[r] for r in rows_w.tolist()],
                "texts": texts_w or [""], "props": props_w or None,
                "tab": tab, "tl": self._pass_tl})
        # the interners only feed this pass's windows, which now carry
        # their own compacted tables — reset so they stay bounded
        self._texts, self._text_of = [], {}
        self._props, self._prop_of = [], {}
        return windows

    def _submit_window(self, w: dict) -> None:
        n = int(w["rows"].size)
        if self._executor is not None:
            # pipelined: hand the window to the executor and return — the
            # NEXT window aggregates while this one packs / sequences /
            # dispatches; acks fan back from the done callback only after
            # the log append commits
            with tracing.TRACER.maybe_root_span(
                    "columnar.submit_window", every=256, ops=n):
                # sampled windows carry their trace context to the ack
                # fan: the e2e histogram's exemplar names a real trace
                w["ctx"] = tracing.TRACER.current()
                ticket = self._executor.submit(
                    w["rows"], w["client"], w["cseq"], w["ref"],
                    w["kind"], w["a0"], w["a1"], texts=w["texts"],
                    tidx=w["tidx"], props=w["props"])
            self._waves_inflight += 1
            loop = self._loop
            ticket.add_done_callback(
                lambda t: self._bounce_ack(loop, t, w))
        else:
            with tracing.TRACER.maybe_root_span(
                    "columnar.flush_window", every=256, ops=n):
                w["ctx"] = tracing.TRACER.current()
                res = self.engine.ingest_planes(
                    w["rows"], w["client"], w["cseq"], w["ref"],
                    w["kind"], w["a0"], w["a1"], texts=w["texts"],
                    tidx=w["tidx"], props=w["props"])
            self._fan_acks(w, np.asarray(res["seq"]).reshape(-1),
                           marks=res.get("marks"))
        self.windows_flushed += 1
        self.ops_ingested += n
        self._pending_ops -= n
        REGISTRY.inc("columnar_windows_flushed")
        REGISTRY.inc("columnar_ops_ingested", n)

    def _fan_acks(self, w: dict, seqs: np.ndarray,
                  marks: Optional[dict] = None) -> None:
        """Fan a window's acks back, one frame per participating session.

        Runs AFTER the log append (serial path: ingest_planes returned;
        pipelined path: the ticket resolved past the log stage), so the
        ack recorded in the engine's dedup ledger here vouches that the
        op is logged: a resubmit is re-acked with the original seq. The
        ledger takes the doc ids captured when the window was built (a
        recovery inside the wave may have released a row). The frame
        carries a parallel ``rows`` list so clients can attribute each
        ack to a doc."""
        rows, cseq = w["rows"], w["cseq_flat"]
        sessi, tab = w["sessi"], w["tab"]
        self.engine.note_acked_planes(w["docs"], w["client"], w["cseq"],
                                      seqs.reshape(-1, 1))
        order = np.argsort(sessi, kind="stable")
        ss = sessi[order]
        cuts = np.flatnonzero(np.diff(ss)) + 1
        for g in np.split(order, cuts):
            pairs = np.empty((g.size, 2), np.int64)
            pairs[:, 0] = cseq[g]
            pairs[:, 1] = seqs[g]
            tab[int(sessi[g[0]])]._push_json(
                {"t": "acks", "acks": pairs.tolist(),
                 "rows": rows[g].tolist()})
        # latency attribution: the ack fan completes the window's
        # timeline — attribute e2e to consecutive stage segments
        tl = w.get("tl")
        if tl is not None and marks:
            t_ack = time.perf_counter()
            ctx = w.get("ctx")
            for reg in (REGISTRY, self.metrics):
                observe_window_timeline(tl, marks, t_ack, registry=reg,
                                        exemplar=ctx)
            if ctx is not None:
                # the sampled window's trace gets its whole rx → ack span
                tracing.TRACER.record_complete(
                    "columnar.window_e2e", (t_ack - tl["t_rx"]) * 1e3,
                    parent=ctx, ops=int(rows.size))

    def _bounce_ack(self, loop, ticket, w: dict) -> None:
        """Ticket done-callback: runs on the executor's log worker —
        bounce onto the event loop (session queues are loop-affine)."""
        try:
            loop.call_soon_threadsafe(self._ack_wave, ticket, w)
        except RuntimeError:
            pass   # loop already closed (shutdown race): acks are moot

    def _ack_wave(self, ticket, w: dict) -> None:
        self._waves_inflight -= 1
        if self._capacity is not None:
            self._capacity.set()
        err = ticket.error()
        if err is not None:
            if self._pipeline_error is None:
                self._pipeline_error = err
            for i in np.unique(w["sessi"]).tolist():
                w["tab"][i]._push_json(
                    {"t": "error", "message": f"ingest failed: {err}"})
            if self._wake is not None:
                self._wake.set()
            return
        res = ticket.result()
        self._fan_acks(w, np.asarray(res["seq"]).reshape(-1),
                       marks=res.get("marks"))

    async def _wait_capacity(self) -> None:
        """Depth backpressure: park the flusher (the event loop stays
        free to accumulate more socket bytes) until an in-flight wave
        logs."""
        if self._executor is None:
            return
        while self._waves_inflight >= self._executor.depth \
                and self._pipeline_error is None:
            self._capacity.clear()
            await self._capacity.wait()

    async def _flusher(self) -> None:
        self._wake = asyncio.Event()
        self._capacity = asyncio.Event()
        while True:
            try:
                await asyncio.wait_for(self._wake.wait(),
                                       timeout=self.window_ms / 1000.0)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            try:
                if self._pipeline_error is not None:
                    raise RuntimeError("pipelined ingest failed"
                                       ) from self._pipeline_error
                self._drain()
                for w in self._build_windows():
                    await self._wait_capacity()
                    if self._pipeline_error is not None:
                        raise RuntimeError("pipelined ingest failed"
                                           ) from self._pipeline_error
                    self._submit_window(w)
            except Exception as e:   # poisoned engine / device fault:
                # surface to every connected session, then stop serving
                for sess in list(self._sessions):
                    sess._push_json({"t": "error",
                                     "message": f"ingest failed: {e}"})
                raise

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        if self.pipeline_depth > 0 and self._executor is None:
            self._executor = PipelinedIngestExecutor(
                self.engine, depth=self.pipeline_depth)
        self._server = await asyncio.start_server(
            self._accept, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._flush_task = self._loop.create_task(self._flusher())

    async def _accept(self, reader, writer) -> None:
        await _ColSession(self, reader, writer).run()

    def start_in_thread(self) -> "ColumnarAlfred":
        """Serve from an event loop on a thread of its own; returns once
        the socket listens (``self.port``)."""
        started = threading.Event()

        def _run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def _main():
                await self.start()
                started.set()
                async with self._server:
                    await self._server.serve_forever()

            loop = self._loop
            try:
                loop.run_until_complete(_main())
            except asyncio.CancelledError:
                pass
            finally:
                # let the cancelled sessions and flusher unwind, then
                # release the loop's sockets
                rest = asyncio.all_tasks(loop)
                if rest:
                    loop.run_until_complete(
                        asyncio.gather(*rest, return_exceptions=True))
                loop.close()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        if not started.wait(timeout=10):
            raise TimeoutError("columnar ingress failed to start")
        return self

    def stop(self) -> None:
        if self._executor is not None:
            # drain first: in-flight waves resolve and their acks fan
            # while the loop is still alive
            try:
                self._executor.close()
            except (RuntimeError, TimeoutError):
                pass
            self._executor = None
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(
                lambda: [t.cancel() for t in asyncio.all_tasks(loop)])
            if self._thread is not None:
                self._thread.join(timeout=5)

    def pipeline_stats(self) -> Optional[dict]:
        """The executor's occupancy and overlap (None when serial)."""
        return self._executor.stats() if self._executor is not None \
            else None

    def drain_stats(self) -> dict:
        """Decode-stage evidence: p50 drain pass latency, drained bytes
        per pass, pass count, decode tier."""
        ms = sorted(self._drain_ms)
        by = sorted(self._drain_bytes)
        return {
            "decode_p50_ms": round(ms[len(ms) // 2], 4) if ms else 0.0,
            "bytes_per_pass_p50": int(by[len(by) // 2]) if by else 0,
            "passes": self.drain_passes,
            "drained_bytes": self.drained_bytes,
            "tier": "native" if self._use_native else "numpy"}


def connect_with_backoff(host: str, port: int, attempts: int = 5,
                         base_delay: float = 0.05,
                         timeout: Optional[float] = None) -> socket.socket:
    """``socket.create_connection`` with BOUNDED jittered backoff: a
    server still binding refuses connections for a beat. After
    ``attempts`` failures the last error propagates. ``timeout`` bounds
    every later blocking call on the socket."""
    bo = Backoff(base=base_delay, cap=2.0,
                 metric="columnar_connect_backoffs")
    try:
        return retry(
            lambda: socket.create_connection((host, port),
                                             timeout=timeout),
            attempts=attempts, exceptions=(OSError,), backoff=bo)
    except OSError as e:
        raise ConnectionError(
            f"columnar ingress {host}:{port} unreachable after "
            f"{attempts} attempts") from e


class ColumnarClient:
    """Blocking-socket client for the columnar door. Reads go through a
    ``BufferedSocketReader``. ``timeout`` (seconds) bounds every blocking
    receive and send: a door that stops answering raises
    ``socket.timeout`` instead of hanging."""

    def __init__(self, host: str, port: int,
                 timeout: Optional[float] = None):
        self.sock = connect_with_backoff(host, port, timeout=timeout)
        self._rd = BufferedSocketReader(self.sock)
        self.client_id: Optional[int] = None
        self.rows: Dict[str, int] = {}
        self.lcs: Dict[str, int] = {}   # per-doc last accepted clientSeq

    def join(self, docs: List[str], client_id: Optional[int] = None,
             tenant: Optional[str] = None) -> Dict[str, int]:
        """Join (or, with ``client_id``, RESUME) the given docs, bound to
        ``tenant`` for admission. A resume keeps the server-side dedup
        cursor; the response's ``lcs`` map says where it stands."""
        req = {"t": "join", "docs": docs}
        if client_id is not None:
            req["client_id"] = client_id
        if tenant is not None:
            req["tenant"] = tenant
        self.sock.sendall(encode_json(req))
        resp = self.recv_json()
        assert resp["t"] == "joined", resp
        self.client_id = resp["client_id"]
        self.rows.update(resp["rows"])
        self.lcs = dict(resp.get("lcs", {}))
        return self.rows

    def send_ops(self, texts: List[str], ops: np.ndarray,
                 props: Optional[List[dict]] = None) -> None:
        self.sock.sendall(encode_op_batch(texts, ops, props=props))

    def recv_json(self) -> dict:
        ftype, payload = read_frame(self._rd)
        assert ftype == ord("J"), ftype
        return json.loads(payload)

    def close(self) -> None:
        try:
            self.sock.sendall(encode_json({"t": "bye"}))
        except OSError:
            pass
        self.sock.close()
