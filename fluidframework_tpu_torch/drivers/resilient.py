"""The reconnecting read-only client of the observer door.

Counterpart of ``fluidframework_tpu/drivers/resilient.py``'s
``ResilientObserver`` (the Fluid client's ``DeltaManager`` reconnect
pipeline, on the read side). The writer clients of that module are not
ported here.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..server import columnar_ingress as colwire
from ..server.read_plane import decode_tree_frame
from ..utils.backoff import Backoff
from ..utils.telemetry import REGISTRY

#: failed dials in a row before the client gives up
_ATTEMPTS = 8
#: seconds a dial may take
_DIAL_TIMEOUT_S = 10.0


class ResilientObserver:
    """Reconnecting read-only client of ``server.observer.ObserverDoor``.

    With no ops to resubmit, resilience means resuming the window stream
    without a gap or a duplicate. The client keeps the last applied
    window id and the last applied seq a doc; a reconnect (or a shed
    ``gap`` notice) re-enters with ``from_wid = last_wid + 1``, so the
    hub's ring replays exactly the missed windows. When the ring no
    longer reaches back (``catchup_needed``) the client counts it and
    rejoins at the live head.

    Window ids are published in order without holes, so ``wid <=
    last_wid`` is a duplicate window (skipped whole, ``window_dups``) and
    ``wid > last_wid + 1`` a gap (``gaps``); the per-doc seqs back that
    up op by op (``dups``, ``op_gaps``). A window counts as applied, and
    ``last_wid`` moves to it, only once its header's ``n_frames`` frames
    are in: a socket lost inside a window run (``torn_windows``)
    resubscribes from that window, and the ops of it already applied are
    dropped by their seqs on the replay without counting as duplicates.
    Frames decode through the door's ``parse_op_tables`` / ``read_frame``
    and the read plane's ``decode_tree_frame``."""

    def __init__(self, host: str, port: int, name: str = "",
                 rng=None, base_delay: float = 0.02,
                 on_op: Optional[Callable] = None):
        self.host = host
        self.port = port
        self.name = name or "resilient-observer"
        self.on_op = on_op
        self._backoff = Backoff(base=base_delay, cap=1.0, rng=rng,
                                metric="observer_reconnect_backoffs_total")
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self._sock: Optional[socket.socket] = None
        #: doc → last applied sequenced seq (the resume cursor)
        self.doc_seqs: Dict[str, int] = {}
        self.last_wid = 0
        #: the cursor is set (False until the first subscribe answers,
        #: and again after the ring fell behind it)
        self._joined = False
        self.windows_applied = 0
        self.ops_applied = 0
        self.window_dups = 0     # whole windows skipped (wid replayed)
        self.dups = 0            # per-op duplicates dropped
        self.gaps = 0            # window-id holes seen
        self.op_gaps = 0         # per-doc seq holes seen
        self.reconnects = 0
        self.sheds = 0           # shed notices received
        self.catchup_needed = 0  # times the ring could not reach the cursor
        self.torn_windows = 0    # sockets lost inside a window run
        self.gave_up = False
        #: state of the window run being read: its id, the frames still
        #: to come, whether it is a replayed duplicate; and the window a
        #: lost socket tore (its replayed ops are not duplicates)
        self._wid = 0
        self._frames_left = 0
        self._skip = False
        self._torn_wid = 0
        self._tear = False
        self._cops_docs: List[str] = []
        self._thread = threading.Thread(
            target=self._run, name=f"observer:{self.name}", daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- loop

    def _run(self) -> None:
        attempts_left = _ATTEMPTS
        first = True
        while not self._closed and attempts_left > 0:
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=_DIAL_TIMEOUT_S)
                sock.settimeout(None)
                self._sock = sock
                sub: Dict[str, Any] = {"t": "subscribe", "name": self.name}
                if self._joined:
                    # resume, not rehydrate: only the missed windows
                    sub["from_wid"] = self.last_wid + 1
                sock.sendall(colwire.encode_json(sub))
                if not first:
                    with self._lock:
                        self.reconnects += 1
                    REGISTRY.inc("observer_reconnects_total")
                first = False
                self._backoff.reset()
                attempts_left = _ATTEMPTS
                self._recv_loop(sock)
            except (OSError, ConnectionError, ValueError):
                pass
            with self._lock:
                if self._frames_left and not self._skip:
                    # lost inside a window run: the resubscribe replays
                    # it from its header
                    self.torn_windows += 1
                    self._torn_wid = self._wid
                self._frames_left = 0
                self._skip = False
            if self._closed:
                break
            attempts_left -= 1
            if attempts_left > 0:
                time.sleep(self._backoff.next_delay())
        if not self._closed:
            self.gave_up = True
        with self._cv:
            self._cv.notify_all()

    def _recv_loop(self, sock: socket.socket) -> None:
        while not self._closed:
            ftype, payload = colwire.read_frame(sock)
            self._on_frame(ftype, payload, sock)
            if self._tear and self._frames_left and not self._skip:
                # chaos: the connection drops here, inside a window run
                self._tear = False
                self.kill_socket()
                raise ConnectionError("torn inside a window")

    # ------------------------------------------------------------ decode

    def _on_frame(self, ftype: int, payload: bytes,
                  sock: socket.socket) -> None:
        if ftype == ord("J"):
            msg = json.loads(bytes(payload))
            if msg.get("t") != "rec":
                self._on_control(msg, sock)
                return
        if not self._frames_left:
            return           # no window run open: nothing to apply
        if not self._skip:
            if ftype == ord("J"):
                self._on_rec(msg)
            elif ftype in (ord("B"), ord("R")):
                self._on_op_frame(payload, rich=ftype == ord("R"))
            elif ftype == ord("T"):
                self._on_tree_frame(payload)
        self._frames_left -= 1
        if not self._frames_left:
            self._end_window()

    def _begin_window(self, wid: int, n_frames: int) -> None:
        with self._lock:
            self._wid = wid
            self._frames_left = n_frames
            self._skip = wid <= self.last_wid
            if self._skip:
                # replay overlap: skip the whole run, count the dup
                self.window_dups += 1
            elif self.last_wid and wid > self.last_wid + 1:
                self.gaps += 1
        if not n_frames:
            self._end_window()

    def _end_window(self) -> None:
        """Every frame of the run is in: the cursor moves to it."""
        with self._lock:
            if not self._skip:
                self.last_wid = self._wid
                self.windows_applied += 1
                if self._wid == self._torn_wid:
                    self._torn_wid = 0
            self._skip = False

    def _on_control(self, msg: dict, sock: socket.socket) -> None:
        t = msg.get("t")
        if t == "window":
            self._begin_window(int(msg["wid"]), int(msg["n_frames"]))
        elif t == "subscribed":
            with self._lock:
                if msg.get("catchup_needed"):
                    # the ring no longer reaches the cursor: the
                    # generation-diff rung owns the gap; the stream
                    # resumes at the live head
                    self.catchup_needed += 1
                if not self._joined:
                    self.last_wid = int(msg["next_wid"]) - 1
                    self._joined = True
        elif t == "gap":
            # shed by the byte budget: parked; ask for a ring replay
            # from the cursor on this socket
            with self._lock:
                self.sheds += 1
                from_wid = self.last_wid + 1
            sock.sendall(colwire.encode_json(
                {"t": "resume", "from_wid": from_wid}))
        elif t == "catchup_needed":
            # resume refused, the ring is too short: rejoin at the head
            with self._lock:
                self.catchup_needed += 1
                self.last_wid = 0
                self._joined = False
            raise ConnectionError("ring behind cursor")

    def _on_rec(self, msg: dict) -> None:
        if msg.get("fmt") == "cops":
            self._cops_docs = list(msg["docs"])
        elif msg.get("fmt") == "json":
            for doc, seq, client, contents in msg["ops"]:
                self._apply(doc, int(seq), int(client), contents)

    def _on_op_frame(self, payload: bytes, rich: bool) -> None:
        texts, props, off = colwire.parse_op_tables(payload, rich)
        recs = np.frombuffer(payload, colwire._OP_DTYPE, offset=off)
        docs = self._cops_docs
        cols = zip(*(recs[f].tolist() for f in
                     ("row", "kind", "a0", "a1", "tidx", "cseq", "ref")))
        for row, kind, a0, a1, tidx, seq, client in cols:
            op: Dict[str, Any] = {"kind": kind, "a0": a0, "a1": a1}
            if kind == 0 and texts:              # INSERT
                op["text"] = texts[tidx]
            elif kind == 2 and props:            # ANNOTATE
                op["props"] = props[tidx]
            self._apply(docs[row], seq, client, op)

    def _on_tree_frame(self, payload: bytes) -> None:
        header, rec_op, _recs = decode_tree_frame(payload)
        docs = header["docs"]
        for i, seq in enumerate(header["seq"]):
            self._apply(docs[int(header["doc"][i])], int(seq),
                        int(header["client"][i]),
                        {"tree_rec": int(rec_op[i])})

    def _apply(self, doc: str, seq: int, client: int, op: Any) -> None:
        with self._cv:
            last = self.doc_seqs.get(doc, 0)
            if seq <= last:
                if self._wid != self._torn_wid:
                    # the torn window's replay brings back the ops its
                    # first pass applied; any other such op is a dup
                    self.dups += 1
                return
            if last and seq > last + 1:
                self.op_gaps += 1
            self.doc_seqs[doc] = seq
            self.ops_applied += 1
            self._cv.notify_all()
        if self.on_op is not None:
            self.on_op(doc, seq, client, op)

    # ------------------------------------------------------------- waits

    def wait_ops(self, n: int, timeout: float = 30.0) -> bool:
        """Block until ``n`` distinct ops have been applied (False on
        timeout, close or give-up)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.ops_applied < n and not self._closed \
                    and not self.gave_up:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return self.ops_applied >= n

    # ------------------------------------------------------------- chaos

    def kill_socket(self) -> None:
        """Drop the connection mid-stream; the loop redials with jitter
        and resubscribes from ``last_wid + 1``."""
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()

    def tear_window(self) -> None:
        """Drop the connection inside the next window run, right after a
        frame with more of the run to come: the worst place for a socket
        to die. The loop redials and the ring replays the window whole."""
        self._tear = True

    def close(self) -> None:
        self._closed = True
        sock = self._sock
        try:
            sock.sendall(colwire.encode_json({"t": "close"}))
        except (OSError, AttributeError):
            pass
        if sock is not None:
            sock.close()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=5)
