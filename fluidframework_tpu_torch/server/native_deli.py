"""ctypes binding for the native C++ Deli sequencer (``native/sequencer.cpp``).

Same policies as ``server.deli.DeliSequencer``, plus the columnar batch
entry point the ingest hot path uses. The library is built at first use;
when it cannot be built, constructing a sequencer raises (there is no
silent fall-back to the Python sequencer).
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional, Tuple

import numpy as np

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..native.build import ensure_built
from .deli import Nack, NackReason

_NACK_BY_CODE = {
    -1: NackReason.UNKNOWN_CLIENT,
    -2: NackReason.CLIENT_SEQ_GAP,
    -3: NackReason.DUPLICATE,
    -4: NackReason.REF_SEQ_BELOW_MSN,
}

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(ensure_built("libdeli.so"))
        vp, cp, i32, i64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                            ctypes.c_int64)
        p32, p64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(i64)
        lib.deli_create.restype = vp
        lib.deli_create.argtypes = []
        lib.deli_destroy.restype = None
        lib.deli_destroy.argtypes = [vp]
        lib.deli_client_join.restype = i64
        lib.deli_client_join.argtypes = [vp, cp, i32]
        lib.deli_client_leave.restype = i64
        lib.deli_client_leave.argtypes = [vp, cp, i32]
        lib.deli_sequence.restype = i64
        lib.deli_sequence.argtypes = [vp, cp, i32, i32, i32, i32, p64]
        lib.deli_doc_handle.restype = i32
        lib.deli_doc_handle.argtypes = [vp, cp]
        lib.deli_sequence_batch_rows.restype = None
        lib.deli_sequence_batch_rows.argtypes = [vp, i32, p32, p32, p32, p32,
                                                 p32, p64, p64]
        lib.deli_doc_seq.restype = i64
        lib.deli_doc_seq.argtypes = [vp, cp]
        lib.deli_doc_min_seq.restype = i64
        lib.deli_doc_min_seq.argtypes = [vp, cp]
        lib.deli_replay.restype = None
        lib.deli_replay.argtypes = [vp, cp, i32, i32, i32, i64, i64, i32]
        lib.deli_checkpoint.restype = i64
        lib.deli_checkpoint.argtypes = [vp, cp, i64]
        lib.deli_restore.restype = vp
        lib.deli_restore.argtypes = [cp, i64]
        _lib = lib
        return lib


class NativeDeli:
    """C++ sequencer handle. The C++ state is not internally synchronised;
    one Python-side lock serialises every native call (the pipelined
    executor sequences on its own worker thread)."""

    def __init__(self, _handle=None):
        self._lib = _load()
        self._lock = threading.Lock()
        self._h = _handle if _handle is not None else self._lib.deli_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.deli_destroy(self._h)
            self._h = None

    def client_join(self, doc_id: str, client: int) -> int:
        with self._lock:
            return self._lib.deli_client_join(self._h, doc_id.encode(),
                                              client)

    def client_leave(self, doc_id: str, client: int) -> int:
        with self._lock:
            return self._lib.deli_client_leave(self._h, doc_id.encode(),
                                               client)

    def sequence(self, doc_id: str, client: int, client_seq: int,
                 ref_seq: int, is_noop: bool = False
                 ) -> Tuple[Optional[int], Optional[int],
                            Optional[NackReason]]:
        """(seq, min_seq, None) on success, (None, None, reason) on nack."""
        out_min = ctypes.c_int64()
        with self._lock:
            seq = self._lib.deli_sequence(
                self._h, doc_id.encode(), client, client_seq, ref_seq,
                int(is_noop), ctypes.byref(out_min))
        if seq < 0:
            return None, None, _NACK_BY_CODE[int(seq)]
        return int(seq), int(out_min.value), None

    def doc_handle(self, doc_id: str) -> int:
        """Dense row handle for the columnar batch call."""
        with self._lock:
            return int(self._lib.deli_doc_handle(self._h, doc_id.encode()))

    def sequence_batch_rows(self, handles, clients, client_seqs, ref_seqs,
                            is_noop=None):
        """Columnar multi-doc stamping: one C call for the whole batch.
        Returns (seqs, min_seqs) int64 arrays; negative seq = nack code."""
        handles = np.ascontiguousarray(handles, np.int32)
        clients = np.ascontiguousarray(clients, np.int32)
        client_seqs = np.ascontiguousarray(client_seqs, np.int32)
        ref_seqs = np.ascontiguousarray(ref_seqs, np.int32)
        n = len(handles)
        if is_noop is None:
            is_noop = np.zeros(n, np.int32)
        is_noop = np.ascontiguousarray(is_noop, np.int32)
        out_seq = np.empty(n, np.int64)
        out_min = np.empty(n, np.int64)
        p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        with self._lock:
            self._lib.deli_sequence_batch_rows(
                self._h, n, p(handles, ctypes.c_int32),
                p(clients, ctypes.c_int32), p(client_seqs, ctypes.c_int32),
                p(ref_seqs, ctypes.c_int32), p(is_noop, ctypes.c_int32),
                p(out_seq, ctypes.c_int64), p(out_min, ctypes.c_int64))
        return out_seq, out_min

    def doc_seq(self, doc_id: str) -> int:
        with self._lock:
            return int(self._lib.deli_doc_seq(self._h, doc_id.encode()))

    def doc_min_seq(self, doc_id: str) -> int:
        with self._lock:
            return int(self._lib.deli_doc_min_seq(self._h,
                                                  doc_id.encode()))

    def replay(self, doc_id: str, client: int, client_seq: int,
               ref_seq: int, seq: int, min_seq: int, type_: int) -> None:
        """Fold an already-sequenced message into the state (tail replay)."""
        with self._lock:
            self._lib.deli_replay(self._h, doc_id.encode(), client,
                                  client_seq, ref_seq, seq, min_seq, type_)

    def checkpoint(self) -> bytes:
        """The state as the C library's text blob (one line per doc)."""
        with self._lock:
            n = self._lib.deli_checkpoint(self._h, None, 0)
            buf = ctypes.create_string_buffer(int(n))
            self._lib.deli_checkpoint(self._h, buf, n)
        return buf.raw[:n]

    @classmethod
    def restore(cls, blob: bytes) -> "NativeDeli":
        """A new sequencer holding a ``checkpoint`` blob's state. Row
        handles do not survive: re-register docs with ``doc_handle``."""
        lib = _load()
        return cls(_handle=lib.deli_restore(blob, len(blob)))


class NativeDeliAdapter:
    """The C++ sequencer behind the Python ``DeliSequencer`` surface, so an
    engine can swap it in wholesale (``sequencer="native"``); the columnar
    ingest path uses ``raw`` against the same state.

    Checkpoints are the native text blob wrapped as ``{"native": <latin1
    str>}`` (the JAX package's format); ``serving.restore_sequencer``
    dispatches on that key."""

    def __init__(self, clock=None, _native: Optional[NativeDeli] = None):
        self.raw = _native if _native is not None else NativeDeli()
        self.clock = clock if clock is not None else time.time
        # writer epoch, as on DeliSequencer (not part of checkpoint())
        self.epoch = 0

    def client_join(self, doc_id: str, client_id: int):
        seq = self.raw.client_join(doc_id, client_id)
        return SequencedDocumentMessage(
            doc_id=doc_id, client_id=client_id, client_seq=0,
            ref_seq=seq - 1, seq=seq,
            min_seq=self.raw.doc_min_seq(doc_id),
            type=MessageType.CLIENT_JOIN, contents={"clientId": client_id})

    def client_leave(self, doc_id: str, client_id: int):
        seq = self.raw.client_leave(doc_id, client_id)
        if seq == 0:
            return None
        return SequencedDocumentMessage(
            doc_id=doc_id, client_id=client_id, client_seq=0, ref_seq=seq,
            seq=seq, min_seq=self.raw.doc_min_seq(doc_id),
            type=MessageType.CLIENT_LEAVE, contents={"clientId": client_id})

    def sequence(self, doc_id: str, client_id: int, client_seq: int,
                 ref_seq: int, type, contents, address=None):
        seq, min_seq, reason = self.raw.sequence(
            doc_id, client_id, client_seq, ref_seq,
            is_noop=(type == MessageType.NOOP))
        if reason is not None:
            return None, Nack(doc_id, client_id, client_seq, reason)
        # mirror the C++ clamp: the message carries what was recorded
        msg = SequencedDocumentMessage(
            doc_id=doc_id, client_id=client_id, client_seq=client_seq,
            ref_seq=min(ref_seq, seq - 1), seq=seq, min_seq=min_seq,
            type=type, contents=contents, address=address,
            timestamp=self.clock())
        return msg, None

    def doc_seq(self, doc_id: str) -> int:
        return self.raw.doc_seq(doc_id)

    def replay(self, msg) -> None:
        self.raw.replay(msg.doc_id, msg.client_id, msg.client_seq,
                        msg.ref_seq, msg.seq, msg.min_seq, int(msg.type))

    def checkpoint(self) -> dict:
        return {"native": self.raw.checkpoint().decode("latin1")}

    @classmethod
    def restore(cls, snapshot: dict, clock=None) -> "NativeDeliAdapter":
        return cls(clock=clock, _native=NativeDeli.restore(
            snapshot["native"].encode("latin1")))
