"""ctypes binding of the columnar front door's native frame decode
(``native/ingress.cpp``): the frame scan with its CRC check, and the
gather of 16-byte op records into int32 planes.

The library is built with ``g++`` into the package's git-ignored build
directory at first use (``native/build.py``). A failed build, or a
library without the expected symbols, raises: the door's default decode
is this one and never falls back. The numpy tier
(``columnar_ingress._py_split_frames`` and its record view) serves only a
door built with ``decode="numpy"``.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..native.build import ensure_built
from .wire import MAX_FRAME

_lib = None

#: defensive bound on one frame's payload
MAX_PAYLOAD = MAX_FRAME

#: scan stop reasons beyond a clean split (status 1 / 2)
SCAN_BAD_CRC = 1
SCAN_TOO_LARGE = 2

#: the planes ``gather`` fills, in the C function's argument order
PLANES = ("row", "kind", "a0", "a1", "tidx", "cseq", "ref")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def load():
    """The loaded library; builds it at first use. Raises on a failed
    build or load."""
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built("libingress.so")
    try:
        lib = ctypes.CDLL(path)
        lib.ingress_scan.restype = None
        lib.ingress_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, _I64P, _I64P, _I32P]
        lib.ingress_gather.restype = None
        lib.ingress_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p] + [ctypes.c_void_p] * len(PLANES)
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    _lib = lib
    return lib


def scan(buf) -> Tuple[List[Tuple[int, int, int]], int, int]:
    """Split ``buf`` (bytes-like) into complete CRC-valid frames.

    Returns ``(frames, consumed, status)``: ``frames`` is a list of
    ``(ftype, payload_off, payload_len)`` triples, ``consumed`` the bytes
    they cover (a trailing partial frame stays unconsumed), ``status``
    0 = clean / SCAN_BAD_CRC / SCAN_TOO_LARGE — on a non-zero status the
    scan stopped AT the poisoned frame; the good prefix is still
    returned. The contract is ``columnar_ingress.split_frames``'s."""
    lib = load()
    arr = np.frombuffer(buf, np.uint8)
    n = arr.size
    cap = n // 9 + 1  # min frame = 5B header + 4B crc
    ftype = np.empty(cap, np.uint8)
    poff = np.empty(cap, np.int64)
    plen = np.empty(cap, np.int64)
    n_frames = ctypes.c_int64()
    consumed = ctypes.c_int64()
    status = ctypes.c_int32()
    lib.ingress_scan(
        arr.ctypes.data_as(ctypes.c_void_p), n, MAX_PAYLOAD, cap,
        ftype.ctypes.data_as(ctypes.c_void_p),
        poff.ctypes.data_as(ctypes.c_void_p),
        plen.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(n_frames), ctypes.byref(consumed),
        ctypes.byref(status))
    k = n_frames.value
    frames = list(zip(ftype[:k].tolist(), poff[:k].tolist(),
                      plen[:k].tolist()))
    return frames, consumed.value, status.value


def gather(buf, runs: List[Tuple[int, int]]) -> dict:
    """Gather op records from ``runs`` (``(byte_off, record_count)`` per
    op frame, in frame order) into seven contiguous int32 planes, keyed
    by :data:`PLANES`."""
    lib = load()
    arr = np.frombuffer(buf, np.uint8)
    roff = np.array([r[0] for r in runs], np.int64)
    rcnt = np.array([r[1] for r in runs], np.int64)
    total = int(rcnt.sum()) if runs else 0
    planes = {name: np.empty(total, np.int32) for name in PLANES}
    if total:
        lib.ingress_gather(
            arr.ctypes.data_as(ctypes.c_void_p), len(runs),
            roff.ctypes.data_as(ctypes.c_void_p),
            rcnt.ctypes.data_as(ctypes.c_void_p),
            *[planes[k].ctypes.data_as(ctypes.c_void_p) for k in PLANES])
    return planes
