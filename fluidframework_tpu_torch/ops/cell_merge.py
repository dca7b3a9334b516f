"""ctypes binding of the cell-table merge kernel (``csrc/cell_merge.cu``).

The kernel replaces ``fluidframework_tpu/ops/matrix_kernel.py``'s
``apply_cells_prefix_jit`` (prefix mode) and ``apply_cells_batch_jit``
(full mode); see the source for its design. It writes the table, count
and overflow IN PLACE. ``launch`` takes CUDA tensors only, checks device,
dtype, shape and contiguity, allocates the kernel's scratch, launches on
the current stream and raises when a launch is refused. The device
dispatch (plain version on the CPU) lives in ``matrix_kernel``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import cuda_build

#: merges launched through this module (callers reset it)
launches = 0

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("cell_merge")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.cell_merge_scratch_words.restype = ctypes.c_longlong
            lib.cell_merge_scratch_words.argtypes = [i32, i32]
            lib.cell_merge_launch.restype = i32
            lib.cell_merge_launch.argtypes = ([vp] * 5 + [i32, i32]
                                              + [vp] * 3 + [i32] * 3
                                              + [vp, vp])
            lib.cell_merge_error_string.restype = ctypes.c_char_p
            lib.cell_merge_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def launch(state, key, seq, value, L: Optional[int], fww: bool) -> None:
    """Merge the (O,) int32 batch into ``state`` (a ``MatrixCellState``):
    prefix mode on ``table[0, L)``, or full mode when ``L`` is None."""
    global launches
    dev = state.key.device
    if dev.type != "cuda":
        raise ValueError(f"the cell_merge kernel runs on CUDA tensors, got "
                         f"{dev}")
    T = state.key.shape[0]
    O = key.shape[0] if key.dim() == 1 else -1
    named = list(state.fields().items()) + [("op key", key),
                                            ("op seq", seq),
                                            ("op value", value)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, state on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, shape in (("key", state.key, (T,)), ("seq", state.seq, (T,)),
                           ("value", state.value, (T,)),
                           ("count", state.count, ()),
                           ("overflow", state.overflow, ()),
                           ("op key", key, (O,)), ("op seq", seq, (O,)),
                           ("op value", value, (O,))):
        if t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    Lt = T if L is None else int(L)
    if not 0 < Lt <= T:
        raise ValueError(f"prefix L={L} outside (0, {T}]")
    lib = _load()
    # freed when this returns, possibly before the kernels ran: the
    # caching allocator hands the block only to later work on this stream
    scratch = torch.empty(lib.cell_merge_scratch_words(Lt, O),
                          dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.cell_merge_launch(
        *(ptr(t) for t in state.fields().values()), T, Lt, ptr(key),
        ptr(seq), ptr(value), O, int(L is None), int(bool(fww)),
        ptr(scratch),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError("cell_merge launch failed: "
                           + lib.cell_merge_error_string(err).decode())
    launches += 1
