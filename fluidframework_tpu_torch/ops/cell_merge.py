"""ctypes binding of the cell-table merge kernel (``csrc/cell_merge.cu``).

The kernel replaces ``fluidframework_tpu/ops/matrix_kernel.py``'s
``apply_cells_prefix_jit`` (prefix mode) and ``apply_cells_batch_jit``
(full mode); see the source for its design. It writes the table, count
and overflow IN PLACE. ``launch`` takes CUDA tensors only, checks device,
dtype, shape and contiguity, takes the kernel's scratch from a buffer
cached per (device, stream) (grown when a merge needs more; a fresh
``torch.empty`` while a CUDA graph is being captured), launches on the
current stream and raises when a launch is refused. The device dispatch
(plain version on the CPU) lives in ``matrix_kernel``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import cuda_build

#: merges launched through this module (callers reset it)
launches = 0

#: batch elements one CTA sorts, merged positions a CTA merges
#: (``kSortTile`` / ``kTile`` of the source)
SORT_TILE = 4096
TILE = 2048


def tiles(Lt: int, O: int) -> int:
    """CTAs of the merge and finish launches: one per TILE merged
    positions of table[0, Lt) and the batch, at most."""
    return -(-(Lt + O) // TILE)


def scratch_words(Lt: int, O: int) -> int:
    """int32 words of scratch one merge needs (``cell_merge_scratch_words``
    of the source): 4 a tile (look-back state and record), 4 meta words,
    the sorted batch (twice when O takes merge passes) and three output
    planes of Lt."""
    return 4 * tiles(Lt, O) + 4 + (6 if O > SORT_TILE else 3) * O + 3 * Lt


_lib = None
_lock = threading.Lock()
_scratch: dict = {}   # (device index, stream handle) → int32 buffer


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("cell_merge")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.cell_merge_scratch_words.restype = ctypes.c_longlong
            lib.cell_merge_scratch_words.argtypes = [i32, i32]
            lib.cell_merge_tiles.restype = ctypes.c_longlong
            lib.cell_merge_tiles.argtypes = [i32, i32]
            lib.cell_merge_launch.restype = i32
            lib.cell_merge_launch.argtypes = ([vp] * 5 + [i32, i32]
                                              + [vp] * 3 + [i32] * 3
                                              + [vp, ctypes.c_longlong, vp])
            lib.cell_merge_error_string.restype = ctypes.c_char_p
            lib.cell_merge_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def _scratch_buffer(dev, stream: int, words: int) -> torch.Tensor:
    """The merge's scratch: a buffer kept per (device, stream) and grown
    when too small; kernels on one stream run in order, so consecutive
    merges share it. While a CUDA graph is being captured, a fresh block of
    the graph's pool instead (freed when this returns: the caching
    allocator hands it only to later work on this stream)."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(words, dtype=torch.int32, device=dev)
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = _scratch[key] = torch.empty(words, dtype=torch.int32,
                                          device=dev)
    return buf


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
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = scratch_words(Lt, O)
    scratch = _scratch_buffer(dev, stream, words)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    # the library acts on the current device: make it the state's
    with torch.cuda.device(dev):
        err = lib.cell_merge_launch(
            *(ptr(t) for t in state.fields().values()), T, Lt, ptr(key),
            ptr(seq), ptr(value), O, int(L is None), int(bool(fww)),
            ptr(scratch), scratch.numel(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("cell_merge launch failed: "
                           + lib.cell_merge_error_string(err).decode())
    launches += 1
