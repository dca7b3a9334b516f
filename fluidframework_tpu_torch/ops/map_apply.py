"""ctypes binding of the fused map apply kernel (``csrc/map_apply.cu``).

The kernel replaces ``fluidframework_tpu/ops/map_kernel.py``'s
``apply_map_batch_jit`` (dense op planes) and ``map_columnar_apply_jit``
(the packed int32 wire); see the source for its design: a warp a row
when the state has at most ``warp_keys()`` key slots, a CTA a row past
that. It writes the state planes IN PLACE. ``launch_dense`` and ``launch_packed`` take CUDA
tensors only, check device, dtype, shape and contiguity, launch on the
current stream and raise when the launch is refused. The device dispatch
(plain version on the CPU) lives in ``map_kernel``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

#: kernel launches made through this module (callers reset it)
launches = 0

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("map_apply")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.map_apply_dense.restype = i32
            lib.map_apply_dense.argtypes = [vp] * 7 + [i32] * 3 + [vp]
            lib.map_apply_packed.restype = i32
            lib.map_apply_packed.argtypes = [vp, i32, i32, i32, vp, vp, vp,
                                             i32, i32, vp]
            lib.map_apply_warp_keys.restype = i32
            lib.map_apply_warp_keys.argtypes = []
            lib.map_apply_error_string.restype = ctypes.c_char_p
            lib.map_apply_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def warp_keys() -> int:
    """The most key slots K a state may have for the kernel to run a row
    on one warp (a CTA a row past it), read from the built library."""
    return _load().map_apply_warp_keys()


def _check(state, tensors) -> None:
    dev = state.present.device
    if dev.type != "cuda":
        raise ValueError(f"the map_apply kernel runs on CUDA tensors, got "
                         f"{dev}")
    D, K = state.present.shape
    for name, t in list(state.fields().items()) + list(tensors.items()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, state on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in state.fields().items():
        if t.shape != (D, K):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(D, K)}")


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError("map_apply launch failed: "
                           + _load().map_apply_error_string(err).decode())


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch_dense(state, kind, a0, a1, seq) -> None:
    """Apply dense (D, O) int32 op planes to ``state`` (a ``MapState``)."""
    global launches
    planes = {"kind": kind, "a0": a0, "a1": a1, "seq": seq}
    _check(state, planes)
    D, K = state.present.shape
    O = kind.shape[1] if kind.dim() == 2 else -1
    for name, t in planes.items():
        if t.shape != (D, O):
            raise ValueError(f"op plane {name} shape {tuple(t.shape)} != "
                             f"{(D, O)}")
    if D == 0 or O == 0:
        return
    lib = _load()
    with torch.cuda.device(kind.device):   # the library's device
        _raise_on(lib.map_apply_dense(
            *(_ptr(t) for t in planes.values()),
            *(_ptr(t) for t in state.fields().values()), D, O, K,
            _stream(kind)))
    launches += 1


def packed_words(R: int, O: int, wide_vals: bool) -> int:
    """int32 words of a packed batch of R rows × O ops."""
    n = R * O
    return 2 * (-(-n // 4)) + (n if wide_vals else -(-n // 2)) + 2 * R


def launch_packed(state, buf, R: int, O: int, wide_vals: bool) -> None:
    """Apply one packed columnar batch (see ``map_kernel.map_unpack``) to
    ``state``: plane row i lands on state row ``rows[i]`` (the buffer's
    row ids, which must be unique)."""
    global launches
    _check(state, {"buf": buf})
    if buf.shape != (packed_words(R, O, wide_vals),):
        raise ValueError(f"buffer of {tuple(buf.shape)} words, a batch of "
                         f"R={R}, O={O} needs "
                         f"{packed_words(R, O, wide_vals)}")
    if R == 0 or O == 0:
        return
    D, K = state.present.shape
    lib = _load()
    with torch.cuda.device(buf.device):   # the library's device
        _raise_on(lib.map_apply_packed(
            _ptr(buf), R, O, int(wide_vals),
            *(_ptr(t) for t in state.fields().values()), D, K,
            _stream(buf)))
    launches += 1
