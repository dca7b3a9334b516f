"""ctypes binding of the permutation-axis kernels (``csrc/axis_apply.cu``).

K3 ``launch_apply`` replaces ``fluidframework_tpu/ops/axis_kernel.py``'s
``apply_axis_batch`` (the serial axis scan with RESOLVE outputs); it
updates the state planes, count and overflow IN PLACE and writes the two
(D, O) output planes. K4 ``launch_resolve`` replaces
``resolve_axis_positions`` (a mutation-free resolve of a whole window);
it reads the state and writes the outputs, -1 where the kind is not
AXIS_RESOLVE. See the source for their design. Both take CUDA tensors
only, check device, dtype, shape and contiguity, launch on the current
stream and raise when a launch is refused. The device dispatch (plain
versions on the CPU) lives in ``axis_kernel``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

#: K3 / K4 launches made through this module (callers reset them)
apply_launches = 0
resolve_launches = 0

_STATE_PLANES = ("seq", "client", "removed_seq", "removers", "length",
                 "handle_op", "handle_off")

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("axis_apply")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.axis_apply_launch.restype = i32
            lib.axis_apply_launch.argtypes = [vp] * 18 + [i32] * 3 + [vp]
            lib.axis_resolve_launch.restype = i32
            lib.axis_resolve_launch.argtypes = [vp] * 14 + [i32] * 3 + [vp]
            lib.axis_max_slots.restype = i32
            lib.axis_max_slots.argtypes = []
            lib.axis_error_string.restype = ctypes.c_char_p
            lib.axis_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def max_slots() -> int:
    """The largest axis capacity S the kernels take (the row's seven
    planes in shared memory): ``kMaxS`` of the source, read from the
    built library."""
    return _load().axis_max_slots()


def check_capacity(S: int) -> None:
    """Raise ValueError unless the kernels take an axis capacity of S."""
    if not 1 <= S <= max_slots():
        raise ValueError(f"axis capacity S={S}: the axis kernels take 1 to "
                         f"{max_slots()} slots (seven planes of a row in "
                         "shared memory)")


def _check(state, named: dict, O: int) -> None:
    dev = state.seq.device
    if dev.type != "cuda":
        raise ValueError(f"the axis kernels run on CUDA tensors, got {dev}")
    D, S = state.seq.shape
    check_capacity(S)
    tensors = [(k, getattr(state, k)) for k in _STATE_PLANES + (
        "count", "overflow")] + list(named.items())
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, state on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for k in _STATE_PLANES:
        if getattr(state, k).shape != (D, S):
            raise ValueError(f"{k} shape {tuple(getattr(state, k).shape)} "
                             f"!= {(D, S)}")
    for k in ("count", "overflow"):
        if getattr(state, k).shape != (D,):
            raise ValueError(f"{k} must be ({D},)")
    for name, t in named.items():
        if t.shape != (D, O):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(D, O)}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _load().axis_error_string(err).decode())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch_apply(state, ops, out_run, out_off) -> None:
    """K3: apply the (D, O) int32 op planes ``ops`` (kind, a0, a1, a2, seq,
    client, ref_seq) to ``state`` (a ``StringState`` of axis rows) in
    place; the RESOLVE outputs land in ``out_run`` / ``out_off``."""
    global apply_launches
    O = ops[0].shape[1] if ops[0].dim() == 2 else -1
    names = ("kind", "a0", "a1", "a2", "seq", "client", "ref_seq")
    _check(state, {**{f"op {n}": t for n, t in zip(names, ops)},
                   "out_run": out_run, "out_off": out_off}, O)
    D, S = state.seq.shape
    if D == 0 or O == 0:
        return
    with torch.cuda.device(out_run.device):   # the library's device
        _raise_on(_load().axis_apply_launch(
            *(_ptr(t) for t in ops),
            *(_ptr(getattr(state, k)) for k in _STATE_PLANES),
            _ptr(state.count), _ptr(state.overflow), _ptr(out_run),
            _ptr(out_off), D, S, O, _stream(out_run)), "axis_apply")
    apply_launches += 1


def launch_resolve(state, kind, pos, client, ref_seq, out_run,
                   out_off) -> None:
    """K4: resolve every AXIS_RESOLVE slot of the (D, O) window against
    ``state`` at its own (ref_seq, client); other slots get -1."""
    global resolve_launches
    O = kind.shape[1] if kind.dim() == 2 else -1
    _check(state, {"kind": kind, "pos": pos, "client": client,
                   "ref_seq": ref_seq, "out_run": out_run,
                   "out_off": out_off}, O)
    D, S = state.seq.shape
    if D == 0 or O == 0:
        return
    with torch.cuda.device(out_run.device):   # the library's device
        _raise_on(_load().axis_resolve_launch(
            _ptr(kind), _ptr(pos), _ptr(client), _ptr(ref_seq),
            *(_ptr(getattr(state, k)) for k in _STATE_PLANES),
            _ptr(state.count), _ptr(out_run), _ptr(out_off), D, S, O,
            _stream(out_run)), "axis_resolve")
    resolve_launches += 1
