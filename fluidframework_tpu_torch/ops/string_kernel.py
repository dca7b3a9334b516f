"""Fused merge-tree apply (+ zamboni) as a hand-written Hopper kernel.

Replaces ``fluidframework_tpu/ops/pallas_string_kernel.py::
apply_string_batch_pallas`` (``pl.pallas_call`` at line 208): for each doc
apply O sequenced merge-tree ops in column order, optionally followed by a
stable drop of tombstones with ``removed_seq <= min_seq``. Source:
``fluidframework_tpu_torch/csrc/string_apply.cu``, compiled by ``nvcc`` for
``sm_90a`` into a plain-C shared library (``cuda_build``) and bound with
ctypes.

What bounds it on the card. Bytes would: the state planes read and
written once and the op planes read once — 2·(7+K)·D·S·4 + 7·D·O·4 bytes,
≈ 0.09 ms at D=10,240, S=512, O=64 at the H100's 3.35 TB/s. But the O ops
of a doc are a serial chain (each resolves its position against the
prefix the previous op left), so the kernel is bound by the latency of
the per-op block collectives and by the instructions per slot per op.

What the design does about it. It spends instructions only on live
slots, keeps each per-op collective to a few warp instructions and keeps
enough docs in flight per SM. One CTA per doc; warp w owns G groups of 32
slots, lane l of group g holding slot w·32·G + 32·g + l of every plane, in
registers for the whole op loop (the property planes in shared memory from
S > 512 or K > 8, every plane above S = 2048; the collectives' scratch too,
so the 48 KB opt-in sees every byte). Groups outside the live extent
``hi`` (``count``, or the last non-fill slot, raised by each shift) are
skipped, and warps past ``hi + 2·O`` leave after the load: a fill tail
shifted right stays fill and the roll's wrapped slot is always the new
slot, so the bound is exact under the full-plane roll contract. Scans are
warp shuffles per live group, reductions one ``redux.sync`` per field, the
shift by 1 or 2 two shuffles per live group and plane; each collective
costs one barrier (2 per insert, 3 per remove or annotate: a split shifts
the prefix and visibility arrays with the planes instead of rescanning).
Compaction writes kept slots straight to device memory.

On CPU tensors the wrapper runs the plain composition
(``merge_tree.apply_string_batch`` then ``compact_string_state``); on CUDA
tensors it launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional

import torch

from . import cuda_build, merge_tree
from .merge_tree import PLANES, StringState

#: kernel launches made by ``apply_string_batch_fused`` (callers reset it)
launches = 0
#: the same launches by shape: (D, S, O, K, compact) → count
shapes: collections.Counter = collections.Counter()

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
MAX_S = 8192        # the largest capacity the kernel takes (kMaxS)

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("string_apply")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.string_apply_launch.restype = i32
            lib.string_apply_launch.argtypes = (
                [vp] * 7        # op planes
                + [vp] * 7      # state planes
                + [vp, vp, vp, vp]  # prop_val, count, overflow, min_seq
                + [i32] * 4     # D, S, O, K
                + [vp])         # stream
            lib.string_apply_smem_bytes.restype = ctypes.c_longlong
            lib.string_apply_smem_bytes.argtypes = [i32] * 4
            lib.string_apply_shape.restype = i32
            lib.string_apply_shape.argtypes = [i32, i32, ctypes.POINTER(i32),
                                               ctypes.POINTER(i32)]
            lib.string_apply_error_string.restype = ctypes.c_char_p
            lib.string_apply_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def launch_shape(S: int, K: int = 0) -> dict:
    """The kernel's launch shape for capacity S and K property planes
    (0: the no-props specialisation); builds the kernel. ``{"threads": per
    CTA, "docs_per_cta": 1, "slots_per_lane": groups of 32 slots per
    warp}``."""
    lib = _load()
    g, threads = ctypes.c_int(), ctypes.c_int()
    if lib.string_apply_shape(S, K, ctypes.byref(g), ctypes.byref(threads)):
        raise ValueError(f"the kernel does not take capacity {S}, K={K}")
    return {"threads": threads.value, "docs_per_cta": 1,
            "slots_per_lane": g.value}


def max_ops(S: int, K: int = 0) -> Optional[int]:
    """The widest op batch (O) one launch takes at capacity S with K
    property planes, from the kernel's own shared-memory size
    (``string_apply_smem_bytes``, linear in O: the register tier stages
    the 7 op fields of every op); None when O does not count (the shared
    tier stages none). Builds the kernel."""
    lib = _load()
    base = lib.string_apply_smem_bytes(1, S, 0, K)
    per_op = lib.string_apply_smem_bytes(1, S, 1, K) - base
    if per_op <= 0:
        return None
    return max((MAX_SMEM - base) // per_op, 0)


def takes_capacity(S: int, K: int = 0) -> bool:
    """Whether the kernel launches on a state of capacity S with K
    property planes (S <= MAX_S and the doc's shared memory fits)."""
    lib = _load()
    g, threads = ctypes.c_int(), ctypes.c_int()
    if lib.string_apply_shape(S, K, ctypes.byref(g), ctypes.byref(threads)):
        return False
    return lib.string_apply_smem_bytes(1, S, 1, K) <= MAX_SMEM


def _check(state: StringState, ops, min_seq):
    D, S = state.seq.shape
    dev = state.seq.device
    tensors = list(state.fields().items()) + \
        [(f"op {n}", t) for n, t in zip(merge_tree.OP_FIELDS, ops)]
    if min_seq is not None:
        tensors.append(("min_seq", min_seq))
    O = ops[0].shape[1] if ops[0].dim() == 2 else -1
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, state on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in PLANES:
        if getattr(state, name).shape != (D, S):
            raise ValueError(f"{name} shape {tuple(getattr(state, name).shape)}"
                             f" != {(D, S)}")
    if state.prop_val.dim() != 3 or state.prop_val.shape[:2] != (D, S):
        raise ValueError("prop_val must be (D, S, K)")
    for name in ("count", "overflow"):
        if getattr(state, name).shape != (D,):
            raise ValueError(f"{name} must be ({D},)")
    for n, t in zip(merge_tree.OP_FIELDS, ops):
        if t.shape != (D, O):
            raise ValueError(f"op plane {n} shape {tuple(t.shape)} != {(D, O)}")
    if min_seq is not None and min_seq.shape != (D,):
        raise ValueError(f"min_seq must be ({D},)")


def apply_string_batch_fused(state: StringState, kind, a0, a1, a2, seq,
                             client, ref_seq, min_seq=None,
                             with_props: bool = False) -> StringState:
    """Apply a dense (D, O) op batch to ``state`` IN PLACE (the state's
    tensors are overwritten, as the JAX kernel aliased them) and return it.

    ``min_seq`` (D,) fuses zamboni into the same pass. After a compaction
    only ``[0, count)`` and the digest are specified (the kernel zeroes the
    vacated slots and sets their ``removed_seq`` to NOT_REMOVED; the plain
    version leaves them sorted). ``with_props=False`` is the annotate-free
    specialisation: ``prop_val`` is neither read nor written.

    Every tensor must be int32, contiguous and on the state's device. CUDA
    tensors launch the kernel; CPU tensors run the plain composition."""
    global launches
    ops = (kind, a0, a1, a2, seq, client, ref_seq)
    _check(state, ops, min_seq)
    if state.seq.device.type == "cpu":
        out = merge_tree.apply_string_batch(state, *ops,
                                            with_props=with_props)
        if min_seq is not None:
            out = merge_tree.compact_string_state(out, min_seq, with_props)
        for k, v in state.fields().items():
            v.copy_(getattr(out, k))
        return state
    if state.seq.device.type != "cuda":
        raise ValueError(f"unsupported device {state.seq.device}")
    lib = _load()
    D, S = state.seq.shape
    O = kind.shape[1]
    K = state.prop_val.shape[2] if with_props else 0
    smem = lib.string_apply_smem_bytes(D, S, O, K)
    if smem > MAX_SMEM:
        raise ValueError(f"one doc needs {smem} B of shared memory at S={S},"
                         f" O={O}, K={K}; the limit is {MAX_SMEM} B")
    if D == 0:
        return state
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    # the library acts on the current device: make it the state's
    with torch.cuda.device(state.seq.device):
        stream = torch.cuda.current_stream(state.seq.device).cuda_stream
        err = lib.string_apply_launch(
            *(ptr(t) for t in ops),
            *(ptr(getattr(state, k)) for k in PLANES),
            ptr(state.prop_val), ptr(state.count), ptr(state.overflow),
            ptr(min_seq) if min_seq is not None else None,
            D, S, O, K, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("string_apply launch failed: "
                           + lib.string_apply_error_string(err).decode())
    launches += 1
    shapes[(D, S, O, K, min_seq is not None)] += 1
    return state

