"""ctypes binding of the mega-doc apply kernel K7 (``csrc/megadoc_apply.cu``).

K7 replaces ``fluidframework_tpu/ops/megadoc_kernel.py``'s
``apply_megadoc_batch`` (body ``_shard_step``): one thread-block cluster a
document, one CTA a shard, the all-gathers of position resolution read
through distributed shared memory; slots lane-strided in warp chunks, work
bounded by the live extent, one move pass an edit and the tail written
back once; see the source for its design. It updates the state IN PLACE. ``launch`` takes CUDA tensors only, checks
device, dtype, shape and contiguity, launches on the current stream and
raises when the launch is refused (``cudaGetLastError()`` after it). The
device dispatch (plain version on the CPU) lives in ``megadoc_kernel``.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

from . import cuda_build, merge_tree

#: K7 launches made through this module (callers reset it)
launches = 0
#: the same launches by shape: (D, n, S_local, O, K) → count
shapes: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("megadoc_apply")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.megadoc_apply_launch.restype = i32
            lib.megadoc_apply_launch.argtypes = [vp] * 17 + [i32] * 5 + [vp]
            lib.megadoc_apply_active_clusters.restype = i32
            lib.megadoc_apply_active_clusters.argtypes = [
                i32, i32, i32, ctypes.POINTER(i32)]
            lib.megadoc_apply_smem_bytes.restype = ctypes.c_longlong
            lib.megadoc_apply_smem_bytes.argtypes = [i32, i32]
            for name in ("max_shards", "portable_shards"):
                fn = getattr(lib, "megadoc_apply_" + name)
                fn.restype, fn.argtypes = i32, []
            for name in ("slots_per_lane", "threads"):
                fn = getattr(lib, "megadoc_apply_" + name)
                fn.restype, fn.argtypes = i32, [i32]
            lib.megadoc_apply_max_slots.restype = i32
            lib.megadoc_apply_max_slots.argtypes = [i32]
            lib.megadoc_apply_error_string.restype = ctypes.c_char_p
            lib.megadoc_apply_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def _error(err: int) -> str:
    return _load().megadoc_apply_error_string(err).decode()


def max_slots_per_shard(K: int = 4) -> int:
    """The most slots a shard may hold with K property planes (its planes
    and scratch in one CTA's shared memory), read from the built
    library."""
    return _load().megadoc_apply_max_slots(K)


def launch_shape(S: int) -> tuple:
    """(slots a lane, threads a CTA) of a launch at S slots a shard."""
    lib = _load()
    return lib.megadoc_apply_slots_per_lane(S), lib.megadoc_apply_threads(S)


def smem_bytes(S: int, K: int = 4) -> int:
    """One CTA's dynamic shared memory at S slots a shard and K planes."""
    return _load().megadoc_apply_smem_bytes(S, K)


def active_clusters(n: int, S: int, K: int = 4) -> int:
    """How many clusters of n shards at (S, K) the card runs at once
    (``cudaOccupancyMaxActiveClusters``); 0 when none can be placed."""
    out = ctypes.c_int()
    err = _load().megadoc_apply_active_clusters(n, S, K, ctypes.byref(out))
    if err != 0:
        raise ValueError(f"a cluster of {n} shards at S={S}, K={K} is "
                         f"refused: {_error(err)}")
    return out.value


def max_shards(S: int = 1, K: int = 4) -> int:
    """The most shards a document may have at (S, K): the non-portable
    cluster size of the library when the card places one such cluster,
    else the portable size (8)."""
    lib = _load()
    wide, portable = lib.megadoc_apply_max_shards(), \
        lib.megadoc_apply_portable_shards()
    try:
        if active_clusters(wide, S, K) >= 1:
            return wide
    except ValueError:
        pass
    return portable


def check_layout(n: int, S: int, K: int = 4) -> None:
    """Raise ValueError unless K7 takes documents of n shards × S slots
    with K property planes on this card (the refusal at construction)."""
    if S < 1 or S > max_slots_per_shard(K):
        raise ValueError(
            f"capacity_per_shard {S} with K={K} is past what the "
            f"megadoc_apply kernel takes (1 .. {max_slots_per_shard(K)} "
            "slots: a shard's planes live in one CTA's shared memory)")
    if n < 1 or n > max_shards(S, K):
        raise ValueError(
            f"{n} shards is past what the megadoc_apply kernel takes on "
            f"this card (1 .. {max_shards(S, K)}: one cluster a document)")
    if active_clusters(n, S, K) < 1:
        raise ValueError(f"the card cannot place a cluster of {n} CTAs "
                         f"with {smem_bytes(S, K)} B of shared memory each")


def _check(state, ops) -> None:
    dev = state.seq.device
    if dev.type != "cuda":
        raise ValueError(f"the megadoc_apply kernel runs on CUDA tensors, "
                         f"got {dev}")
    D, n = state.count.shape if state.count.dim() == 2 else (-1, -1)
    if D < 0:
        raise ValueError("count must be (D, n_shards)")
    W = state.seq.shape[1] if state.seq.dim() == 2 else -1
    if W < 0 or W % n:
        raise ValueError(f"planes must be (D, n·S_local), got "
                         f"{tuple(state.seq.shape)} for {n} shards")
    O = ops[0].shape[1] if ops[0].dim() == 2 else -1
    tensors = list(state.fields().items()) + \
        [(f"op {k}", t) for k, t in zip(merge_tree.OP_FIELDS, ops)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, state on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for k in merge_tree.PLANES:
        if getattr(state, k).shape != (D, W):
            raise ValueError(f"{k} shape {tuple(getattr(state, k).shape)} "
                             f"!= {(D, W)}")
    if state.prop_val.dim() != 3 or state.prop_val.shape[:2] != (D, W):
        raise ValueError("prop_val must be (D, n·S_local, K)")
    if state.overflow.shape != (D, n):
        raise ValueError(f"overflow must be {(D, n)}")
    for k, t in zip(merge_tree.OP_FIELDS, ops):
        if t.shape != (D, O):
            raise ValueError(f"op plane {k} shape {tuple(t.shape)} != "
                             f"{(D, O)}")


def launch(state, kind, a0, a1, a2, seq, client, ref_seq) -> None:
    """Apply dense (D, O) int32 op planes to ``state`` (a mega-doc
    ``StringState``: planes (D, n·S_local), count / overflow (D, n)) in
    place, on the current stream."""
    global launches
    ops = (kind, a0, a1, a2, seq, client, ref_seq)
    _check(state, ops)
    D, n = state.count.shape
    S = state.seq.shape[1] // n
    O = kind.shape[1]
    K = state.prop_val.shape[2]
    if D == 0 or O == 0:
        return
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    # the library acts on the current device: make it the state's
    with torch.cuda.device(state.seq.device):
        stream = torch.cuda.current_stream(state.seq.device).cuda_stream
        err = _load().megadoc_apply_launch(
            *(ptr(t) for t in ops),
            *(ptr(getattr(state, k)) for k in merge_tree.PLANES),
            ptr(state.prop_val), ptr(state.count), ptr(state.overflow),
            D, n, S, O, K, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("megadoc_apply launch failed: " + _error(err))
    launches += 1
    shapes[(D, n, S, O, K)] += 1
