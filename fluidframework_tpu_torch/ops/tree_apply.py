"""ctypes binding of the SharedTree kernels (``csrc/tree_apply.cu``).

K5 ``launch_apply`` replaces ``fluidframework_tpu/ops/tree_kernel.py``'s
``apply_tree_batch`` / ``apply_tree_planes`` (the per-doc record scan) and
the scan half of ``apply_tree_wire``; it updates the eight state planes and
the overflow flags IN PLACE. K6 ``launch_expand`` replaces the expansion
half of ``apply_tree_wire``: the width-coded wire expanded into dense
(9, D, o) record planes, every cell written in one launch. See the source for their design. Both take CUDA
tensors only, check device, dtype, shape and contiguity, launch on the
current stream and raise when a launch is refused. The device dispatch
(plain versions on the CPU) lives in ``tree_kernel``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

#: K5 / K6 launches made through this module (callers reset them)
apply_launches = 0
expand_launches = 0

_STATE_PLANES = ("node_id", "parent", "field", "value", "type_",
                 "prev_sib", "next_sib", "created_seq")
_WIDTHS = {"ids": (torch.uint16, torch.uint32),
           "vals": (torch.uint16, torch.uint32),
           "pos": (torch.uint8, torch.uint16)}

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("tree_apply")
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.tree_apply_launch.restype = i32
            lib.tree_apply_launch.argtypes = [vp] * 11 + [i32] * 3 + [vp]
            lib.tree_expand_launch.restype = i32
            lib.tree_expand_launch.argtypes = (
                [vp] * 6 + [i32, vp, i32, vp, i32, vp, i32, vp]
                + [i32] * 6 + [vp])
            lib.tree_apply_shape.restype = None
            lib.tree_apply_shape.argtypes = [i32, i32, i32, vp]
            lib.tree_max_slots.restype = i32
            lib.tree_max_slots.argtypes = []
            lib.tree_error_string.restype = ctypes.c_char_p
            lib.tree_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def max_slots() -> int:
    """The largest node capacity N the apply kernel takes (a doc's eight
    planes and one scratch plane in shared memory), read from the built
    library."""
    return _load().tree_max_slots()


#: the apply kernel's constants (``csrc/tree_apply.cu``): shared memory a
#: CTA may take, 4-byte planes a staged doc keeps (eight and the parent
#: slots), most docs a CTA with a sparse path, warps a CTA on staged-only
#: launches, node ids a lane keeps in registers
_MAX_SMEM, _SMEM_PLANES, _WARPS, _MAX_WARPS, _MAX_REG_SLOTS = \
    232448, 9, 8, 4, 32


def launch_shape(N: int, D: int, sms: int) -> dict:
    """K5's launch at capacity N for D docs on a card of ``sms`` SMs, as
    the source picks it: node ids a lane keeps in registers on the sparse
    path (0: every active doc is staged, N > 1,024), warps (docs) a CTA —
    each with its own staged region, the regions within half the shared
    memory when there is a sparse path, and no more than D / sms so that a
    small launch spreads over the SMs — and a CTA's dynamic shared memory."""
    spl = 0
    if N <= 32 * _MAX_REG_SLOTS:
        spl = 1
        while 32 * spl < N:
            spl *= 2
    per_region = 4 * _SMEM_PLANES * N
    if spl:
        warps = min(_MAX_SMEM // 2 // per_region, _WARPS)
    else:
        warps = min(_MAX_SMEM // per_region, _MAX_WARPS)
    if sms > 0:
        warps = min(warps, -(-D // sms))
    warps = max(warps, 1)
    return {"slots_per_lane": spl, "warps": warps,
            "smem_bytes": warps * per_region}


def check_capacity(N: int) -> None:
    """Raise ValueError unless the apply kernel takes a capacity of N."""
    if not 1 <= N <= max_slots():
        raise ValueError(f"tree capacity N={N}: the tree_apply kernel takes "
                         f"1 to {max_slots()} node slots (nine planes of a "
                         "doc in shared memory)")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _load().tree_error_string(err).decode())


def _check_tensor(name: str, t: torch.Tensor, dev, dtypes, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_apply(state, planes: torch.Tensor, base=None) -> None:
    """K5: apply the (9, D, O) int32 record planes to ``state`` (a
    ``TreeState``) in place. ``base`` (D,) int32 selects wire mode: plane 8
    then holds first-of-op bits and each seq is derived in the scan."""
    global apply_launches
    dev = state.node_id.device
    if dev.type != "cuda":
        raise ValueError(f"the tree_apply kernel runs on CUDA tensors, got "
                         f"{dev}")
    D, N = state.node_id.shape
    check_capacity(N)
    for k in _STATE_PLANES:
        _check_tensor(k, getattr(state, k), dev, (torch.int32,), (D, N))
    _check_tensor("overflow", state.overflow, dev, (torch.int32,), (D,))
    O = planes.shape[2] if planes.dim() == 3 else -1
    _check_tensor("record planes", planes, dev, (torch.int32,), (9, D, O))
    if base is not None:
        _check_tensor("base", base, dev, (torch.int32,), (D,))
    if D == 0 or O == 0:
        return
    with torch.cuda.device(dev):   # the library acts on the current device
        _raise_on(_load().tree_apply_launch(
            *(_ptr(getattr(state, k)) for k in _STATE_PLANES),
            _ptr(state.overflow), _ptr(planes), _ptr(base), D, N, O,
            _stream(planes)), "tree_apply")
    apply_launches += 1


def launch_expand(cols, ids, vals, row, pos, id_map, f_map, t_map, v_map,
                  out: torch.Tensor) -> None:
    """K6: expand the wire's records into ``out`` (9, D, o) int32. The
    kernel writes every cell (0 where no record lands, all of it when R is
    0), so ``out`` may be uninitialised. ids / vals are u16 or u32, pos u8
    or u16, each read at its own width."""
    global expand_launches
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the tree_expand kernel runs on CUDA tensors, got "
                         f"{dev}")
    if out.dim() != 3 or out.shape[0] != 9:
        raise ValueError(f"out shape {tuple(out.shape)} != (9, D, o)")
    _check_tensor("out", out, dev, (torch.int32,), out.shape)
    _, D, o = out.shape
    R = cols.shape[0]
    _check_tensor("cols", cols, dev, (torch.uint8,), (R, 3))
    _check_tensor("ids", ids, dev, _WIDTHS["ids"], (R, 3))
    _check_tensor("vals", vals, dev, _WIDTHS["vals"], (R,))
    _check_tensor("row", row, dev, (torch.uint16,), (R,))
    _check_tensor("pos", pos, dev, _WIDTHS["pos"], (R,))
    for name, m in (("id_map", id_map), ("f_map", f_map), ("t_map", t_map),
                    ("v_map", v_map)):
        _check_tensor(name, m, dev, (torch.int32,), (max(m.shape[0], 1),))
    if D == 0 or o == 0:
        return
    with torch.cuda.device(dev):   # the library acts on the current device
        _raise_on(_load().tree_expand_launch(
            _ptr(cols), _ptr(ids), _ptr(vals), _ptr(row), _ptr(pos),
            _ptr(id_map), id_map.shape[0], _ptr(f_map), f_map.shape[0],
            _ptr(t_map), t_map.shape[0], _ptr(v_map), v_map.shape[0],
            _ptr(out), R, D, o, ids.element_size(), vals.element_size(),
            pos.element_size(), _stream(out)), "tree_expand")
    expand_launches += 1
