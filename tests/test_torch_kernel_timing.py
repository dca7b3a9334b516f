"""The nearly full inputs that ``testing/kernel_timing.py`` times the
kernel on, run through the JAX reference and the port's plain version on
the CPU: the same state and ops give the same planes (full planes after an
apply; ``[0, count)`` plus the digest after a compaction), every op
position is valid and no doc overflows. Its axis mode: K3 / K4 inputs
saved and reloaded as ``chip_smoke.py --parent`` saves them, whose plain
results equal JAX's and the entry points' on the CPU. Its map and tree
expansion modes: the K1 batches (dense and packed) and the K6 serving
wave (u16 and widened u32 ids), at a small size, give JAX's planes through
the plain versions and the entry points on the CPU. Tolerance: exact
(int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import axis_kernel as jak
from fluidframework_tpu.ops import map_kernel as jmk
from fluidframework_tpu.ops import merge_tree_kernel as jmt
from fluidframework_tpu.ops import tree_kernel as jtk
from fluidframework_tpu_torch.ops import axis_kernel as tak
from fluidframework_tpu_torch.core.constants import NOT_REMOVED
from fluidframework_tpu_torch.ops import map_kernel as tmk
from fluidframework_tpu_torch.ops import merge_tree as tmt
from fluidframework_tpu_torch.ops import tree_kernel as ttk
from fluidframework_tpu_torch.ops.schema import OpKind
from fluidframework_tpu_torch.ops import tree_store as tstore
from fluidframework_tpu_torch.ops.string_kernel import (
    apply_string_batch_fused,
)
from fluidframework_tpu_torch.testing import kernel_timing as kt
from fluidframework_tpu_torch.testing import synthetic

D, S, O = 8, 96, 16


def _visible_chars(st):
    act = torch.arange(st.seq.shape[1])[None, :] < st.count[:, None]
    live = act & (st.removed_seq == NOT_REMOVED)
    return (st.length * live).sum(1, dtype=torch.int32)


@pytest.mark.parametrize("spec", [s[0] for s in kt.SPECS])
def test_near_full_inputs_match_jax(spec):
    _, props, compact = next(s for s in kt.SPECS if s[0] == spec)
    st, ops, ms = kt.near_full(tmt, synthetic, D, S, O, props, device="cpu")
    assert int(st.count[0]) == S - 2 * O
    sj = jmt.StringState(**{k: jnp.asarray(v.numpy())
                            for k, v in st.fields().items()})
    jops = [jnp.asarray(t.numpy()) for t in ops]
    sj = jmt.apply_string_batch_jit(sj, *jops, with_props=props)
    out = tmt.apply_string_batch(st, *ops, with_props=props)
    if compact:
        sj = jmt.compact_string_state(sj, jnp.asarray(ms.numpy()), props)
        out = tmt.compact_string_state(out, ms, props)
    assert not out.overflow.any()
    j = tmt.StringState(**{k: torch.as_tensor(np.array(getattr(sj, k)))
                           for k in out.fields()})
    assert kt.max_abs_err(tmt, out, j, props, compact) == 0
    # the fused wrapper on CPU tensors agrees as well
    fused = apply_string_batch_fused(
        kt.near_full(tmt, synthetic, D, S, O, props, device="cpu")[0], *ops,
        min_seq=ms if compact else None, with_props=props)
    assert kt.max_abs_err(tmt, fused, out, props, compact) == 0


def test_near_full_typing_positions_are_valid():
    """Every typing-storm op lands inside the text: the visible length
    grows by exactly the storm's inserted minus removed characters."""
    st, ops, _ = kt.near_full(tmt, synthetic, D, S, O, False, device="cpu")
    before = _visible_chars(st)
    kind = ops[0]
    net = (synthetic.INS_LEN * (kind == 0).sum(1)
           - synthetic.RM_LEN * (kind == 1).sum(1)).to(torch.int32)
    out = tmt.apply_string_batch(st, *ops, with_props=False)
    assert torch.equal(_visible_chars(out), before + net)
    assert int(out.count.max()) <= S and not out.overflow.any()


def test_max_abs_err_sees_a_difference():
    st, ops, ms = kt.near_full(tmt, synthetic, D, S, O, True, device="cpu")
    out = tmt.apply_string_batch(st, *ops, with_props=True)
    bad = tmt.StringState(**{k: v.clone() for k, v in out.fields().items()})
    bad.length[3, 5] += 7
    assert kt.max_abs_err(tmt, bad, out, True, False) == 7
    bad = tmt.StringState(**{k: v.clone() for k, v in out.fields().items()})
    bad.prop_val[1, 0, 2] -= 3
    assert kt.max_abs_err(tmt, bad, out, True, True) > 0


def _axis_launches(seed=0, D=6, S=64, O=24):
    """{(kernel, spec): (state, ops)} as the matrix engine's paths give
    them: a state two seeded windows deep, a K3 window on it and a K4
    window of resolves (latest-view reads, NOOP slots) on it."""
    rng = np.random.default_rng(seed)
    st = tmt.StringState.create(D, S, n_props=1, device="cpu")
    seq = 1
    for _ in range(2):
        planes, seq = synthetic.axis_window(
            rng, tak.axis_visible_lengths(st).numpy(), O, seq)
        st, _, _ = tak.apply_axis_batch(
            st, *(torch.as_tensor(planes[k]) for k in tmt.OP_FIELDS))
    planes, _ = synthetic.axis_window(
        rng, tak.axis_visible_lengths(st).numpy(), O, seq)
    k3 = [torch.as_tensor(planes[k]) for k in tmt.OP_FIELDS]
    lengths = tak.axis_visible_lengths(st).numpy()
    pos = (rng.random((D, 40)) * (lengths[:, None] + 3)).astype(np.int32)
    client = rng.integers(-1, 4, size=(D, 40)).astype(np.int32)
    ref = rng.integers(0, 3 * O, size=(D, 40)).astype(np.int32)
    ref[client < 0] = 1 << 30
    kind = np.where(rng.random((D, 40)) < 0.9, kt.AXIS_RESOLVE,
                    12).astype(np.int32)
    k4 = [torch.as_tensor(x) for x in (kind, pos, client, ref)]
    return {("axis_apply", "(c) per-op concurrent waves"): (st, k3),
            ("axis_resolve", "(b) ingest_cells storms"): (st, k4)}


def _jax_plain(kernel, st, ops):
    js = jmt.StringState(**{k: jnp.asarray(v.numpy())
                            for k, v in st.fields().items()})
    if kernel == "axis_apply":
        js, run, off = jak.apply_axis_batch_jit(
            js, *(jnp.asarray(o.numpy()) for o in ops))
        out = tmt.StringState(**{k: torch.as_tensor(np.array(getattr(js, k)))
                                 for k in st.fields()})
    else:
        kind, pos, client, ref = (o.numpy() for o in ops)
        run, off = jak.resolve_axis_positions(
            js, *(jnp.asarray(x) for x in (pos, client, ref)))
        run = np.where(kind == kt.AXIS_RESOLVE, np.asarray(run), -1)
        off = np.where(kind == kt.AXIS_RESOLVE, np.asarray(off), -1)
        out = st
    return out, torch.as_tensor(np.array(run)), torch.as_tensor(np.array(off))


def test_axis_inputs_round_trip(tmp_path):
    """Saved as ``chip_smoke.py --parent`` saves the matrix engine's
    widest launches, reloaded for ``kernel_timing.py --axis-inputs``:
    every plane and op plane comes back equal, under the same keys."""
    launches = _axis_launches()
    path = str(tmp_path / "axis.pt")
    kt.save_inputs(path, launches)
    back = kt.saved_inputs(tmt, path, "cpu")
    assert set(back) == set(launches)
    for key, (st, ops) in launches.items():
        st2, ops2 = back[key]
        assert all(torch.equal(v, getattr(st2, k))
                   for k, v in st.fields().items())
        assert len(ops) == len(ops2)
        assert all(torch.equal(a, b) for a, b in zip(ops, ops2))


@pytest.mark.parametrize("kernel", kt.AXIS_KERNELS)
def test_axis_plain_path_matches_jax(kernel):
    """The axis mode's plain result equals JAX's and the entry point's on
    the CPU (error 0); ``axis_err`` sees a changed slot past count and a
    changed output."""
    (key, (st, ops)), = [(k, v) for k, v in _axis_launches(1).items()
                         if k[0] == kernel]
    want = kt.axis_plain(tak, kernel, st, ops)
    assert kt.axis_err(tmt, _jax_plain(kernel, st, ops), want) == 0
    work = tmt.StringState(**{k: v.clone() for k, v in st.fields().items()})
    got = (work, *kt.axis_launch(tak, kernel, work, ops))
    assert kt.axis_err(tmt, got, want) == 0
    if kernel == "axis_resolve":
        assert all(torch.equal(v, getattr(st, k))
                   for k, v in work.fields().items())
        assert bool((want[1] >= 0).any()) and bool((want[1] < 0).any())
    bad_run = got[1].clone()
    bad_run[0, 0] += 3
    assert kt.axis_err(tmt, (got[0], bad_run, got[2]), want) == 3
    past = tmt.StringState(**{k: v.clone() for k, v in got[0].fields()
                              .items()})
    i = int(past.count[0])
    assert i < past.length.shape[1]
    past.length[0, i] += 5   # the first slot past count
    assert kt.axis_err(tmt, (past, got[1], got[2]), want) == 5


def _same_map(jstate, tstate, what):
    for k in tmk.PLANES:
        assert np.array_equal(np.asarray(getattr(jstate, k)),
                              getattr(tstate, k).numpy()), (what, k)


def test_map_inputs_apply_like_jax():
    """K1's timing inputs at a small size: dense at two doc counts and the
    packed serving batch. JAX's ``apply_map_batch`` /
    ``map_columnar_apply_jit``, the plain version and the entry point (in
    place on the CPU state) give the same planes, and the batches clear,
    set and delete."""
    ins = kt.map_inputs(tmk, synthetic, "cpu", D=16, K=8, O=8, wide_d=24)
    assert set(ins) == {"dense, D = 16", "dense, D = 24",
                        "packed, config #2 serving"}
    for spec, (st, mode, args) in ins.items():
        want = kt.map_call(tmk, mode, st, args, plain=True)
        js = jmk.MapState(*(jnp.asarray(v.numpy())
                            for v in st.fields().values()))
        if mode == "dense":
            kind = args[0]
            js = jmk.apply_map_batch(js, *(jnp.asarray(a.numpy())
                                           for a in args))
        else:
            buf, R, O, wide = args
            kind = tmk.map_unpack(buf, R, O, R, False, wide)[0]
            js = jmk.map_columnar_apply_jit(
                js, jnp.asarray(buf.numpy()), R=R, O=O,
                n_docs=st.present.shape[0], scatter_rows=True,
                wide_vals=wide)
        for k in (OpKind.MAP_SET, OpKind.MAP_DELETE, OpKind.MAP_CLEAR):
            assert bool((kind == int(k)).any()), (spec, k)
        _same_map(js, want, spec)
        out = kt.map_call(tmk, mode, st, args)
        assert out is st
        _same_map(js, st, spec)


def test_expand_inputs_apply_like_jax():
    """K6's timing inputs at a small size: the serving engine's last
    record wave as shipped (u16) and widened to u32. The entry point's
    buffer equals the plain expansion, both widths expand alike, and the
    wire applied by JAX's ``apply_tree_wire``, the plain version and the
    entry point (in place on the CPU state) gives the same planes."""
    served = kt.serving_waves(tstore, synthetic, "cpu", docs=12, N=16,
                              waves=4)
    ins = kt.expand_inputs(tstore, synthetic, "cpu", served=served)
    assert set(ins) == {"serving wave, u16 ids", "serving wave, u32 ids"}
    first = None
    for spec, (st, wire, o) in ins.items():
        D = st.node_id.shape[0]
        want = ttk.expand_tree_wire(*wire[:5], *wire[6:], n_docs=D, o=o)
        assert torch.equal(kt.expand_call(ttk, wire, D, o), want)
        first = want if first is None else first
        assert torch.equal(want, first), spec
        assert int((want[0] != 0).sum()) == 3 * D
        js = jtk.apply_tree_wire(
            jtk.TreeState(**{k: jnp.asarray(v.numpy())
                             for k, v in st.fields().items()}),
            *(jnp.asarray(x.numpy()) for x in wire), o=o)
        port = ttk.apply_tree_wire(st, *wire, o=o)
        fused = ttk.apply_tree_wire_fused(st.clone(), *wire, o=o)
        for k in ttk.TREE_PLANES + ("overflow",):
            j = np.asarray(getattr(js, k))
            assert np.array_equal(j, getattr(port, k).numpy()), (spec, k)
            assert np.array_equal(j, getattr(fused, k).numpy()), (spec, k)
