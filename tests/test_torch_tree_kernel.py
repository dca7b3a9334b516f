"""The port's plain tree record scan (``fluidframework_tpu_torch/ops/
tree_kernel.py``) against the JAX functions on the same numpy-seeded
``tree_record_storm`` inputs: ``apply_tree_batch`` / ``apply_tree_planes``
/ ``apply_tree_wire`` at both id widths, the row gather and write, and
``tree_state_digest``. Tolerance: exact (int32 bit identity of all eight
planes, free slots included, and the overflow flags)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import tree_kernel as jk
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.ops.tree_store import pack_wire_records
from fluidframework_tpu_torch.testing.synthetic import (
    tree_record_storm, tree_storm_flat,
)

D, O, N = 24, 64, 32
ALL = tk.TREE_PLANES + ("overflow",)


def _to_jax(st: tk.TreeState) -> jk.TreeState:
    return jk.TreeState(**{k: jnp.asarray(v.numpy())
                           for k, v in st.fields().items()})


def _assert_same(j: jk.TreeState, t: tk.TreeState, what=""):
    for k in ALL:
        a, b = np.asarray(getattr(j, k)), getattr(t, k).numpy()
        assert np.array_equal(a, b), (what, k, np.argwhere(a != b)[:4])


def _storms(seed, n=4, d=D, o=O, cap=N):
    return [tree_record_storm(d, o, seed=seed * 10 + b, capacity=cap,
                              start_seq=1 + 1000 * b) for b in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_apply_tree_planes_matches_jax(seed):
    """Four chained batches; some docs overflow, and removes, moves and
    guarded groups apply."""
    js = jk.TreeState.create(D, N)
    ts = tk.TreeState.create(D, N, device="cpu")
    for b, p in enumerate(_storms(seed)):
        js = jk.apply_tree_planes_jit(js, jnp.asarray(p))
        ts = tk.apply_tree_planes(ts, torch.from_numpy(p))
        _assert_same(js, ts, f"batch {b}")
    assert 0 < int(ts.overflow.sum()) < D
    assert int((ts.node_id[:, 1:] != 0).sum()) > D


def test_apply_tree_batch_matches_jax():
    p = _storms(7, n=1)[0]
    js = jk.apply_tree_batch(jk.TreeState.create(D, N),
                             *(jnp.asarray(p[i]) for i in
                               (0, 1, 2, 3, 4, 5, 6, 8, 7)))
    ts = tk.apply_tree_batch(tk.TreeState.create(D, N, device="cpu"),
                             *(torch.from_numpy(p[i]) for i in
                               (0, 1, 2, 3, 4, 5, 6, 8, 7)))
    _assert_same(js, ts)


def test_every_kind_on_a_hand_built_doc():
    """One doc through each kind once, including a failed guard, a dead
    anchor, a nested insert from another seq, an inner-node remove and a
    move into the node's own subtree."""
    K = tk.TreeOpKind
    rec = [  # kind, node, parent, after, field, value, type_, meta, seq
        (K.INSERT_SOLO, 2, 1, 0, 1, 5, 1, 0, 1),
        (K.INSERT, 3, 2, 0, 1, 6, 0, 1, 1),       # nested, same seq
        (K.INSERT, 4, 3, 0, 1, 7, 0, 1, 1),
        (K.INSERT, 9, 2, 0, 1, 1, 0, 1, 2),       # nested, other seq
        (K.INSERT_SOLO, 5, 1, 99, 1, 8, 0, 0, 3),  # dead anchor
        (K.INSERT_SOLO, 6, 1, 2, 1, 9, 0, 0, 4),   # after 2
        (K.TXN_BEGIN_EXISTS, 42, 0, 0, 0, 0, 0, 0, 5),  # fails
        (K.SET_VALUE, 2, 0, 0, 0, 77, 0, 0, 5),
        (K.TXN_BEGIN, 0, 0, 0, 0, 0, 0, 0, 6),
        (K.TXN_GUARD_EXISTS, 2, 0, 0, 0, 0, 0, 0, 6),
        (K.INS_GUARD_ABSENT, 7, 0, 0, 0, 0, 0, 0, 6),
        (K.INSERT, 7, 2, 0, 2, 3, 0, 0, 6),
        (K.INS_BEGIN, 0, 0, 0, 0, 0, 0, 0, 6),
        (K.SET_VALUE, 5, 0, 0, 0, 11, 0, 0, 6),
        (K.MOVE_SOLO, 2, 4, 0, 1, 0, 0, 0, 7),     # into own subtree
        (K.MOVE_SOLO, 3, 1, 6, 1, 0, 0, 0, 8),
        (K.NOOP, 0, 0, 0, 0, 0, 0, 0, 0),
        (K.REMOVE_SOLO, 2, 0, 0, 0, 0, 0, 0, 9),   # inner node
        (K.SET_SOLO, 4, 0, 0, 0, 12, 0, 0, 10),
        (K.REMOVE_SOLO, 1, 0, 0, 0, 0, 0, 0, 11),  # root is immutable
        (K.MOVE, 6, 3, 0, 1, 0, 0, 0, 12),
    ]
    p = np.array(rec, np.int32).T[[0, 1, 2, 3, 4, 5, 6, 7, 8]]
    p = p[:, None, :]
    js = jk.apply_tree_planes(jk.TreeState.create(1, 16), jnp.asarray(p))
    ts = tk.apply_tree_planes(tk.TreeState.create(1, 16, device="cpu"),
                              torch.from_numpy(p))
    _assert_same(js, ts)
    live = set(ts.node_id[0].tolist()) - {0}
    assert live == {1, 3, 4, 5, 6}


@pytest.mark.parametrize("width", ["u16", "u32"])
def test_apply_tree_wire_matches_jax(width):
    """The same records packed by ``pack_wire_records`` through the wire
    expansion: equal to the JAX wire apply, and to the dense planes."""
    idt = np.uint16 if width == "u16" else np.uint32
    js = jk.TreeState.create(D, N)
    ts = tk.TreeState.create(D, N, device="cpu")
    tp = tk.TreeState.create(D, N, device="cpu")
    for b, p in enumerate(_storms(3, n=2)):
        recs, rec_op, rows = tree_storm_flat(p)
        cols, ids, vals, row, pos, o = pack_wire_records(
            recs, rec_op, rows, id_t=idt, val_t=idt)
        assert ids.dtype == idt and vals.dtype == idt
        base = np.full(D, 1 + 1000 * b, np.int32)
        m = np.arange(int(recs.max()) + 2, dtype=np.int32)
        js = jk.apply_tree_wire_jit(
            js, *(jnp.asarray(x) for x in (cols, ids, vals, row, pos, base,
                                            m, m, m, m)), o=o)
        ts = tk.apply_tree_wire(
            ts, *(torch.from_numpy(x) for x in (cols, ids, vals, row, pos,
                                                 base, m, m, m, m)), o=o)
        tp = tk.apply_tree_planes(tp, torch.from_numpy(p))
        _assert_same(js, ts, f"batch {b}")
        for k in ALL:
            assert torch.equal(getattr(ts, k), getattr(tp, k)), (b, k)


def test_wire_expansion_drops_padding_and_clamps_maps():
    """``pos >= o`` and ``row >= D`` records drop; a map index past the
    map's end reads its last entry (XLA's gather)."""
    cols = np.array([[5 | (3 << 4), 1, 1], [9, 1, 1], [9, 7, 1],
                     [9, 1, 1]], np.uint8)
    ids = np.array([[1, 2, 0], [2, 3, 0], [3, 9, 0], [1, 1, 1]], np.uint16)
    vals = np.array([1, 2, 3, 4], np.uint16)
    row = np.array([0, 1, 1, 5], np.uint16)
    pos = np.array([0, 0, 4, 1], np.uint8)
    m = np.array([0, 11, 12, 13], np.int32)
    dense = tk.expand_tree_wire(*(torch.from_numpy(x) for x in (
        cols, ids, vals, row, pos, m, m, m, m)), n_docs=2, o=4)
    assert dense.shape == (9, 2, 4)
    assert dense[:, 0, 0].tolist() == [5, 11, 12, 0, 11, 11, 11, 1, 1]
    assert dense[:, 1, 0].tolist() == [9, 12, 13, 0, 11, 12, 11, 0, 0]
    assert int(dense[:, :, 1:].abs().sum()) == 0


def test_rows_gather_write_and_digest_match_jax():
    p = _storms(5, n=2)
    js = jk.TreeState.create(D, N)
    ts = tk.TreeState.create(D, N, device="cpu")
    for x in p:
        js = jk.apply_tree_planes_jit(js, jnp.asarray(x))
        ts = tk.apply_tree_planes(ts, torch.from_numpy(x))
    rows = np.array([3, 0, 17, 3], np.int32)
    jg = jk.gather_tree_rows_jit(js, jnp.asarray(rows))
    tg = tk.gather_tree_rows(ts, torch.from_numpy(rows))
    for a, b in zip(jg, tg):
        assert np.array_equal(np.asarray(a), b.numpy())
    src = [np.array(x) for x in jk.gather_tree_rows_jit(
        js, jnp.asarray(np.array([5, 6, 7, 5], np.int32)))]
    js = jk.write_tree_rows_jit(js, jnp.asarray(rows), *map(jnp.asarray,
                                                            src))
    tk.write_tree_rows(ts, torch.from_numpy(rows),
                       *(torch.from_numpy(x) for x in src))
    _assert_same(js, ts)
    assert np.array_equal(np.asarray(jk.tree_state_digest(js)),
                          tk.tree_state_digest(ts).numpy())


def test_digest_wraps_like_jax():
    """Handles large enough that the mix passes 2^31 many times."""
    rng = np.random.default_rng(0)
    st = tk.TreeState.create(8, 16, device="cpu")
    for k in tk.TREE_PLANES:
        getattr(st, k).copy_(torch.from_numpy(rng.integers(
            0, 1 << 30, size=(8, 16)).astype(np.int32)))
    st.node_id[:, 3] = 0
    jd = jk.tree_state_digest(_to_jax(st))
    assert np.array_equal(np.asarray(jd), tk.tree_state_digest(st).numpy())


def test_fused_entry_points_update_the_cpu_state_in_place():
    p = _storms(2, n=1)[0]
    st = tk.TreeState.create(D, N, device="cpu")
    node_id = st.node_id
    want = tk.apply_tree_planes(st, torch.from_numpy(p))
    out = tk.apply_tree_planes_fused(st, torch.from_numpy(p))
    assert out is st and st.node_id is node_id
    for k in ALL:
        assert torch.equal(getattr(st, k), getattr(want, k)), k
    recs, rec_op, rows = tree_storm_flat(_storms(2, n=2)[1])
    cols, ids, vals, row, pos, o = pack_wire_records(recs, rec_op, rows)
    m = torch.arange(int(recs.max()) + 2, dtype=torch.int32)
    base = torch.full((D,), 1001, dtype=torch.int32)
    wire = [torch.from_numpy(x) for x in (cols, ids, vals, row, pos)]
    want = tk.apply_tree_wire(st, *wire, base, m, m, m, m, o=o)
    tk.apply_tree_wire_fused(st, *wire, base, m, m, m, m, o=o)
    for k in ALL:
        assert torch.equal(getattr(st, k), getattr(want, k)), k


def test_jax_runs_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"


# ------------------------------------------ the scan's two paths (K5)

def test_path_mix_chained_matches_jax():
    """``tree_path_mix`` batches (staged-path docs with removes and moves
    or many inserts beside docs with a few inserts and setValues,
    setValue-only and NOOP-only docs) after a storm that fills the docs:
    the plain scan equals JAX."""
    from fluidframework_tpu_torch.testing.synthetic import tree_path_mix
    js = jk.TreeState.create(D, N)
    ts = tk.TreeState.create(D, N, device="cpu")
    batches = [tree_record_storm(D, O, seed=31, capacity=N)] + [
        tree_path_mix(D, O, seed=32 + b, capacity=N, start_seq=1001 + 1000 * b)
        for b in range(2)]
    for b, p in enumerate(batches):
        js = jk.apply_tree_planes_jit(js, jnp.asarray(p))
        ts = tk.apply_tree_planes(ts, torch.from_numpy(p))
        _assert_same(js, ts, f"batch {b}")
    kinds = batches[1][0]
    structural, inserts = (6, 7, 10, 11), np.isin(kinds, (5, 9))
    assert np.isin(kinds[0::5], structural).any()
    assert not np.isin(kinds[1::5], structural).any()
    assert (inserts[1::5].sum(axis=1) > 4).any()
    assert not np.isin(kinds[2::5], structural).any()
    assert (inserts[2::5].sum(axis=1) <= 4).all() and inserts[2::5].any()
    assert np.isin(kinds[3::5], (0, 8, 12)).all() and not kinds[4::5].any()


@pytest.mark.parametrize("N_", [1, 32, 33, 128, 403, 404, 1024, 1025, 6456])
def test_apply_launch_shape(N_):
    """K5's launch as the source picks it: node ids in registers (a power
    of two a lane, 32·that >= N) up to N = 1,024, else the staged path
    alone; one staged region a warp, within half the shared memory with a
    sparse path, at most D / SMs docs a CTA, and every launch within the
    card's 232,448 bytes."""
    from fluidframework_tpu_torch.ops import tree_apply as ta
    for D in (1, 256, 8192):
        sh = ta.launch_shape(N_, D, 132)
        spl, warps = sh["slots_per_lane"], sh["warps"]
        if N_ <= 1024:
            assert spl & (spl - 1) == 0 and 32 * spl >= N_
            assert spl == 1 or 16 * spl < N_
            assert sh["smem_bytes"] <= 232448 // 2
            assert warps == (8 if N_ <= 403 else 232448 // 2 // (36 * N_)) \
                or warps == -(-D // 132)
        else:
            assert spl == 0 and warps <= 4
        assert 1 <= warps <= max(-(-D // 132), 1)
        assert sh["smem_bytes"] == warps * 36 * N_ <= 232448
    assert ta.launch_shape(128, 8192, 132)["warps"] == 8
    assert ta.launch_shape(128, 256, 132)["warps"] == 2
    assert ta.launch_shape(1024, 8192, 132)["warps"] == 3


def test_timing_inputs_apply_like_jax(tmp_path):
    """``testing/kernel_timing.py``'s K5 inputs at a small size (the
    serving engine's last record wave in wire mode, the kernel-alone batch
    in planes mode): the plain scan of each equals JAX's."""
    from fluidframework_tpu_torch.ops import tree_store as tstore
    from fluidframework_tpu_torch.testing import kernel_timing as kt
    from fluidframework_tpu_torch.testing import synthetic
    ins = kt.tree_inputs(tk, tstore, synthetic, "cpu", docs=12, N=16,
                         waves=4)
    for spec, (st, p, base) in ins.items():
        seq = p[8] if base is None else tk.wire_seq(p[8], base)
        args = [p[i] for i in range(7)] + [seq, p[7]]
        js = jk.apply_tree_batch(_to_jax(st),
                                 *(jnp.asarray(x.numpy()) for x in args))
        _assert_same(js, tk.apply_tree_batch(st, *args), spec)
        assert int((p[0] != 0).sum()) == 3 * 12
    # saved as chip_smoke.py --parent saves its widest launches, reloaded
    path = str(tmp_path / "inputs.pt")
    torch.save({spec: (st.fields(), p, base)
                for spec, (st, p, base) in ins.items()}, path)
    back = kt.saved_tree_inputs(tk, path, "cpu")
    for spec, (st, p, base) in ins.items():
        st2, p2, base2 = back[spec]
        assert all(torch.equal(v, getattr(st2, k))
                   for k, v in st.fields().items())
        assert torch.equal(p, p2) and (base is None) == (base2 is None)
