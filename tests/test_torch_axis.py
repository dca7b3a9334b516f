"""The port's permutation axes (``device="cpu"``) against the JAX package:
the plain ``apply_axis_batch``, ``resolve_axis_positions`` and
``axis_visible_lengths`` against ``fluidframework_tpu/ops/axis_kernel.py``
on seeded windows from 4 clients with stale ref_seqs (dropped inserts,
out-of-range resolves, removes over splits, overflow at a tiny S), the
in-place entry points, and ``TensorAxisStore`` compaction, snapshots and
restores (a JAX snapshot restored into the port). Tolerance: exact —
every plane bit-identical, slots past ``count`` included, outputs
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import axis_kernel as jak
from fluidframework_tpu.ops.merge_tree_kernel import StringState as JState
from fluidframework_tpu_torch.ops import axis_kernel as tak
from fluidframework_tpu_torch.ops import merge_tree as mt
from fluidframework_tpu_torch.ops.schema import OpKind
from fluidframework_tpu_torch.testing.synthetic import axis_window

INS, REM, RES, NOOP = (int(OpKind.STR_INSERT), int(OpKind.STR_REMOVE),
                       int(OpKind.AXIS_RESOLVE), int(OpKind.NOOP))
FIELDS = mt.PLANES + ("count", "overflow")


def _same_state(js, ts, tag=""):
    for k in FIELDS:
        assert np.array_equal(np.asarray(getattr(js, k)),
                              getattr(ts, k).numpy()), (tag, k)


def _both(planes):
    return ([jnp.asarray(planes[k]) for k in mt.OP_FIELDS],
            [torch.as_tensor(planes[k]) for k in mt.OP_FIELDS])


def _chain(D, S, O, seed, n_batches=3, mix=(0.4, 0.2, 0.3, 0.1)):
    """Chained windows through both packages; yields after every batch."""
    rng = np.random.default_rng(seed)
    js = JState.create(D, S, n_props=1)
    ts = mt.StringState.create(D, S, n_props=1, device="cpu")
    seq = 1
    for b in range(n_batches):
        lengths = tak.axis_visible_lengths(ts).numpy()
        planes, seq = axis_window(rng, lengths, O, seq, mix=mix)
        jo, to = _both(planes)
        js, jh, jf = jak.apply_axis_batch_jit(js, *jo)
        ts, th, tf = tak.apply_axis_batch(ts, *to)
        yield b, planes, js, ts, (jh, jf), (th, tf)


@pytest.mark.parametrize("S,seed", [(64, 0), (64, 1), (8, 2)])
def test_apply_axis_batch_matches_jax(S, seed):
    """Random windows; S=8 overflows most rows (sticky, rows untouched)."""
    out_of_range = 0
    for b, planes, js, ts, (jh, jf), (th, tf) in _chain(6, S, 24, seed):
        _same_state(js, ts, b)
        assert np.array_equal(np.asarray(jh), th.numpy())
        assert np.array_equal(np.asarray(jf), tf.numpy())
        res = planes["kind"] == RES
        out_of_range += int((th.numpy()[res] < 0).sum())
        assert (th.numpy()[~res] == -1).all()
    assert out_of_range > 0
    if S == 8:
        assert ts.overflow.numpy().any()


def _window(rows):
    """Dense planes from per-row op lists (NOOP padded)."""
    O = max(len(r) for r in rows)
    planes = {k: np.zeros((len(rows), O), np.int32) for k in mt.OP_FIELDS}
    planes["kind"][:] = NOOP
    for d, ops in enumerate(rows):
        for o, op in enumerate(ops):
            for k, v in zip(mt.OP_FIELDS, op):
                planes[k][d, o] = v
    return planes


def test_edges_match_jax_and_the_oracle_rules():
    """Inserts at pos == total (kept) and past it (dropped); resolves at
    the last visible position and one past it (-1); a remove spanning
    splits; a resolve sees the ops before it in its window, never after;
    client -1 reads; handle_off accumulates across splits."""
    READ = 1 << 30
    rows = [
        [(INS, 0, 3, 11, 1, 0, 0),        # "aaa"            len 3
         (INS, 3, 2, 12, 2, 0, 1),        # pos == total: kept, len 5
         (INS, 7, 1, 13, 3, 0, 2),        # pos 7 > total 5: dropped
         (RES, 4, 0, 0, 4, -1, READ),     # last visible: run 12, off 1
         (RES, 5, 0, 0, 5, -1, READ),     # one past: -1
         (REM, 1, 4, 0, 6, 1, 5),         # splits at 1 and 4
         (RES, 1, 0, 0, 7, 1, 6),         # after the remove: run 12, off 1
         (INS, 1, 2, 14, 8, 0, 3),        # stale ref: sees the removed
         (RES, 2, 0, 0, 9, 0, 8)],
        [(RES, 0, 0, 0, 1, 0, 0),         # empty row: -1
         (INS, 0, 4, 21, 2, 2, 1),
         (INS, 1, 1, 23, 3, 3, 1),        # run 21 unseen at ref 1: dropped
         (INS, 2, 4, 22, 4, 3, 2),        # splits run 21 at 2
         (RES, 6, 0, 0, 4, -1, READ),     # right piece: (21, 2 + 0)
         (REM, 0, 8, 0, 5, 2, 4),
         (RES, 0, 0, 0, 6, 3, 4),         # client 3 at ref 4: not removed
         (RES, 0, 0, 0, 7, -1, READ)],    # everything removed: -1
    ]
    planes = _window(rows)
    jo, to = _both(planes)
    js, jh, jf = jak.apply_axis_batch_jit(JState.create(2, 16, n_props=1),
                                          *jo)
    ts, th, tf = tak.apply_axis_batch(
        mt.StringState.create(2, 16, n_props=1, device="cpu"), *to)
    _same_state(js, ts)
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    h, f = th.numpy(), tf.numpy()
    assert (h[0, 3], f[0, 3]) == (12, 1)
    assert (h[0, 4], f[0, 4]) == (-1, -1)
    assert (h[0, 6], f[0, 6]) == (12, 1)
    assert (h[1, 0], f[1, 0]) == (-1, -1)
    assert (h[1, 4], f[1, 4]) == (21, 2)
    assert (h[1, 6], f[1, 6]) == (21, 0) and h[1, 7] == -1
    assert int(ts.count[1]) == 3
    assert int(ts.overflow.sum()) == 0


def test_resolve_axis_positions_and_lengths_match_jax():
    D, S, O = 6, 64, 24
    *_, js, ts, _, _ = list(_chain(D, S, O, seed=5))[-1]
    rng = np.random.default_rng(6)
    lengths = tak.axis_visible_lengths(ts).numpy()
    assert np.array_equal(np.asarray(jak.axis_visible_lengths(js)), lengths)
    pos = (rng.random((D, 40)) * (lengths[:, None] + 3)).astype(np.int32)
    client = rng.integers(-1, 4, size=(D, 40)).astype(np.int32)
    ref = rng.integers(0, 3 * O, size=(D, 40)).astype(np.int32)
    ref[client < 0] = 1 << 30
    jh, jf = jak.resolve_axis_positions(js, *(jnp.asarray(x) for x in
                                              (pos, client, ref)))
    th, tf = tak.resolve_axis_positions(ts, *(torch.as_tensor(x) for x in
                                              (pos, client, ref)))
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert (th.numpy() >= 0).any() and (th.numpy() < 0).any()
    # the op axis in chunks (as on the card) gives the same planes
    old = tak._RESOLVE_CHUNK
    tak._RESOLVE_CHUNK = D * S * 7
    try:
        ch, cf = tak.resolve_axis_positions(ts, *(torch.as_tensor(x) for x
                                                  in (pos, client, ref)))
    finally:
        tak._RESOLVE_CHUNK = old
    assert torch.equal(ch, th) and torch.equal(cf, tf)


def test_fused_entry_points_run_the_plain_versions_in_place():
    D, S, O = 4, 32, 16
    rng = np.random.default_rng(9)
    st = mt.StringState.create(D, S, n_props=1, device="cpu")
    planes, _ = axis_window(rng, np.zeros(D), O)
    ops = [torch.as_tensor(planes[k]) for k in mt.OP_FIELDS]
    ref, rh, ro = tak.apply_axis_batch(st, *ops)
    seq_plane = st.seq
    fh, fo = tak.apply_axis_batch_fused(st, *ops)
    assert st.seq is seq_plane   # in place
    for k in FIELDS:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    assert torch.equal(fh, rh) and torch.equal(fo, ro)
    kind = torch.as_tensor(planes["kind"])
    a0, cl, rs = ops[1], ops[5], ops[6]
    h, f = tak.resolve_axis_fused(st, kind, a0, cl, rs)
    ph, pf = tak.resolve_axis_positions(st, a0, cl, rs)
    res = kind == RES
    assert torch.equal(h[res], ph[res]) and (h[~res] == -1).all()
    assert torch.equal(f[res], pf[res]) and (f[~res] == -1).all()


def _same_snapshot(a, b):
    assert set(a) == set(b)
    for k in a["planes"]:
        assert np.array_equal(np.asarray(a["planes"][k]),
                              np.asarray(b["planes"][k])), k
    for k in ("count", "overflow"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert [tuple(r) for r in a["runs"]] == [tuple(r) for r in b["runs"]]
    assert a["client_idx"] == b["client_idx"]
    assert a["capacity"] == b["capacity"]


def test_store_compact_snapshot_rows_restore_like_jax():
    """Both stores fed the same windows: compaction at a floor, full and
    row snapshots, a delta folded into a restored base, and the JAX
    store's snapshot restored into the port."""
    n_docs, S, O = 3, 64, 16
    rng = np.random.default_rng(21)
    j = jak.TensorAxisStore(n_docs, S)
    t = tak.TensorAxisStore(n_docs, S, device="cpu")
    for store in (j, t):
        for r in range(2 * n_docs):
            for c in (5, 9, 11):
                store.client(r, c)
        for m in range(40):
            store.run_handle(7 + m, m % 3)
    seq = 1
    base_snap = None
    for b in range(3):
        planes, seq = axis_window(rng, t.visible_lengths(), O, seq)
        assert all(np.array_equal(x, y) for x, y in
                   zip(j.apply(planes), t.apply(planes)))
        ms = np.full(2 * n_docs, max(seq - 20, 0), np.int32)
        j.compact(ms)
        t.compact(ms)
        cnt = t.state.count.numpy()
        assert np.array_equal(np.asarray(j.state.count), cnt)
        for k in mt.PLANES:   # after a compaction: [0, count)
            a = np.asarray(getattr(j.state, k))
            c = getattr(t.state, k).numpy()
            for d in range(2 * n_docs):
                assert np.array_equal(a[d, :cnt[d]], c[d, :cnt[d]]), k
        assert np.array_equal(np.asarray(jak.axis_visible_lengths(j.state)),
                              t.visible_lengths())
        if b == 0:
            base_snap = t.snapshot()
            runs_base = len(t._runs)
            _same_snapshot(j.snapshot(), base_snap)
    t.run_handle(999, 1)
    j.run_handle(999, 1)
    rows = [1, 4, 5]
    jd, td = j.snapshot_rows(rows, runs_base), t.snapshot_rows(rows,
                                                               runs_base)
    for k in jd["planes"]:
        assert np.array_equal(np.asarray(jd["planes"][k]), td["planes"][k])
    assert jd["runs_delta"] == td["runs_delta"]
    assert jd["client_idx"] == td["client_idx"]
    # restored base + the dirty rows' delta: those rows equal the live
    # (after a compaction only [0, count) is specified)
    back = tak.TensorAxisStore.restore(base_snap, device="cpu")
    back.apply_row_snapshot(td)
    for k in ("count", "overflow"):
        assert torch.equal(getattr(back.state, k)[rows],
                           getattr(t.state, k)[rows]), k
    for r in rows:
        n = int(t.state.count[r])
        for k in mt.PLANES:
            assert torch.equal(getattr(back.state, k)[r, :n],
                               getattr(t.state, k)[r, :n]), (r, k)
    assert back._runs == t._runs
    # a JAX snapshot restored into the port equals the port's own store
    from_j = tak.TensorAxisStore.restore(j.snapshot(), device="cpu")
    _same_snapshot(from_j.snapshot(), t.snapshot())
    assert from_j.run_handle(999, 1) == t.run_handle(999, 1)


def test_store_client_capacity_and_resolve_only_window():
    t = tak.TensorAxisStore(1, 32, device="cpu")
    for c in range(32):
        assert t.client(0, 100 + c) == c
    with pytest.raises(KeyError, match="client capacity"):
        t.client(0, 999)
    assert t.client(1, 999) == 0   # capacity is per axis row
    j = jak.TensorAxisStore(1, 32)
    planes = _window([[(INS, 0, 4, t.run_handle(1, 0), 1, 0, 0)],
                      [(INS, 0, 2, t.run_handle(2, 0), 2, 0, 0)]])
    j.run_handle(1, 0), j.run_handle(2, 0)
    for s in (j, t):
        s.apply(planes)
    # a window of resolves and NOOPs only (the K4 branch on the card)
    reads = _window([[(RES, p, 0, 0, 0, -1, 1 << 30) for p in range(6)],
                     [(NOOP, 0, 0, 0, 0, 0, 0), (RES, 1, 0, 0, 0, -1,
                                                 1 << 30)]])
    jh, jf = j.apply(reads)
    th, tf = t.apply(reads)
    assert np.array_equal(jh, th) and np.array_equal(jf, tf)
    assert th[0].tolist() == [1, 1, 1, 1, -1, -1]
    assert tf[0, :4].tolist() == [0, 1, 2, 3]
    assert th[1, :2].tolist() == [-1, 2] and tf[1, 1] == 1
    pend = t.resolve_async(reads)
    rh, ro = pend.result()
    assert np.array_equal(rh, th) and np.array_equal(ro, tf)


def test_mesh_is_refused():
    """Anything but a 1-D docs mesh is refused (tests/test_torch_mesh.py
    drives the sharded store)."""
    with pytest.raises(ValueError, match="docs"):
        tak.TensorAxisStore(2, device="cpu", mesh=object())
