"""The port's SharedMatrix cell table (``device="cpu"``) against the JAX
package: the six cases of ``tests/test_matrix_kernel.py`` (LWW under random
batching, FWW, FWW against existing entries, a digest invariant to the
batch split, the sticky overflow, inert pads), each against the JAX
functions and the dict oracle, the prefix merge against the full merge on
the live region, and ``TensorMatrixStore`` snapshots, deltas and restores.

Contract (exact): after a prefix merge every plane, count and overflow
equal JAX's; after a full merge ``[0, count)`` of key / seq / value, the
whole key plane, count, overflow and the digest do (the JAX tail past
``count`` holds demoted losers in an unstable sort's order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import matrix_kernel as jmx
from fluidframework_tpu_torch.ops import matrix_kernel as tmx
from fluidframework_tpu_torch.testing.synthetic import cell_records

EMPTY = int(tmx.EMPTY_KEY)


def oracle_merge(records, fww=False):
    cells = {}
    for r, c, v, _ in records:  # seq ascending
        if fww and (r, c) in cells:
            continue
        cells[(r, c)] = v
    return cells


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def same_cells(js, ts, whole_planes):
    """JAX state ``js`` against the port's ``ts`` under the contract."""
    jk, tk = _np(js.key), _np(ts.key)
    assert np.array_equal(jk, tk)
    assert int(js.count) == int(ts.count)
    assert int(js.overflow) == int(ts.overflow)
    n = int(ts.count)
    for k in ("seq", "value"):
        a, b = _np(getattr(js, k)), _np(getattr(ts, k))
        assert np.array_equal(a if whole_planes else a[:n],
                              b if whole_planes else b[:n]), k
    assert int(jmx.matrix_cells_digest(js)) == \
        int(tmx.matrix_cells_digest(ts))


def _stores(capacity, batch):
    return (jmx.TensorMatrixStore(capacity=capacity, batch_size=batch),
            tmx.TensorMatrixStore(capacity=capacity, batch_size=batch,
                                  device="cpu"))


@pytest.mark.parametrize("seed", range(8))
def test_lww_random_batching_like_jax(seed):
    recs = cell_records(seed, 300)
    js, ts = _stores(512, 64)
    rng = np.random.default_rng(seed + 1)
    i = 0
    while i < len(recs):
        step = int(rng.integers(1, 91))
        for s in (js, ts):
            s.apply_batch(recs[i:i + step])
        # L reaches the capacity past 255 identities: full merges from then
        same_cells(js.state, ts.state, len(ts._cell_ids) < 256)
        i += step
    assert not ts.overflowed()
    assert ts.read_cells() == js.read_cells() == oracle_merge(recs)


@pytest.mark.parametrize("seed", [0, 3])
def test_fww_like_jax(seed):
    recs = cell_records(seed, 200, n_rows=6, n_cols=6)
    js, ts = _stores(256, 32)
    for s in (js, ts):
        s.switch_set_cell_policy()
        s.apply_batch(recs)
    same_cells(js.state, ts.state, True)
    assert ts.read_cells() == oracle_merge(recs, fww=True)


def test_fww_respects_existing_table_entries():
    js, ts = _stores(64, 8)
    for s in (js, ts):
        s.apply_batch([(0, 0, "first", 1)])     # LWW phase
        s.switch_set_cell_policy()
        s.apply_batch([(0, 0, "late", 5), (1, 1, "new", 6)])
        assert s.read_cells() == {(0, 0): "first", (1, 1): "new"}
    same_cells(js.state, ts.state, True)


def test_digest_invariant_to_batch_split():
    recs = cell_records(5, 256)
    digs = set()
    for bs in (16, 64, 256):
        js, ts = _stores(512, bs)
        for s in (js, ts):
            s.apply_batch(recs)
        digs |= {int(jmx.matrix_cells_digest(js.state)), ts.digest()}
    assert len(digs) == 1


@pytest.mark.parametrize("fww", [False, True])
def test_overflow_sticky_flag_both_modes(fww):
    keys, seqs = np.arange(8, dtype=np.int32), np.arange(1, 9, dtype=np.int32)
    vals = np.arange(8, dtype=np.int32)
    # full mode: 8 live cells into a table of 4
    js = jmx.apply_cells_batch(jmx.MatrixCellState.create(4),
                               *map(jnp.asarray, (keys, seqs, vals)), fww)
    ts = tmx.apply_cells_batch(tmx.MatrixCellState.create(4, "cpu"),
                               *map(torch.from_numpy, (keys, seqs, vals)),
                               fww)
    same_cells(js, ts, False)
    assert int(ts.overflow) == 1 and int(ts.count) == 4   # clamped
    # prefix mode: live = L + 1 sets the flag, the state past L untouched;
    # then a batch with room keeps it set (sticky)
    L = 8
    start_j = jmx.MatrixCellState.create(16)
    start_t = tmx.MatrixCellState.create(16, "cpu")
    b1 = (np.arange(L + 1, dtype=np.int32),
          np.arange(1, L + 2, dtype=np.int32),
          np.arange(L + 1, dtype=np.int32))
    b2 = (np.full(4, EMPTY, np.int32), np.zeros(4, np.int32),
          np.zeros(4, np.int32))
    for b in (b1, b2):
        start_j = jmx.apply_cells_prefix(start_j, *map(jnp.asarray, b), L,
                                         fww)
        start_t = tmx.apply_cells_prefix(start_t, *map(torch.from_numpy, b),
                                         L, fww)
        same_cells(start_j, start_t, True)
        assert int(start_t.overflow) == 1
    # exactly L live cells do not overflow
    exact = tmx.apply_cells_prefix(tmx.MatrixCellState.create(16, "cpu"),
                                   *(torch.from_numpy(x[:L]) for x in b1),
                                   L, fww)
    assert int(exact.overflow) == 0 and int(exact.count) == L


def test_empty_pads_are_inert():
    js, ts = _stores(32, 16)
    for s in (js, ts):
        s.apply_batch([(2, 3, "x", 1)])   # 15 pad rows ride along
        s.apply_batch([])                 # no-op
        assert s.read_cells() == {(2, 3): "x"}
        assert not s.overflowed()
    assert int(ts.state.count) == 1
    same_cells(js.state, ts.state, True)


@pytest.mark.parametrize("fww", [False, True])
def test_prefix_equals_full_on_the_live_region(fww):
    """Both merges of the same table and batches, duplicate keys inside a
    batch and a batch whose length is not a power of two included."""
    rng = np.random.default_rng(int(fww))
    T, L = 64, 32
    full = tmx.MatrixCellState.create(T, "cpu")
    pref = tmx.MatrixCellState.create(T, "cpu")
    seq0 = 1
    for O in (5, 16, 13):
        key = rng.integers(0, 24, O).astype(np.int32)
        key[: O // 3] = key[0]            # duplicates inside the batch
        seq = np.arange(seq0, seq0 + O, dtype=np.int32)
        val = rng.integers(0, 100, O).astype(np.int32)
        seq0 += O
        b = [torch.from_numpy(x) for x in (key, seq, val)]
        full = tmx.apply_cells_batch(full, *b, fww)
        pref = tmx.apply_cells_prefix(pref, *b, L, fww)
        n = int(full.count)
        assert n == int(pref.count) and not int(pref.overflow)
        for k in tmx.PLANES:
            assert torch.equal(getattr(full, k)[:n], getattr(pref, k)[:n])
            assert torch.equal(getattr(full, k)[n:], getattr(pref, k)[n:])
        if O == 5:
            first = (key, seq, val)
    # the first batch alone: both merges against JAX
    jb = [jnp.asarray(x) for x in first]
    tb = [torch.from_numpy(x) for x in first]
    same_cells(jmx.apply_cells_prefix(jmx.MatrixCellState.create(T), *jb,
                                      L, fww),
               tmx.apply_cells_prefix(tmx.MatrixCellState.create(T, "cpu"),
                                      *tb, L, fww), True)
    same_cells(jmx.apply_cells_batch(jmx.MatrixCellState.create(T), *jb,
                                     fww),
               tmx.apply_cells_batch(tmx.MatrixCellState.create(T, "cpu"),
                                     *tb, fww), False)


def test_fused_entry_point_is_in_place():
    st = tmx.MatrixCellState.create(16, "cpu")
    key_plane = st.key
    b = [torch.tensor(x, dtype=torch.int32)
         for x in ([3, 1, 3], [1, 2, 3], [7, 8, 9])]
    out = tmx.merge_cells_fused(st, *b, L=8)
    assert out is st and st.key is key_plane
    assert st.key[:2].tolist() == [1, 3] and st.value[:2].tolist() == [8, 9]


def _same_snapshot(a, b, whole_planes):
    assert np.array_equal(a["key"], b["key"])
    n = a["count"]
    for k in ("seq", "value"):
        assert np.array_equal(a[k] if whole_planes else a[k][:n],
                              b[k] if whole_planes else b[k][:n]), k
    for k in ("count", "overflow", "batch", "cell_ids", "values", "fww"):
        assert a[k] == b[k], k


def _as_lists(k):
    return [_as_lists(x) if isinstance(x, tuple) else x for x in k]


def test_store_snapshot_delta_restore_like_jax():
    js, ts = _stores(1024, 64)
    recs = cell_records(9, 400, n_rows=20, n_cols=20, n_values=30)
    rows = [r for r, _, _, _ in recs]
    cols = [c for _, c, _, _ in recs]
    vals = [int(v[1:]) for _, _, v, _ in recs]    # an int column
    seqs = [s for _, _, _, s in recs]
    for s in (js, ts):
        s.apply_batch_columnar(rows[:250], cols[:250], vals[:250],
                               seqs[:250])
    _same_snapshot(js.snapshot(), ts.snapshot(), True)
    bases = ts.table_bases()
    assert bases == js.table_bases()
    for s in (js, ts):
        s.apply_batch_columnar(rows[250:], cols[250:], vals[250:],
                               seqs[250:])
        s.switch_set_cell_policy()
        s.apply_batch([((99, "r"), ("c", 1), {"v": 1}, 1000)])
    jd, td = js.snapshot_delta(bases), ts.snapshot_delta(bases)
    for k in ("key", "seq", "value", "count", "overflow", "fww",
              "cell_ids_delta", "values_delta"):
        assert np.array_equal(jd[k], td[k]) if isinstance(jd[k], np.ndarray) \
            else jd[k] == td[k], k
    for cell in [(rows[0], cols[0]), (rows[-1], cols[-1]),
                 ((99, "r"), ("c", 1)), (123, 456)]:
        assert ts.read_cell(cell) == js.read_cell(cell)
    assert ts.read_cells() == js.read_cells()
    # a JAX snapshot restores into the port (identities come back as
    # lists through a JSON-like transport), a JAX delta folds onto it
    base = jmx.TensorMatrixStore.restore(js.snapshot())
    snap = js.snapshot()
    snap["cell_ids"] = [(_as_lists(k), v) for k, v in snap["cell_ids"]]
    back = tmx.TensorMatrixStore.from_jax_snapshot(snap, "cpu")
    assert back.read_cells() == js.read_cells()
    _same_snapshot(back.snapshot(), ts.snapshot(), True)
    old = tmx.TensorMatrixStore.restore(
        {**ts.snapshot(), "cell_ids": list(ts._cell_ids.items())[
            :bases["cell_ids"]]}, "cpu")
    old.apply_delta(jd)
    assert old.read_cells() == ts.read_cells()
    assert old.digest() == ts.digest() == \
        int(jmx.matrix_cells_digest(base.state))
    assert not np.shares_memory(back.state.key.numpy(), snap["key"])


def test_stress_harness_feeds_merges_as_the_store_does():
    """The card stress (``testing/cell_merge_stress.py``) interns cell ids
    in first-write order and picks L as ``TensorMatrixStore`` does; on the
    CPU every one of its merges agrees and every table stays sorted."""
    from fluidframework_tpu_torch.testing import cell_merge_stress as cs
    recs = cell_records(5, 300, n_rows=12, n_cols=9)
    store = tmx.TensorMatrixStore(capacity=256, batch_size=32, device="cpu")
    store.apply_batch(recs)
    raw = np.array([r * 9 + c for r, c, _, _ in recs], np.int32)
    want = [store._cell_ids[(r, c)] for r, c, _, _ in recs]
    assert cs.first_write_ids(raw).tolist() == want
    for n, L in ((0, 8), (7, 8), (8, 16), (100, 128), (255, None)):
        assert cs.prefix_L(n, 256) == L
    res = cs.run("cpu", seeds=2, grid=8, ops=32, batches=2, store_batch=8,
                 repeats=2)
    assert res["mismatches"] == 0, res["first_mismatches"]
    assert res["merges"]["prefix"] == res["merges"]["prefix-growing"] \
        == 2 * (2 * 32 + 32) // 8


# ------------------------------------------ the kernel's Python-side sizing

def test_cell_merge_scratch_and_tile_counts():
    """The wrapper's scratch sizing: 4 words a merge tile (2,048 merged
    positions), 4 meta words, the sorted batch once (O <= 4,096: one
    sort CTA, no merge pass) or twice, three output planes of Lt."""
    from fluidframework_tpu_torch.ops import cell_merge as cmk
    assert cmk.tiles(1, 0) == 1 and cmk.tiles(2048, 0) == 1
    assert cmk.tiles(2048, 1) == 2
    assert cmk.tiles(1 << 19, 4096) == 258
    assert cmk.tiles((1 << 20) + (1 << 16), 1 << 16) == 576
    assert cmk.scratch_words(100, 4096) == 4 * 3 + 4 + 3 * 4096 + 300
    assert cmk.scratch_words(100, 4097) == 4 * 3 + 4 + 6 * 4097 + 300


def test_restore_clears_free_slots_of_a_jax_full_merge():
    """A JAX full merge leaves demoted losers' seq / value past ``count``;
    restored into the port, free slots carry 0 / 0 (the kernel reads only
    the live extent and relies on that tail), and the contract with JAX
    (``[0, count)``, the key plane, count, overflow, digest) holds."""
    js = jmx.TensorMatrixStore(capacity=64, batch_size=256)
    recs = cell_records(2, 500, n_rows=6, n_cols=6, n_values=9)
    js.apply_batch(recs)
    snap = js.snapshot()
    n = snap["count"]
    assert (snap["key"][n:] == EMPTY).all() and snap["seq"][n:].any()
    back = tmx.TensorMatrixStore.restore(snap, "cpu")
    same_cells(js.state, back.state, whole_planes=False)
    assert not back.state.seq[n:].any() and not back.state.value[n:].any()
    # and it merges on as JAX does
    more = cell_records(3, 200, n_rows=6, n_cols=6, n_values=9, seq0=600)
    js.apply_batch(more)
    back.apply_batch(more)
    same_cells(js.state, back.state, whole_planes=False)


def test_timing_inputs_merge_like_jax():
    """``testing/kernel_timing.py``'s K2 inputs at a small grid (the store
    route's last chunk, the raw storm's last batch): the plain merge of
    each equals JAX's on the same state and batch."""
    from fluidframework_tpu_torch.testing import kernel_timing as kt
    from fluidframework_tpu_torch.testing import synthetic
    ins = kt.cell_inputs(tmx, synthetic, "cpu", grid=16, ops=96, batches=3,
                         chunk=32)
    assert ins["full"][2] is None and ins["prefix"][2] == 256
    for spec, (st, b, L) in ins.items():
        js = jmx.MatrixCellState(**{k: jnp.asarray(v.numpy())
                                    for k, v in st.fields().items()})
        jb = [jnp.asarray(x.numpy()) for x in b]
        if L is None:
            jout = jmx.apply_cells_batch_jit(js, *jb)
            tout = tmx.apply_cells_batch(st, *b)
        else:
            jout = jmx.apply_cells_prefix_jit(js, *jb, L)
            tout = tmx.apply_cells_prefix(st, *b, L)
        same_cells(jout, tout, whole_planes=L is not None)
