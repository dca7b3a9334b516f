"""The port's mega-doc apply / compact / digest / rebalance against the JAX
package's on the virtual 8-device CPU mesh, bit for bit.

Mirrors ``tests/test_megadoc.py``'s cases. Inputs are made with numpy from
a seed (or from an oracle stream) and handed to both packages; after
every step the FULL (D, 8·S_local) planes agree (slots past ``count``
included), with ``count`` and ``overflow`` (D, 8). Tolerance: exact
(everything is int32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import megadoc_kernel as jmk
from fluidframework_tpu.ops.merge_tree_kernel import (
    StringState as JState, apply_string_batch as japply,
)
from fluidframework_tpu.testing.synthetic import typing_storm
from fluidframework_tpu_torch.ops import megadoc_kernel as tmk
from fluidframework_tpu_torch.ops import merge_tree as tmt
from tests.test_megadoc import _planes_from_msgs
from tests.test_merge_tree_kernel import collab_stream

ORDER = ("kind", "a0", "a1", "a2", "seq", "client", "ref_seq")
N = 8


@pytest.fixture(scope="module")
def mesh():
    return jmk.make_megadoc_mesh(N)


def _ops(n_docs, n_ops, seed=0, start_seq=1):
    planes, next_seq = typing_storm(n_docs, n_ops, seed=seed,
                                    start_seq=start_seq)
    return tuple(np.asarray(planes[k], np.int32) for k in ORDER), next_seq


def _apply(mesh, js, ts, ops):
    """One batch through both packages (the port's dispatch on CPU
    tensors: in place)."""
    js = jmk.apply_megadoc_batch(mesh, js, *(jnp.asarray(p) for p in ops))
    out = tmk.apply_megadoc_batch(ts, *(torch.from_numpy(p) for p in ops))
    assert out is ts
    return js, ts


def _assert_same(js, ts):
    for k in tmt.FIELDS:
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        assert a.shape == b.shape, k
        assert np.array_equal(a, b), k


def _assert_digest(mesh, js, ts):
    assert np.array_equal(np.asarray(jmk.megadoc_digest(mesh, js)),
                          tmk.megadoc_digest(ts).numpy())


def _pair(mesh, n_docs, cap):
    return (jmk.create_megadoc_state(mesh, n_docs, cap),
            tmk.create_megadoc_state(n_docs, cap, n_shards=N, device="cpu"))


def test_megadoc_matches_jax_and_single_device(mesh):
    n_docs, cap = 3, 64
    ops, _ = _ops(n_docs, 24)
    js, ts = _apply(mesh, *_pair(mesh, n_docs, cap), ops)
    _assert_same(js, ts)
    _assert_digest(mesh, js, ts)
    assert not ts.overflow.any()
    flat = tmt.apply_string_batch(
        tmt.StringState.create(n_docs, N * cap, device="cpu"),
        *(torch.from_numpy(p) for p in ops))
    assert np.array_equal(tmk.megadoc_digest(ts).numpy(),
                          tmt.string_state_digest(flat).numpy())
    assert tmk.visible_runs(ts) == tmk.visible_runs(flat) \
        == jmk.visible_runs(js)


def test_megadoc_multiple_rounds_threads_state(mesh):
    js, ts = _pair(mesh, 2, 64)
    seq = 1
    for r in range(3):
        ops, seq = _ops(2, 12, seed=r, start_seq=seq)
        js, ts = _apply(mesh, js, ts, ops)
        _assert_same(js, ts)
        _assert_digest(mesh, js, ts)


def test_megadoc_compaction_matches(mesh):
    n_docs = 2
    ops, next_seq = _ops(n_docs, 32)
    js, ts = _apply(mesh, *_pair(mesh, n_docs, 64), ops)
    min_seq = np.full((n_docs,), next_seq - 1, np.int32)
    js = jmk.compact_megadoc(mesh, js, min_seq)
    ts = tmk.compact_megadoc(ts, torch.from_numpy(min_seq))
    _assert_same(js, ts)
    _assert_digest(mesh, js, ts)
    # stale slots past count left by the compaction must not leak
    ops2, _ = _ops(n_docs, 8, seed=9, start_seq=next_seq)
    js, ts = _apply(mesh, js, ts, ops2)
    _assert_same(js, ts)
    _assert_digest(mesh, js, ts)
    assert tmk.visible_runs(ts) == jmk.visible_runs(js)


def test_megadoc_rebalance_matches(mesh):
    js, ts = _pair(mesh, 2, 16)
    seq = 1
    for r in range(5):
        ops, seq = _ops(2, 6, seed=r, start_seq=seq)
        js, ts = _apply(mesh, js, ts, ops)
        _assert_same(js, ts)
        js = jmk.rebalance_megadoc(mesh, js)
        ts = tmk.rebalance_megadoc(ts)
        _assert_same(js, ts)
        counts = ts.count.numpy()
        assert (counts.max(axis=1) - counts.min(axis=1) <= 1).all()
        _assert_digest(mesh, js, ts)


def test_megadoc_overflow_flag_matches(mesh):
    ops, _ = _ops(1, 64)
    js, ts = _apply(mesh, *_pair(mesh, 1, 4), ops)
    _assert_same(js, ts)
    assert ts.overflow.any()
    assert (ts.count.numpy() <= 4).all()


@pytest.mark.parametrize("seed", range(6))
def test_megadoc_multiclient_fuzz_matches(mesh, seed):
    _, _, msgs = collab_stream(seed, n_rounds=10, with_annotates=True)
    ops = tuple(np.array(p, np.int32) for p in _planes_from_msgs(msgs))
    js, ts = _apply(mesh, *_pair(mesh, 1, 128), ops)
    assert not ts.overflow.any()
    _assert_same(js, ts)
    single = japply(JState.create(1, 1024), *(jnp.asarray(p) for p in ops))
    assert tmk.visible_runs(ts) == jmk.visible_runs(single)


def test_megadoc_boundary_insert_orders_before_invisible_concurrent(mesh):
    """A later-sequenced insert at a shard boundary lands LEFT of an
    earlier concurrent insert held by the earlier shard, even when that
    shard's perspective-visible length is zero."""
    from fluidframework_tpu_torch.ops.schema import OpKind
    I, R = int(OpKind.STR_INSERT), int(OpKind.STR_REMOVE)
    recs = [(I, 0, 2, 10, 1, 0, 0), (R, 0, 2, 0, 2, 1, 1),
            (I, 0, 3, 11, 3, 2, 1), (I, 0, 4, 12, 4, 3, 2)]
    planes = np.zeros((7, 1, 4), np.int32)
    for j, r in enumerate(recs):
        planes[:, 0, j] = r
    js, ts = _apply(mesh, *_pair(mesh, 1, 8), tuple(p[:, :1] for p in planes))
    js = jmk.rebalance_megadoc(mesh, js)
    ts = tmk.rebalance_megadoc(ts)
    assert int(ts.count[0, 0]) == 1  # Y lives on shard 0
    js, ts = _apply(mesh, js, ts, tuple(np.ascontiguousarray(p[:, 1:])
                                        for p in planes))
    _assert_same(js, ts)
    runs = tmk.visible_runs(ts)
    assert runs == jmk.visible_runs(js)
    assert [r[0] for r in runs[0]] == [12, 11]  # L before E


def test_megadoc_rebalance_refuses_overflowed_state(mesh):
    ops, _ = _ops(1, 64)
    _, ts = _apply(mesh, *_pair(mesh, 1, 4), ops)
    assert ts.overflow.any()
    with pytest.raises(ValueError, match="overflow"):
        tmk.rebalance_megadoc(ts)


def test_megadoc_entry_points_refuse_a_mesh():
    from fluidframework_tpu_torch.ops.megadoc_store import (
        MegaDocStringStore,
    )
    with pytest.raises(ValueError, match="B9"):
        tmk.create_megadoc_state(1, 8, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="B9"):
        MegaDocStringStore(1, 8, device="cpu", mesh=object())
    snap = MegaDocStringStore(1, 8, device="cpu").snapshot()
    with pytest.raises(ValueError, match="B9"):
        MegaDocStringStore.restore(snap, device="cpu", mesh=object())


def test_megadoc_storm_windows_match_jax(mesh):
    """``chip_smoke.py``'s megadoc kernel loop at a small size: windows of
    ``megadoc_storm`` (typing and conflict docs) with the phase's
    rebalance rule, through both packages."""
    from fluidframework_tpu_torch.testing import kernel_timing as kt
    from fluidframework_tpu_torch.testing import synthetic
    js, ts = _pair(mesh, 4, 16)
    for planes in kt.megadoc_windows(synthetic, D=4, O=4, windows=6):
        new = kt.megadoc_rebalance(tmk, ts, S=16)
        if new is not ts:
            ts, js = new, jmk.rebalance_megadoc(mesh, js)
        js, ts = _apply(mesh, js, ts, tuple(planes[k] for k in ORDER))
        _assert_same(js, ts)
    assert int(ts.count.sum()) > 0
    _assert_digest(mesh, js, ts)


def test_megadoc_tail_slides_by_the_count_growth(mesh):
    """The identity K7's deferred tail write-back rests on: after a launch,
    slot t >= count_end of every (doc, shard) holds the launch's input
    slot t - Δ (Δ = count_end - count_start), whatever the tail holds —
    here random non-default values in every plane past count. The port's
    plain version and JAX's apply_megadoc_batch agree on every slot."""
    from jax.sharding import NamedSharding
    S, D = 32, 2
    js, ts = _pair(mesh, D, S)
    ops, seq = _ops(D, 12)
    js, ts = _apply(mesh, js, ts, ops)
    js, ts = jmk.rebalance_megadoc(mesh, js), tmk.rebalance_megadoc(ts)
    rng = np.random.default_rng(5)
    count = ts.count.numpy()
    arrays = {k: getattr(ts, k).numpy().copy() for k in tmt.FIELDS}
    for k in tmt.PLANES + ("prop_val",):
        for d in range(D):
            for s in range(N):
                tail = arrays[k][d, s * S + count[d, s]:(s + 1) * S]
                tail[...] = rng.integers(-2 ** 31, 2 ** 31, tail.shape,
                                         dtype=np.int64).astype(np.int32)
    ts = tmt.StringState(**{k: torch.from_numpy(v.copy())
                            for k, v in arrays.items()})
    js = JState(**{k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, jmk.STATE_SPECS[k])) for k, v in arrays.items()})
    ops, _ = _ops(D, 16, seed=3, start_seq=seq)
    js, ts = _apply(mesh, js, ts, ops)
    _assert_same(js, ts)
    end = ts.count.numpy()
    assert (end > count).any()
    for k in tmt.PLANES + ("prop_val",):
        after = getattr(ts, k).numpy()
        for d in range(D):
            for s in range(N):
                delta = end[d, s] - count[d, s]
                t = np.arange(s * S + end[d, s], (s + 1) * S)
                assert np.array_equal(after[d, t], arrays[k][d, t - delta]), \
                    (k, d, s)
