"""The port's ``TensorTreeStore(device="cpu")`` against the SharedTree
oracle and the JAX store on ``tests/test_tree_kernel.py``'s
``tree_session`` corpora (12 seeds, many small apply calls, many docs in
one batch): ``to_dict`` equals the oracle's, and all eight planes and the
overflow flags equal the JAX store's. Also: the tree wire's encoders and
decoders give the JAX package's arrays and tables, ``pack_wire_records``
its buffers, ``from_jax_snapshot`` continues in step with the JAX store,
row snapshots and deltas cross between the packages, and the prepacked
wire path equals the dense one. Tolerance: exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops.tree_store import (
    TensorTreeStore as JStore, pack_wire_records as j_pack,
)
from fluidframework_tpu.server import tree_wire as jw
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.ops.tree_store import (
    TensorTreeStore as TStore, pack_wire_records as t_pack,
)
from fluidframework_tpu_torch.server import tree_wire as tw
from fluidframework_tpu_torch.testing.synthetic import tree_op_storm

from tests.test_tree_kernel import tree_session
from tests.test_tree_records import ALL_KINDS_OPS

ALL = tk.TREE_PLANES + ("overflow",)


def _same_planes(j: JStore, t: TStore):
    for k in ALL:
        a = np.asarray(getattr(j.state, k))
        b = getattr(t.state, k).numpy()
        assert np.array_equal(a, b), (k, np.argwhere(a != b)[:4])


@pytest.mark.parametrize("seed", range(12))
def test_store_matches_oracle_and_jax(seed):
    want, msgs = tree_session(seed)
    t = TStore(n_docs=2, capacity=512, device="cpu")
    t.apply_messages((1, m) for m in msgs)   # doc 1; doc 0 stays empty
    assert not t.overflowed().any()
    assert t.to_dict(1) == want
    assert t.to_dict(0) == {"id": "root", "type": None, "value": None}
    j = JStore(n_docs=2, capacity=512)
    j.apply_messages((1, m) for m in msgs)
    _same_planes(j, t)
    assert np.array_equal(j.digests(), t.digests())


@pytest.mark.parametrize("seed", [30, 31])
def test_store_incremental_batches(seed):
    want, msgs = tree_session(seed, n_rounds=10)
    t = TStore(n_docs=1, capacity=512, device="cpu")
    j = JStore(n_docs=1, capacity=512)
    rng = random.Random(seed)
    i = 0
    while i < len(msgs):
        step = rng.randint(1, 5)
        t.apply_messages((0, m) for m in msgs[i:i + step])
        j.apply_messages((0, m) for m in msgs[i:i + step])
        i += step
    assert t.to_dict(0) == want
    _same_planes(j, t)


def test_store_many_docs_parallel():
    sessions = [tree_session(s, n_rounds=8) for s in range(4)]
    interleaved = []
    idx = [0] * 4
    rng = random.Random(0)
    while any(idx[d] < len(sessions[d][1]) for d in range(4)):
        d = rng.randrange(4)
        if idx[d] < len(sessions[d][1]):
            interleaved.append((d, sessions[d][1][idx[d]]))
            idx[d] += 1
    t = TStore(n_docs=4, capacity=512, device="cpu")
    j = JStore(n_docs=4, capacity=512)
    t.apply_messages(interleaved)
    j.apply_messages(interleaved)
    for d in range(4):
        assert t.to_dict(d) == sessions[d][0], f"doc {d}"
    _same_planes(j, t)


def test_store_overflow_is_sticky_like_jax():
    _, msgs = tree_session(3)
    t = TStore(n_docs=1, capacity=8, device="cpu")
    j = JStore(n_docs=1, capacity=8)
    t.apply_messages((0, m) for m in msgs)
    j.apply_messages((0, m) for m in msgs)
    assert t.overflowed()[0]
    _same_planes(j, t)


def _batch_equal(a, b):
    return (np.array_equal(np.asarray(a["rec_op"]), np.asarray(b["rec_op"]))
            and np.array_equal(np.asarray(a["recs"]), np.asarray(b["recs"]))
            and all(list(a[k]) == list(b[k])
                    for k in ("ids", "fields", "types", "values")))


@pytest.mark.parametrize("seed", range(3))
def test_tree_wire_encoders_and_decoders_match_jax(seed):
    ops = [op for _d, op in tree_op_storm(["a", "b"], 12, seed=seed)]
    ops += ALL_KINDS_OPS
    for enc_j in (jw.TreeBatchEncoder, jw.ReferenceTreeBatchEncoder):
        et, ej = tw.TreeBatchEncoder(), enc_j()
        for op in ops:
            assert et.add(op) == ej.add(op)
        bt, bj = et.batch(), ej.batch()
        assert _batch_equal(bt, bj)
    bt = tw.encode_tree_batch(ops)
    assert _batch_equal(bt, jw.encode_tree_batch(ops))
    args = (bt["rec_op"], bt["recs"], bt["ids"], bt["fields"], bt["types"],
            bt["values"])
    got = tw.decode_records(*args)
    assert got == jw.decode_records(*args)
    assert got == [jw.decode_op(bt["recs"][bt["rec_op"] == i], *args[2:])
                   for i in range(len(ops))]
    n = 40
    leaf = (["root"] * n, ["kids"] * n, [f"#{(1 << 20) + i}" for i in
                                         range(n)],
            list(range(n)), [None, "t"] * (n // 2),
            [None] + [f"#{(1 << 20) + i}" for i in range(n - 1)])
    assert _batch_equal(tw.encode_leaf_records(*leaf),
                        jw.encode_leaf_records(*leaf))


@pytest.mark.parametrize("width", [np.uint16, np.uint32])
def test_pack_wire_records_matches_jax(width):
    bt = tw.encode_tree_batch([op for _d, op in tree_op_storm(
        ["a", "b", "c"], 10, seed=4)])
    rows = np.array([0, 1, 2] * 10, np.int64)[bt["rec_op"]]
    for floor in (1, 256):
        a = t_pack(bt["recs"], bt["rec_op"], rows, r_floor=floor,
                   id_t=width, val_t=width)
        b = j_pack(bt["recs"], bt["rec_op"], rows, r_floor=floor,
                   id_t=width, val_t=width)
        assert a[5] == b[5]
        for x, y in zip(a[:5], b[:5]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_from_jax_snapshot_continues_in_step():
    _, msgs = tree_session(5)
    half = len(msgs) // 2
    j = JStore(n_docs=2, capacity=256)
    j.apply_messages((1, m) for m in msgs[:half])
    t = TStore.from_jax_snapshot(j.snapshot(), device="cpu")
    _same_planes(j, t)
    j.apply_messages((1, m) for m in msgs[half:])
    t.apply_messages((1, m) for m in msgs[half:])
    _same_planes(j, t)
    assert t.to_dict(1) == j.to_dict(1)
    assert t.snapshot()["ids"] == j.snapshot()["ids"]


def test_row_snapshots_cross_packages():
    """A JAX ``snapshot_rows`` delta folds into a port store restored
    from the same base, and the port's own delta likewise."""
    _, msgs = tree_session(6)
    half = len(msgs) // 2
    j = JStore(n_docs=3, capacity=256)
    j.apply_messages((1, m) for m in msgs[:half])
    base = j.snapshot()
    bases = j.interner_bases()
    t = TStore.restore(base, device="cpu")
    j.apply_messages((2, m) for m in msgs[half:])
    t.apply_messages((2, m) for m in msgs[half:])
    jd = j.snapshot_rows([2], bases)
    td = t.snapshot_rows([2], bases)
    for k in tk.TREE_PLANES:
        assert np.array_equal(jd["planes"][k], td["planes"][k]), k
    assert jd["ids_delta"] == td["ids_delta"]
    for delta in (jd, td):
        r = TStore.restore(base, device="cpu")
        r.apply_row_snapshot(delta)
        _same_planes(j, r)
        assert r.to_dict(2) == j.to_dict(2)


def test_prepacked_wire_equals_dense_and_reuses_pools():
    """The pooled wire path (stale buffer tails included) gives the dense
    planes' state; a released buffer set is handed out again."""
    docs = [f"d{i}" for i in range(6)]
    waves = [tree_op_storm(docs, 6, seed=s) for s in range(3)]
    dense = TStore(n_docs=6, capacity=128, device="cpu")
    wire = TStore(n_docs=6, capacity=128, device="cpu")
    loose = tk.TreeState.create(6, 128, device="cpu")   # unpooled buffers
    seq = {d: 0 for d in docs}
    for wave in waves:
        ops = [op for _d, op in wave]
        rows = np.array([docs.index(d) for d, _ in wave], np.int64)
        batch = tw.encode_tree_batch(ops)
        seqs = []
        for d, _ in wave:
            seq[d] += 1
            seqs.append(seq[d])
        seqs = np.array(seqs, np.int64)
        g = _map(dense, batch)
        dense.apply_records(rows[batch["rec_op"]], g,
                            seqs[batch["rec_op"]])
        pp = wire.prepack_wire(batch["recs"], batch["rec_op"],
                               rows[batch["rec_op"]], batch)
        base = np.zeros(6, np.int32)
        for i, (d, _) in enumerate(wave):
            r = docs.index(d)
            if base[r] == 0:
                base[r] = seqs[i]
        key = pp.wire.key
        wire.apply_wire_prepacked(pp, base)
        assert pp.wire in wire._wire_pool[key]
        packed = t_pack(batch["recs"], batch["rec_op"],
                        rows[batch["rec_op"]])
        loose = tk.apply_tree_wire(
            loose, *(torch.from_numpy(a) for a in packed[:5]),
            torch.from_numpy(base), *pp.maps, o=packed[5])
    for k in ALL:
        assert torch.equal(getattr(dense.state, k), getattr(wire.state, k))
        assert torch.equal(getattr(dense.state, k), getattr(loose, k))
    for d in range(6):
        assert dense.to_dict(d) == wire.to_dict(d)


def _map(store, batch):
    maps = [np.r_[0, it.bulk(batch[k])].astype(np.int32) if batch[k]
            else np.zeros(1, np.int32)
            for k, it in (("ids", store._ids), ("fields", store._fields),
                          ("types", store._types), ("values",
                                                    store._values))]
    recs = batch["recs"].copy()
    for col, m in ((1, 0), (2, 0), (3, 0), (4, 1), (5, 3), (6, 2)):
        recs[:, col] = maps[m][recs[:, col]]
    return recs


def test_repack_adopt_and_clear():
    _, msgs = tree_session(8)
    big = TStore(n_docs=1, capacity=512, device="cpu")
    big.apply_messages((0, m) for m in msgs)
    j = JStore(n_docs=1, capacity=512)
    j.apply_messages((0, m) for m in msgs)
    big.repack()
    j.repack()
    _same_planes(j, big)
    small = TStore(n_docs=3, capacity=256, device="cpu")
    small.share_interners(big)   # handles in big mean the same here
    small.adopt_doc(2, big)
    assert small.to_dict(2) == big.to_dict(0)
    assert small.high_water(2) == big.high_water(0)
    small.clear_doc(2)
    assert small.to_dict(2) == {"id": "root", "type": None, "value": None}
    assert small.node_count(2) == 1 and small.has_node(0, "root")
    with pytest.raises(ValueError, match="mesh"):
        TStore(2, 64, device="cpu", mesh=object())
