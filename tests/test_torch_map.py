"""The port's SharedMap family (``device="cpu"``) against the JAX package:
the plain apply and the wire unpack against ``map_kernel.py``'s programs,
the digest, ``TensorMapStore`` snapshots, and ``MapServingEngine`` (the
columnar route against the per-op route, nacks, log-replay recovery,
validation, full and incremental summaries, a JAX summary and log loaded
into the port) against the JAX engine. Tolerance: exact — all three
planes bit-identical."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.core.protocol import (
    SequencedDocumentMessage as JMessage,
)
from fluidframework_tpu.ops import map_kernel as jmk
from fluidframework_tpu.server.serving import (
    ColumnarOps as JColumnarOps, MapServingEngine as JEngine,
)
from fluidframework_tpu_torch.core.protocol import (
    MessageType, SequencedDocumentMessage,
)
from fluidframework_tpu_torch.ops import map_kernel as tmk
from fluidframework_tpu_torch.ops.schema import OpKind
from fluidframework_tpu_torch.server.deli import NackReason
from fluidframework_tpu_torch.server.oplog import PartitionedLog
from fluidframework_tpu_torch.server.serving import (
    ColumnarOps, MapServingEngine as TEngine,
)
from fluidframework_tpu_torch.testing.synthetic import (
    map_raw_batches, map_serving_batch,
)

SET, DEL, CLR = (int(OpKind.MAP_SET), int(OpKind.MAP_DELETE),
                 int(OpKind.MAP_CLEAR))
NOOP = int(OpKind.NOOP)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _same_planes(jstate, tstate):
    for k in tmk.PLANES:
        assert np.array_equal(np.asarray(getattr(jstate, k)),
                              getattr(tstate, k).numpy()), k


def _edge_batch(rng, D, O, K, seq0):
    """Random (D, O) planes with every edge the reduction has: NOOPs,
    kinds outside set/delete/clear, key slots outside [0, K), clears."""
    kind = rng.choice([SET, SET, SET, DEL, CLR, NOOP, 0, 99],
                      size=(D, O)).astype(np.int32)
    a0 = rng.integers(-1, K + 1, size=(D, O), dtype=np.int32)
    a1 = rng.integers(0, 1 << 20, size=(D, O), dtype=np.int32)
    seq = (seq0 + np.arange(D * O, dtype=np.int32)).reshape(D, O)
    return kind, a0, a1, seq


@pytest.mark.parametrize("K", [8, 64, 200])
@pytest.mark.parametrize("O", [1, 8, 64])
def test_apply_map_batch_matches_jax(K, O):
    D = 16
    rng = np.random.default_rng(K * 1000 + O)
    js = jmk.MapState.create(D, K)
    ts = tmk.MapState.create(D, K, device="cpu")
    for b in range(3):   # chained batches
        planes = _edge_batch(rng, D, O, K, 1 + b * D * O)
        js = jmk.apply_map_batch(js, *(jnp.asarray(p) for p in planes))
        ts = tmk.apply_map_batch(ts, *(_t(p) for p in planes))
        _same_planes(js, ts)
    assert np.array_equal(np.asarray(jmk.map_state_digest(js)),
                          tmk.map_state_digest(ts).numpy())


def test_config2_raw_batches_chain_like_jax():
    """The config #2 corpus (narrow), through the in-place entry point."""
    D, K, O = 32, 16, 16
    js = jmk.MapState.create(D, K)
    ts = tmk.MapState.create(D, K, device="cpu")
    for planes in map_raw_batches(D, K, O, n_batches=4, seed=3):
        js = jmk.apply_map_batch(js, *(jnp.asarray(p) for p in planes))
        out = tmk.apply_map_batch_fused(ts, *(_t(p) for p in planes))
        assert out is ts
        _same_planes(js, ts)


def test_digest_wraps_like_jax():
    D, K = 4, 300
    rng = np.random.default_rng(1)
    planes = [rng.integers(-2**31, 2**31 - 1, size=(D, K), dtype=np.int64)
              .astype(np.int32) for _ in range(3)]
    planes[0] = (planes[0] & 1).astype(np.int32)
    js = jmk.MapState(*(jnp.asarray(p) for p in planes))
    ts = tmk.MapState(*(_t(p) for p in planes))
    assert np.array_equal(np.asarray(jmk.map_state_digest(js)),
                          tmk.map_state_digest(ts).numpy())


def _packed(rng, R, O, K, wide):
    kind = rng.choice([SET, DEL, CLR, NOOP], p=[0.5, 0.2, 0.1, 0.2],
                      size=(R, O)).astype(np.int32)
    a0 = rng.integers(0, K, size=(R, O), dtype=np.int32)
    top = (1 << 20) if wide else (1 << 16)
    a1 = rng.integers(0, top, size=(R, O), dtype=np.int32)
    base = rng.integers(0, 1 << 30, size=R, dtype=np.int32)
    return kind, a0, a1, base


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("scatter", [False, True])
def test_map_unpack_and_columnar_apply_match_jax(wide, scatter):
    # R·O = 15: not a multiple of 4, an odd u16 count
    R, O, K = 3, 5, 8
    n_docs = 7 if scatter else R
    rng = np.random.default_rng(10 + 2 * wide + scatter)
    kind, a0, a1, base = _packed(rng, R, O, K, wide)
    rows = np.array([5, 0, 3] if scatter else [0, 1, 2], np.int32)
    buf, wide_vals = tmk.pack_map_batch(kind, a0, a1, base, rows)
    assert wide_vals == wide
    jp = jmk.map_columnar_unpack_jit(jnp.asarray(buf), R=R, O=O,
                                     n_docs=n_docs, scatter_rows=scatter,
                                     wide_vals=wide)
    tp = tmk.map_unpack(_t(buf), R, O, n_docs, scatter, wide)
    for a, b in zip(jp, tp):
        assert np.array_equal(np.asarray(a), b.numpy())
    start = [rng.integers(0, 1 << 16, size=(n_docs, K), dtype=np.int32)
             for _ in range(3)]
    start[0] = (start[0] & 1).astype(np.int32)
    js = jmk.map_columnar_apply_jit(
        jmk.MapState(*(jnp.asarray(p) for p in start)), jnp.asarray(buf),
        R=R, O=O, n_docs=n_docs, scatter_rows=scatter, wide_vals=wide)
    ts = tmk.MapState(*(_t(p) for p in start))
    # the port always lands plane row i on rows[i]; JAX's unscattered form
    # (rows 0..R-1, R = n_docs) must give the same planes
    tmk.map_columnar_apply_fused(ts, _t(buf), R, O, wide)
    _same_planes(js, ts)
    if scatter:   # rows the batch does not carry are untouched
        for r in set(range(n_docs)) - set(rows.tolist()):
            for k, p in zip(tmk.PLANES, start):
                assert np.array_equal(getattr(ts, k)[r].numpy(), p[r])


def _records(rng, n_docs, n, keys=6, seq0=1):
    vals = ["a", 1, {"n": 2}, [1, 2], None, True, 3.5]
    out = []
    for i in range(n):
        k = rng.choice([SET, SET, DEL, CLR])
        key = None if k == CLR else f"k{rng.integers(keys)}"
        val = vals[rng.integers(len(vals))] if k == SET else None
        out.append((int(rng.integers(n_docs)), k, key, val, seq0 + i))
    return out


def _same_store_snapshot(a, b):
    for k in tmk.PLANES:
        assert np.array_equal(a[k], b[k]), k
    assert a["n_keys"] == b["n_keys"]
    assert a["key_ids"] == b["key_ids"]
    assert a["values"] == b["values"]


def test_store_snapshot_rows_restore_like_jax():
    rng = np.random.default_rng(7)
    js, ts = jmk.TensorMapStore(8, 8), tmk.TensorMapStore(8, 8, device="cpu")
    recs = _records(rng, 8, 120)
    for i in range(0, 120, 40):
        js.apply_batch(recs[i:i + 40])
        ts.apply_batch(recs[i:i + 40])
    _same_store_snapshot(js.snapshot(), ts.snapshot())
    assert np.array_equal(js.digests(), ts.digests())
    for d in range(8):
        assert js.read_doc(d) == ts.read_doc(d)
    base_len = len(ts._interner)
    more = _records(rng, 8, 30, seq0=500)
    js.apply_batch(more)
    ts.apply_batch(more)
    jd = js.snapshot_rows([6, 1, 3], base_len)
    td = ts.snapshot_rows([6, 1, 3], base_len)
    for k in ("rows",) + tmk.PLANES:
        assert np.array_equal(jd[k], td[k]), k
    assert jd["key_ids"] == td["key_ids"]
    assert jd["values_delta"] == td["values_delta"]
    # a JAX snapshot restores into the port and the port's into JAX
    from_j = tmk.TensorMapStore.from_jax_snapshot(js.snapshot(), "cpu")
    _same_store_snapshot(from_j.snapshot(), js.snapshot())
    from_t = jmk.TensorMapStore.restore(ts.snapshot())
    _same_store_snapshot(from_t.snapshot(), ts.snapshot())
    # a restored base plus the JAX row delta equals the live store
    snap = js.snapshot()
    for k in tmk.PLANES:
        snap[k][[6, 1, 3]] = 0
    rebuilt = tmk.TensorMapStore.restore(snap, "cpu")
    rebuilt.apply_row_snapshot(jd)
    assert np.array_equal(rebuilt.digests(), js.digests())
    _same_store_snapshot(rebuilt.snapshot(), js.snapshot())
    # the restored store owns its planes (no view of the snapshot arrays)
    assert not np.shares_memory(from_j.state.present.numpy(),
                                js.snapshot()["present"])


def _engines(R, **kw):
    j = JEngine(n_docs=R, batch_window=10 ** 9, sequencer="native", **kw)
    t = TEngine(n_docs=R, batch_window=10 ** 9, sequencer="native",
                device="cpu", **kw)
    docs = [f"m-{i}" for i in range(R)]
    for e in (j, t):
        for d in docs:
            e.connect(d, 1)
            e.doc_row(d)
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    return j, t, docs, rows


def _contents(kind, key, value):
    if kind == CLR:
        return {"op": "clear"}
    if kind == DEL:
        return {"op": "delete", "key": key}
    return {"op": "set", "key": key, "value": value}


def _submit_mirror(e, docs, batch, cseq):
    kind, kidx, keys, vidx, values = batch
    for d in range(kind.shape[0]):
        for o in range(kind.shape[1]):
            _, nack = e.submit(docs[d], 1, int(cseq[d, o]), 0, _contents(
                kind[d, o], keys[kidx[d, o]], values[vidx[d, o]]))
            assert nack is None


def _same_reads(a, b, docs):
    for d in docs:
        assert a.read_doc(d) == b.read_doc(d), d
        assert a.deli.doc_seq(d) == b.deli.doc_seq(d), d


def _same_engine(j, t, docs):
    """Same reads, seqs and store (planes, key maps, value table)."""
    _same_reads(j, t, docs)
    _same_store_snapshot(j.store.snapshot(), t.store.snapshot())


def _ingest(e, rows, batch, cseq):
    kind, kidx, keys, vidx, values = batch
    R, O = kind.shape
    return e.ingest_planes(rows, np.ones((R, O), np.int32), cseq,
                           np.zeros((R, O), np.int32), kind, kidx, keys,
                           values, vidx)


def _cseq(b, R, O):
    return np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                     dtype=np.int32), (R, O))


def test_columnar_matches_per_op_and_jax():
    R, O = 16, 12
    j, t, docs, rows = _engines(R)
    per_op = TEngine(n_docs=R, batch_window=10 ** 9, device="cpu")
    for d in docs:
        per_op.connect(d, 1)
        per_op.doc_row(d)
    for b in range(3):
        batch = map_serving_batch(R, O, b, n_keys=6)
        for e in (j, t):
            assert _ingest(e, rows, batch, _cseq(b, R, O))["nacked"] == 0
        _submit_mirror(per_op, docs, batch, _cseq(b, R, O))
    _same_engine(j, t, docs)
    for d in docs:
        assert t.read_doc(d) == per_op.read_doc(d), d
    assert np.array_equal(t.store.digests(), j.store.digests())


def test_columnar_nacks_skipped_like_jax():
    R, O = 4, 8
    j, t, docs, rows = _engines(R)
    batch = map_serving_batch(R, O, 0, n_keys=6)
    cseq = _cseq(0, R, O).copy()
    cseq[1, 3] = 99   # a gap: ops 3.. of doc 1 nack
    res = [_ingest(e, rows, batch, cseq) for e in (j, t)]
    assert res[0]["nacked"] == res[1]["nacked"] == O - 3
    assert np.array_equal(res[0]["seq"], res[1]["seq"])
    assert (res[1]["seq"][1, 3:] < 0).all()
    logged = sum(len(rec.seq) for p in range(t.log.n_partitions)
                 for rec in t.log.read(p) if isinstance(rec, ColumnarOps))
    assert logged == R * O - (O - 3)
    _same_engine(j, t, docs)


def test_columnar_recovery_through_log_replay():
    R, O = 8, 10
    j, t, docs, rows = _engines(R)
    summaries = []
    for b in range(2):
        for e in (j, t):
            _ingest(e, rows, map_serving_batch(R, O, b, n_keys=6),
                    _cseq(b, R, O))
        if b == 0:
            summaries = [j.summarize(), t.summarize()]
    revived = [JEngine.load(summaries[0], j.log),
               TEngine.load(summaries[1], t.log, device="cpu")]
    for d in docs:
        assert revived[0].read_doc(d) == revived[1].read_doc(d) \
            == t.read_doc(d), d
    for e in revived:   # sequencing resumes
        _, nack = e.submit(docs[0], 1, 2 * O + 1, 0,
                           {"op": "set", "key": "fresh", "value": 1})
        assert nack is None
        assert e.get(docs[0], "fresh") == 1
    _same_store_snapshot(revived[0].store.snapshot(),
                         revived[1].store.snapshot())


def test_columnar_validation_sequences_nothing():
    R, O = 2, 4
    _, t, docs, rows = _engines(R)
    client = np.ones((R, O), np.int32)
    cseq = _cseq(0, R, O)
    z = np.zeros((R, O), np.int32)
    sets = np.full((R, O), SET, np.int32)
    seq_before = {d: t.deli.doc_seq(d) for d in docs}
    bad = z.copy()
    bad[0, 0] = 5
    with pytest.raises(ValueError, match="keys table"):
        t.ingest_planes(rows, client, cseq, z, sets, bad, ["k"], ["v"], z)
    with pytest.raises(ValueError, match="values table"):
        t.ingest_planes(rows, client, cseq, z, sets, z, ["k"], ["v"], bad)
    with pytest.raises(ValueError, match="set/delete/clear"):
        t.ingest_planes(rows, client, cseq, z, z, z, ["k"], ["v"], z)
    small = TEngine(n_docs=R, n_keys=2, batch_window=10 ** 9,
                    sequencer="native", device="cpu")
    for d in docs:
        small.connect(d, 1)
        small.doc_row(d)
    with pytest.raises(KeyError, match="key capacity"):
        small.ingest_planes(rows, client, cseq, z, sets,
                            np.broadcast_to(np.arange(O, dtype=np.int32),
                                            (R, O)),
                            ["a", "b", "c", "d"], ["v"], z)
    for e in (t, small):   # nothing sequenced by rejected batches
        for d in docs:
            assert e.deli.doc_seq(d) == seq_before[d]


def test_per_op_route_like_jax():
    """submit → flush with clears, unserialisable values nacked as
    MALFORMED and an exhausted key capacity as CAPACITY, in both."""
    j = JEngine(n_docs=4, n_keys=3, batch_window=5)
    t = TEngine(n_docs=4, n_keys=3, batch_window=5, device="cpu")
    docs = [f"d{i}" for i in range(4)]
    rng = np.random.default_rng(4)
    cs = {d: 0 for d in docs}
    for e in (j, t):
        for d in docs:
            e.connect(d, 1)
    for _ in range(60):
        d = docs[int(rng.integers(4))]
        kind = [SET, SET, DEL, CLR][int(rng.integers(4))]
        c = _contents(kind, f"k{rng.integers(4)}", int(rng.integers(5)))
        cs[d] += 1
        res = [e.submit(d, 1, cs[d], 0, c) for e in (j, t)]
        assert (res[0][1] is None) == (res[1][1] is None)
        if res[1][1] is not None:
            assert res[1][1].reason == NackReason.CAPACITY
            assert int(res[0][1].reason) == int(NackReason.CAPACITY)
            cs[d] -= 1
        else:
            assert res[0][0].seq == res[1][0].seq
    _, nack = t.submit(docs[0], 1, cs[docs[0]] + 1, 0,
                       {"op": "set", "key": "k0", "value": {1, 2}})
    assert nack.reason == NackReason.MALFORMED
    _same_engine(j, t, docs)


def test_full_and_incremental_summaries_like_jax():
    R, O = 6, 8
    j, t, docs, rows = _engines(R)
    for e in (j, t):
        e.max_incremental_chain = 2
    chain = []
    for b in range(4):
        # a growing subset of the docs: row i joins at batch max(i - 2, 0),
        # so clean rows ride by reference to the base
        n = 2 + b
        cseq = np.stack([_cseq(b - max(i - 2, 0), 1, O)[0]
                         for i in range(n)])
        for e in (j, t):
            e.ingest_planes(
                rows[:n], np.ones((n, O), np.int32), cseq,
                np.zeros((n, O), np.int32),
                *_sub(map_serving_batch(R, O, b, n_keys=6), n))
        sj, st = j.summarize(incremental=b > 0), \
            t.summarize(incremental=b > 0)
        assert sj["kind"] == st["kind"]
        if st["kind"] == "delta":
            for k in ("rows",) + tmk.PLANES:
                assert np.array_equal(sj["store_delta"][k],
                                      st["store_delta"][k]), k
            assert sj["store_delta"]["values_delta"] == \
                st["store_delta"]["values_delta"]
        chain.append((sj, st))
    assert [s[1]["kind"] for s in chain] == ["full", "delta", "delta",
                                             "full"]
    for sj, st in chain[:3]:
        lj = JEngine.load(sj, j.log, sequencer="native")
        lt = TEngine.load(st, t.log, device="cpu", sequencer="native")
        _same_engine(lj, lt, docs)
        # a loaded engine replays its tail per op and interns values in
        # that order (as the JAX engine does): the live one is held by
        # its reads
        _same_reads(t, lt, docs)


def _sub(batch, n):
    kind, kidx, keys, vidx, values = batch
    return kind[:n], kidx[:n], keys, values, vidx[:n]


def _port_record(rec):
    """A JAX log record rebuilt as the port's, from its plain fields."""
    if isinstance(rec, JColumnarOps):
        return ColumnarOps(
            list(rec.doc_ids), *(np.asarray(getattr(rec, f)).copy() for f in
                                 ("doc", "client", "client_seq", "ref_seq",
                                  "seq", "min_seq", "kind", "a0", "a1")),
            text=rec.text, timestamp=rec.timestamp, family=rec.family,
            keys=list(rec.keys), values=copy.deepcopy(rec.values))
    assert isinstance(rec, JMessage)
    return SequencedDocumentMessage(
        doc_id=rec.doc_id, client_id=rec.client_id,
        client_seq=rec.client_seq, ref_seq=rec.ref_seq, seq=rec.seq,
        min_seq=rec.min_seq, type=MessageType(int(rec.type)),
        contents=copy.deepcopy(rec.contents), timestamp=rec.timestamp)


def test_jax_summary_and_log_load_into_the_port():
    R, O = 6, 8
    j, _, docs, rows = _engines(R)
    for b in range(2):
        _ingest(j, rows, map_serving_batch(R, O, b, n_keys=6),
                _cseq(b, R, O))
    j.submit(docs[0], 1, 2 * O + 1, 0, {"op": "set", "key": "x",
                                         "value": [1]})
    summary = j.summarize()
    cs = _cseq(2, R, O).copy()
    cs[0] += 1        # doc 0 spent one clientSeq on the set
    res = _ingest(j, rows, map_serving_batch(R, O, 2, n_keys=6), cs)
    assert res["nacked"] == 0
    log = PartitionedLog(j.log.n_partitions)
    for p in range(j.log.n_partitions):
        for rec in j.log.read(p):
            log.append(p, _port_record(rec))
    lj = JEngine.load(summary, j.log, sequencer="native")
    lt = TEngine.load(summary, log, device="cpu", sequencer="native")
    _same_engine(lj, lt, docs)
    _same_reads(j, lt, docs)
    d = docs[3]
    for e in (lj, lt):
        # a resubmitted clientSeq is dup-acked with its original seq
        msg, nack = e.submit(d, 1, int(cs[3, 4]), 0,
                             {"op": "delete", "key": "k1"})
        assert msg is None and nack.seq == int(res["seq"][3, 4])
        # sequencing resumes at the same seq
        msg, nack = e.submit(d, 1, int(cs[3, -1]) + 1, 0,
                             {"op": "set", "key": "k9", "value": "z"})
        assert nack is None and msg.seq == j.deli.doc_seq(d) + 1
    assert lj.read_doc(d) == lt.read_doc(d)


def test_mesh_is_refused():
    """Anything but a 1-D docs mesh is refused (tests/test_torch_mesh.py
    drives the sharded store and engine)."""
    with pytest.raises(ValueError, match="docs"):
        tmk.TensorMapStore(4, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="docs"):
        TEngine(n_docs=4, device="cpu", mesh=object())
