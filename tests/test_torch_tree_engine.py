"""The port's ``TreeServingEngine(device="cpu")`` against the JAX engine,
both on the CPU with the native sequencer: per-op ``submit`` with lagging
refs, ``ingest_batch``, ``ingest_records`` and ``ingest_leaves`` (the same
acks, ``to_dict``, planes and digests), nacks, malformed batches refused
before sequencing, ``recover_overflowed`` reports and trees, full and
incremental summaries loaded by the port, and a JAX summary with its log
loaded into the port. The port's pipelined executor equals its own serial
path. The JAX engine is blocked on after every columnar wave (its pooled
wire buffers may be reused while an asynchronous CPU dispatch still reads
them). Tolerance: exact."""

import copy

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.core.protocol import (
    SequencedDocumentMessage as JMessage,
)
from fluidframework_tpu.server.serving import (
    TreeRecordOps as JTreeRecordOps, TreeServingEngine as JEngine,
)
from fluidframework_tpu_torch.core.protocol import (
    MessageType, SequencedDocumentMessage,
)
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.server.ingest_pipeline import (
    PipelinedIngestExecutor,
)
from fluidframework_tpu_torch.server.oplog import PartitionedLog
from fluidframework_tpu_torch.server.serving import (
    TreeRecordOps, TreeServingEngine as TEngine,
)
from fluidframework_tpu_torch.server.tree_wire import (
    encode_leaf_records, encode_tree_batch,
)
from fluidframework_tpu_torch.testing.synthetic import (
    profile_tree_waves, tree_op_storm,
)

ALL = tk.TREE_PLANES + ("overflow",)


def _pair(n_docs=6, capacity=128, **kw):
    kw.setdefault("batch_window", 10 ** 9)
    j = JEngine(n_docs=n_docs, capacity=capacity, sequencer="native", **kw)
    t = TEngine(n_docs=n_docs, capacity=capacity, sequencer="native",
                device="cpu", **kw)
    return j, t


def _connect(engines, docs, clients=(1,)):
    for e in engines:
        for d in docs:
            for c in clients:
                e.connect(d, c)
            e.doc_row(d)


def _settle(e):
    if isinstance(e, JEngine):
        jax.block_until_ready(e.store.state)


def _same(j, t, docs, planes=True):
    for d in docs:
        assert j.to_dict(d) == t.to_dict(d), d
        assert j.deli.doc_seq(d) == t.deli.doc_seq(d), d
    if planes:
        for k in ALL:
            a = np.asarray(getattr(j.store.state, k))
            b = getattr(t.store.state, k).numpy()
            assert np.array_equal(a, b), (k, np.argwhere(a != b)[:4])
        assert np.array_equal(j.store.digests(), t.store.digests())


def _outcome(res):
    msg, nack = res
    return (msg.seq if msg is not None else None,
            nack.reason.name if nack is not None else None,
            nack.seq if nack is not None else None)


def test_per_op_submit_like_jax():
    """Three clients a doc, lagging (per-client monotonic) refs, a flush
    every 16 submits."""
    docs = [f"t{i}" for i in range(4)]
    j, t = _pair(n_docs=4)
    _connect((j, t), docs, clients=(1, 2, 3))
    rng = np.random.default_rng(0)
    cseq, ref = {}, {}
    for i, (d, op) in enumerate(tree_op_storm(docs, 12, seed=1)):
        c = int(rng.integers(1, 4))
        cseq[d, c] = cseq.get((d, c), 0) + 1
        now = j.deli.doc_seq(d)
        ref[d, c] = max(ref.get((d, c), 0), now - int(rng.integers(0, 4)))
        out = [_outcome(e.submit(d, c, cseq[d, c], ref[d, c], op))
               for e in (j, t)]
        assert out[0] == out[1], (op, out)
        if i % 16 == 15:
            j.flush()
            t.flush()
    _same(j, t, docs)


def _waves(docs, n_waves, per_doc=3, seed=0):
    pools = {}
    return [[(d, op) for d, op in tree_op_storm(docs, per_doc, seed=seed + w,
                                                pools=pools)]
            for w in range(n_waves)]


def _wave_args(wave, cs):
    ids, clients, cseqs, refs = [], [], [], []
    for d, _op in wave:
        cs[d] = cs.get(d, 0) + 1
        ids.append(d)
        clients.append(1)
        cseqs.append(cs[d])
        refs.append(0)
    return ids, clients, cseqs, refs, [op for _d, op in wave]


@pytest.mark.parametrize("route", ["batch", "records"])
def test_columnar_routes_like_jax(route):
    docs = [f"t{i}" for i in range(6)]
    j, t = _pair()
    _connect((j, t), docs)
    cs = {}
    for wave in _waves(docs, 4):
        ids, clients, cseqs, refs, ops = _wave_args(wave, cs)
        res = []
        for e in (j, t):
            if route == "batch":
                r = e.ingest_batch(ids, clients, cseqs, refs, ops)
            else:
                rows = np.array([e.doc_row(d) for d in ids], np.int32)
                r = e.ingest_records(None, clients, cseqs, refs,
                                     encode_tree_batch(ops), rows=rows)
            _settle(e)
            res.append(r)
        assert np.array_equal(res[0]["seq"], res[1]["seq"])
        assert res[0]["nacked"] == res[1]["nacked"] == 0
    _same(j, t, docs)


def test_ingest_leaves_like_jax():
    docs = [f"f{i}" for i in range(5)]
    j, t = _pair(n_docs=5)
    _connect((j, t), docs)
    n = len(docs)
    for w in range(4):
        args = (docs, [1] * n, [w + 1] * n, [0] * n, ["root"] * n,
                ["kids"] * n, [f"{d}-{w}" for d in docs],
                [w, "x", None, {"k": [w]}, 2.5][:n],
                [None, "item"] * 2 + [None],
                [None if w == 0 else f"{d}-{w - 1}" for d in docs])
        for e in (j, t):
            assert e.ingest_leaves(*args)["nacked"] == 0
            _settle(e)
    _same(j, t, docs)
    assert [c["id"] for c in t.to_dict("f0")["children"]["kids"]] == \
        ["f0-0", "f0-1", "f0-2", "f0-3"]


def test_pipelined_executor_equals_serial():
    """Four record waves through ``PipelinedIngestExecutor(depth=3)``,
    one of them on the dense path (too many field names for the u8 field
    lane), against the same waves walked serially."""
    docs = [f"t{i}" for i in range(6)]
    waves = _waves(docs, 4)
    wide = [(d, {"op": "insert", "parent": "root", "field": f"f{i}",
                 "after": None, "nodes": [{"id": f"{d}/w{i}"}]})
            for i in range(300) for d in docs[:1]]
    waves.insert(2, wide)
    serial = TEngine(n_docs=6, capacity=512, batch_window=10 ** 9,
                     sequencer="native", device="cpu")
    piped = TEngine(n_docs=6, capacity=512, batch_window=10 ** 9,
                    sequencer="native", device="cpu")
    _connect((serial, piped), docs)
    batches, cs = [], {}
    for wave in waves:
        ids, clients, cseqs, refs, ops = _wave_args(wave, cs)
        batches.append((ids, clients, cseqs, refs, encode_tree_batch(ops)))
    assert not serial._wire_eligible(batches[2][4])
    want = [serial.ingest_records(*b) for b in batches]
    ex = PipelinedIngestExecutor(piped, depth=3)
    tickets = [ex.submit(*b) for b in batches]
    ex.drain()
    got = [tk_.result() for tk_ in tickets]
    assert ex.stats()["max_inflight"] > 1
    ex.close()
    for a, b in zip(want, got):
        assert np.array_equal(a["seq"], b["seq"]) and b["nacked"] == 0
    for k in ALL:
        assert torch.equal(getattr(serial.store.state, k),
                           getattr(piped.store.state, k)), k
    for d in docs:
        assert serial.to_dict(d) == piped.to_dict(d)


def test_nacks_drop_records_like_jax():
    docs = [f"t{i}" for i in range(3)]
    j, t = _pair(n_docs=3)
    _connect((j, t), docs)
    ops = [op for _d, op in tree_op_storm(docs, 2, seed=3)]
    ids = [d for d, _ in tree_op_storm(docs, 2, seed=3)]
    cseqs = [1, 1, 1, 1, 2, 2]          # doc t0's second op repeats cseq 1
    res = []
    for e in (j, t):
        res.append(e.ingest_batch(ids, [1] * 6, cseqs, [0] * 6, ops))
        _settle(e)
    assert np.array_equal(res[0]["seq"], res[1]["seq"])
    assert res[1]["nacked"] == res[0]["nacked"] > 0
    _same(j, t, docs)


MALFORMED = {
    "recs_shape": lambda b: {**b, "recs": b["recs"][:, :7]},
    "rec_op_order": lambda b: {**b, "rec_op": b["rec_op"][::-1].copy()},
    "kind_range": lambda b: {**b, "recs": _set(b["recs"], 0, 0, 14)},
    "handle_bounds": lambda b: {**b, "recs": _set(b["recs"], 0, 1, 99)},
    "meta_range": lambda b: {**b, "recs": _set(b["recs"], 0, 7, 2)},
    "id_entry": lambda b: {**b, "ids": [""] + list(b["ids"][1:])},
    "value_table": lambda b: {**b, "values": [object()]},
}


def _set(recs, i, col, v):
    recs = recs.copy()
    recs[i, col] = v
    return recs


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_batches_refused_before_sequencing(case):
    docs = ["a", "b"]
    j, t = _pair(n_docs=2)
    _connect((j, t), docs)
    batch = encode_tree_batch([{"op": "insert", "parent": "root",
                                "field": "k", "after": None,
                                "nodes": [{"id": f"{d}1", "value": 1}]}
                               for d in docs])
    bad = MALFORMED[case](batch)
    for e in (j, t):
        before = [e.deli.doc_seq(d) for d in docs]
        with pytest.raises(ValueError):
            e.ingest_records(docs, [1, 1], [1, 1], [0, 0], bad)
        assert [e.deli.doc_seq(d) for d in docs] == before
    for e in (j, t):
        assert e.ingest_records(docs, [1, 1], [1, 1], [0, 0],
                                batch)["nacked"] == 0
        _settle(e)
    _same(j, t, docs)


def _growth(docs, w, wide_doc):
    ops = []
    for d in docs:
        n = 12 if d == wide_doc else 2
        ops += [(d, {"op": "insert", "parent": "root", "field": "kids",
                     "after": None,
                     "nodes": [{"id": f"{d}-{w}-{i}", "value": i}]})
                for i in range(n)]
    return ops


def test_recovery_reports_and_trees_like_jax():
    """Capacity-16 engines: one doc outgrows the tier (graduates), others
    overflow by little after removes freed slots (re-upload)."""
    docs = [f"t{i}" for i in range(4)]
    j, t = _pair(n_docs=4, capacity=16)
    _connect((j, t), docs)
    cs = {}
    for w in range(3):
        wave = _growth(docs, w, "t0")
        if w == 2:
            wave += [(d, {"op": "remove", "id": f"{d}-0-{i}"})
                     for d in docs[1:] for i in range(2)]
            wave += [(d, {"op": "insert", "parent": "root", "field": "kids",
                          "after": None,
                          "nodes": [{"id": f"{d}-x{i}"} for i in range(5)]})
                     for d in docs[1:]]
        ids, clients, cseqs, refs, ops = _wave_args(wave, cs)
        for e in (j, t):
            assert e.ingest_batch(ids, clients, cseqs, refs,
                                  ops)["nacked"] == 0
            _settle(e)
    assert sorted(j.overflowed_docs()) == sorted(t.overflowed_docs())
    rj, rt = j.recover_overflowed(), t.recover_overflowed()
    assert rj == rt and "graduated" in rt.values()
    _same(j, t, docs)
    # a graduated doc keeps serving through submit
    for e in (j, t):
        msg, nack = e.submit("t0", 1, cs["t0"] + 1, 0, {
            "op": "setValue", "id": "t0-0-0", "value": "late"})
        assert nack is None
    _same(j, t, docs, planes=False)


def test_summaries_load_into_the_port():
    """Full and incremental summaries of the port engine load (on the CPU)
    equal to the live engine: trees, seqs, and the digests of the rows
    the tail did not touch; a resubmitted clientSeq is dup-acked."""
    docs = [f"t{i}" for i in range(6)]
    _, t = _pair()
    _connect((t,), docs)
    cs = {}
    waves = _waves(docs, 4, seed=11)
    for wave in waves[:2]:
        t.ingest_batch(*_wave_args(wave, cs))
    full = t.summarize()
    t.ingest_batch(*_wave_args(waves[2], cs))
    inc = t.summarize(incremental=True)
    assert inc["kind"] == "delta"
    tail = _wave_args(waves[3][:4], cs)   # the tail touches t0, t1 only
    res = t.ingest_batch(*tail)
    for summary in (full, inc):
        lt = TEngine.load(summary, t.log, device="cpu", sequencer="native")
        _same(t, lt, docs, planes=False)
        dg, ldg = t.store.digests(), lt.store.digests()
        untouched = [t.doc_row(d) for d in docs[2:]]
        assert np.array_equal(dg[untouched], ldg[untouched])
        msg, nack = lt.submit(tail[0][0], 1, tail[2][0], 0,
                              {"op": "remove", "id": "nope"})
        assert msg is None and nack.seq == int(res["seq"][0])
    loads = [TEngine.load(s, t.log, device="cpu", sequencer="native")
             for s in (inc, inc)]
    assert np.array_equal(loads[0].store.digests(), loads[1].store.digests())


def _port_record(rec):
    """A JAX log record rebuilt as the port's, from its plain fields."""
    if isinstance(rec, JTreeRecordOps):
        return TreeRecordOps(
            list(rec.doc_ids), *(np.asarray(getattr(rec, f)).copy() for f in
                                 ("doc", "client", "client_seq", "ref_seq",
                                  "seq", "min_seq", "rec_op", "recs")),
            list(rec.ids), list(rec.fields), list(rec.types),
            copy.deepcopy(rec.values), timestamp=rec.timestamp)
    assert isinstance(rec, JMessage)
    return SequencedDocumentMessage(
        doc_id=rec.doc_id, client_id=rec.client_id,
        client_seq=rec.client_seq, ref_seq=rec.ref_seq, seq=rec.seq,
        min_seq=rec.min_seq, type=MessageType(int(rec.type)),
        contents=copy.deepcopy(rec.contents), timestamp=rec.timestamp)


def test_jax_summary_and_log_load_into_the_port():
    docs = [f"t{i}" for i in range(6)]
    j, _ = _pair()
    _connect((j,), docs)
    cs = {}
    waves = _waves(docs, 3, seed=21)
    j.ingest_batch(*_wave_args(waves[0], cs))
    _settle(j)
    j.submit("t0", 1, cs["t0"] + 1, 0, {"op": "setValue", "id": "root",
                                        "value": [1]})
    cs["t0"] += 1
    summary = j.summarize()
    j.ingest_batch(*_wave_args(waves[1], cs))
    _settle(j)
    inc = j.summarize(incremental=True)
    j.ingest_batch(*_wave_args(waves[2], cs))
    _settle(j)
    log = PartitionedLog(j.log.n_partitions)
    for p in range(j.log.n_partitions):
        for rec in j.log.read(p):
            log.append(p, _port_record(rec))
    for s in (summary, inc):
        lj = JEngine.load(s, j.log, sequencer="native")
        lt = TEngine.load(s, log, device="cpu", sequencer="native")
        _same(lj, lt, docs)
        _same(j, lt, docs, planes=False)


def test_profile_waves_and_mesh_refused():
    docs = [f"p{i}" for i in range(4)]
    j, t = _pair(n_docs=4)
    _connect((j, t), docs)
    for w in range(3):
        ids, ops = profile_tree_waves(docs, w)
        for e in (j, t):
            r = e.ingest_batch(ids, [1] * 4, [w + 1] * 4, [0] * 4, ops)
            assert r["nacked"] == 0
            _settle(e)
    _same(j, t, docs)
    for d in docs[:2]:   # the decoded log history (audit / oracle replay)
        jm, tm = j._doc_log_messages(d), t._doc_log_messages(d)
        assert [(m.seq, m.contents) for m in jm] == \
            [(m.seq, m.contents) for m in tm]
    assert j.allocate_node_ids(5) == t.allocate_node_ids(5)
    assert np.array_equal(j.sync(), t.sync())
    assert t.node_value("p0", "p0-n1") == 20
    assert t.has_node("p3", "p3-n2") and t.node_count("p3") == 4
    with pytest.raises(ValueError, match="docs"):  # not a docs mesh
        TEngine(n_docs=4, device="cpu", mesh=object())
    leaf = encode_leaf_records(["root"], ["kids"], ["x"], [1])
    assert leaf["recs"].shape == (1, 8)
