"""The port's StringServingEngine (device="cpu") against the JAX engine,
both with the native sequencer: identical seqs, nacks, log records and
text through ``ingest_planes``, the per-op ``submit`` route, and the
pipelined executor. Tolerance: exact."""

import numpy as np
import pytest

from fluidframework_tpu.server.serving import (
    ColumnarOps as JColumnarOps, StringServingEngine as JEngine,
)
from fluidframework_tpu.testing.synthetic import rich_storm, typing_storm
from fluidframework_tpu_torch.ops.schema import OpKind
from fluidframework_tpu_torch.server.ingest_pipeline import (
    PipelinedIngestExecutor,
)
from fluidframework_tpu_torch.server.serving import (
    ColumnarOps, StringServingEngine as TEngine,
)

TEXT = "abcd"  # typing_storm INS_LEN


def _engines(R=8, compact_every=2, batch_window=10 ** 9):
    kw = dict(n_docs=R, capacity=256, batch_window=batch_window,
              compact_every=compact_every, sequencer="native")
    j, t = JEngine(**kw), TEngine(**kw, device="cpu")
    docs = [f"doc-{i}" for i in range(R)]
    for eng in (j, t):
        for d in docs:
            eng.connect(d, 1)
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    assert [j.doc_row(d) for d in docs] == rows.tolist()
    return j, t, docs, rows


def _batches(R, O, n_batches):
    out, seq = [], 1
    for bi in range(n_batches):
        planes, seq = typing_storm(R, O, seed=bi, start_seq=seq)
        cseq = np.broadcast_to(
            np.arange(bi * O + 1, (bi + 1) * O + 1, dtype=np.int32), (R, O))
        out.append((planes["kind"], planes["a0"], planes["a1"], cseq))
    return out


def _log_messages(eng, cls):
    msgs = []
    for p in range(eng.log.n_partitions):
        for rec in eng.log.read(p):
            if isinstance(rec, cls):
                msgs.extend(rec.expand())
    return sorted((m.doc_id, m.seq, m.client_seq, m.ref_seq, m.min_seq,
                   str(m.contents)) for m in msgs)


def _assert_same(j, t, docs):
    for d in docs:
        assert j.read_text(d) == t.read_text(d), d
    assert np.array_equal(j.store.digests(), t.store.digests())
    assert _log_messages(j, JColumnarOps) == _log_messages(t, ColumnarOps)


def test_ingest_planes_matches_jax_engine():
    R, O = 8, 16
    j, t, docs, rows = _engines(R)
    client = np.ones((R, O), np.int32)
    for kind, a0, a1, cseq in _batches(R, O, 4):
        ref = cseq.copy()
        rj = j.ingest_planes(rows, client, cseq, ref, kind, a0, a1, TEXT)
        rt = t.ingest_planes(rows, client, cseq, ref, kind, a0, a1, TEXT)
        assert np.array_equal(rj["seq"], rt["seq"])
        assert rj["nacked"] == rt["nacked"] == 0
    assert t.store.last_profile == ("compact8", "pos16", "broadcast")
    _assert_same(j, t, docs)
    assert t.overflowed_docs() == []


def test_ingest_planes_client_seq_gap_nacks():
    R, O = 4, 8
    j, t, docs, rows = _engines(R)
    (kind, a0, a1, cseq), = _batches(R, O, 1)
    cseq = cseq.copy()
    cseq[2, 5] = 99  # clientSeq gap mid-batch for doc 2
    client = np.ones((R, O), np.int32)
    ref = np.zeros((R, O), np.int32)
    rj = j.ingest_planes(rows, client, cseq, ref, kind, a0, a1, TEXT)
    rt = t.ingest_planes(rows, client, cseq, ref, kind, a0, a1, TEXT)
    # the gap cascades: ops 5, 6, 7 of doc 2 all nack
    assert rj["nacked"] == rt["nacked"] == 3
    assert np.array_equal(rj["seq"], rt["seq"])
    assert (rt["seq"][2, 5:] < 0).all()
    _assert_same(j, t, docs)


def _op_contents(kind, a0, a1, d, o):
    if kind[d, o] == OpKind.STR_INSERT:
        return {"mt": "insert", "kind": 0, "pos": int(a0[d, o]),
                "text": TEXT}
    return {"mt": "remove", "start": int(a0[d, o]), "end": int(a1[d, o])}


def test_submit_route_matches_jax_engine():
    """Per-op submits with a small batch window: flushes and the
    compaction cadence run inside submit."""
    R, O = 4, 12
    j, t, docs, _ = _engines(R, compact_every=2, batch_window=7)
    for kind, a0, a1, cseq in _batches(R, O, 2):
        for o in range(O):
            for d in range(R):
                c = _op_contents(kind, a0, a1, d, o)
                ref = max(int(cseq[d, o]) - 2, 0)
                mj, nj = j.submit(docs[d], 1, int(cseq[d, o]), ref, c)
                mt, nt = t.submit(docs[d], 1, int(cseq[d, o]), ref, c)
                assert nj is None and nt is None
                assert (mj.seq, mj.min_seq, mj.ref_seq) == \
                    (mt.seq, mt.min_seq, mt.ref_seq)
    # heartbeats advance the window floor; a leave + rejoin sequences too
    for eng in (j, t):
        eng.heartbeat(docs[1], 1, eng.deli.doc_seq(docs[1]))
        eng.disconnect(docs[3], 1)
        eng.connect(docs[3], 1)
        eng.compact()
    assert j._min_seq == t._min_seq
    assert j.deli.doc_seq(docs[3]) == t.deli.doc_seq(docs[3])
    # a stale resubmit is nacked DUPLICATE and re-acked with its seq
    mt, nt = t.submit(docs[0], 1, 3, 0, _op_contents(kind, a0, a1, 0, 2))
    mj, nj = j.submit(docs[0], 1, 3, 0, _op_contents(kind, a0, a1, 0, 2))
    assert mt is None and nt.seq == nj.seq > 0
    for d in docs:
        assert j.read_text(d) == t.read_text(d), d
    assert np.array_equal(j.store.digests(), t.store.digests())


def _waves(R, O, n, rich=False):
    waves = []
    for b in range(n):
        cs = np.broadcast_to(
            np.arange(b * O + 1, (b + 1) * O + 1, dtype=np.int32), (R, O))
        w = dict(client=np.ones((R, O), np.int32), client_seq=cs,
                 ref_seq=cs)
        if rich:
            planes, texts, props, _ = rich_storm(R, O, seed=b)
            w.update(kind=planes["kind"], a0=planes["a0"], a1=planes["a1"],
                     texts=texts, tidx=planes["tidx"], props=props)
        else:
            planes, _ = typing_storm(R, O, seed=b)
            w.update(kind=planes["kind"], a0=planes["a0"], a1=planes["a1"],
                     text=TEXT)
        waves.append(w)
    return waves


@pytest.mark.parametrize("rich", [False, True])
def test_pipelined_equals_serial(rich):
    R, O = 8, 8
    waves = _waves(R, O, 5, rich)
    j, t_serial, docs, rows = _engines(R)
    _, t_pipe, _, _ = _engines(R)
    serial = [t_serial.ingest_planes(rows, **w) for w in waves]
    for w in waves:
        j.ingest_planes(rows, **w)
    with PipelinedIngestExecutor(t_pipe, depth=3) as ex:
        tickets = [ex.submit(rows, **w) for w in waves]
        ex.drain()
        piped = [tk.result() for tk in tickets]
        assert ex.stats()["max_inflight"] >= 1
    for a, b in zip(serial, piped):
        assert np.array_equal(a["seq"], b["seq"])
        assert a["nacked"] == b["nacked"] == 0
    _assert_same(j, t_pipe, docs)
    assert t_pipe._ingest_inflight() == 0
    t_pipe._check_poisoned()
