"""Summary and load of the port's StringServingEngine (``device="cpu"``)
against the JAX engine: full and incremental summaries (a delta chain, the
chain-depth cap), a graduated and a re-uploaded doc, log-tail replay, the
dedup ledger's dup-acks after a load, a JAX summary and log carried into
the port, and the Python and native sequencers' checkpoints. Tolerance:
exact."""

import copy

import numpy as np
import pytest

from fluidframework_tpu.core.protocol import (
    MessageType as JMessageType, SequencedDocumentMessage as JMessage,
)
from fluidframework_tpu.server import native_deli as jnative
from fluidframework_tpu.server.deli import DeliSequencer as JDeli
from fluidframework_tpu.server.serving import (
    ColumnarOps as JColumnarOps, StringServingEngine as JEngine,
)
from fluidframework_tpu_torch.core.protocol import (
    MessageType, SequencedDocumentMessage,
)
from fluidframework_tpu_torch.server import native_deli as tnative
from fluidframework_tpu_torch.server.deli import DeliSequencer as TDeli
from fluidframework_tpu_torch.server.deli import NackReason
from fluidframework_tpu_torch.server.oplog import (
    OplogCorruptionError, PartitionedLog,
)
from fluidframework_tpu_torch.server.serving import (
    ColumnarOps, StringServingEngine as TEngine,
)
from fluidframework_tpu_torch.testing.synthetic import typing_storm
from tests.test_torch_recovery import same_engine


def same_texts(live, loaded):
    """A loaded engine serves what the live one does (its replayed tail
    re-interns payloads per op, so digests may differ from the live
    engine's, in both packages)."""
    assert live._doc_rows == loaded._doc_rows
    assert sorted(live._graduated) == sorted(loaded._graduated)
    for d in sorted(set(live._doc_rows) | set(live._graduated)):
        assert live.read_text(d) == loaded.read_text(d), d
        assert live.deli.doc_seq(d) == loaded.deli.doc_seq(d), d

KW = dict(n_docs=6, capacity=64, batch_window=8, compact_every=2,
          sequencer="native")


def _op(eng, doc, cs, contents, client=1):
    msg, nack = eng.submit(doc, client, cs, eng.deli.doc_seq(doc), contents)
    assert nack is None, nack
    return msg.seq


def _ins(pos, text="M"):
    return {"mt": "insert", "kind": 0, "pos": pos, "text": text}


class Feed:
    """The same ops into every engine, with per-(doc, client) clientSeqs."""

    def __init__(self, engines):
        self.engines = engines
        self.cs = {}
        self.seqs = {}   # (doc, client, clientSeq) → seq

    def op(self, doc, contents, client=1):
        key = (doc, client)
        self.cs[key] = self.cs.get(key, 0) + 1
        seqs = {_op(e, doc, self.cs[key], contents, client)
                for e in self.engines}
        assert len(seqs) == 1
        self.seqs[(doc, client, self.cs[key])] = seqs.pop()


def _grow(feed):
    """d0 outgrows the capacity for good (graduates); d1 outgrows it, then
    tombstones most of it (re-uploads); d2 carries annotations."""
    for eng in feed.engines:
        eng.auto_recover = False
        for d in ("d0", "d1", "d2", "d3"):
            eng.connect(d, 1)
        eng.connect("d2", 2)
    for _ in range(80):
        feed.op("d0", _ins(0))
        feed.op("d1", _ins(0))
    for _ in range(75):
        feed.op("d1", {"mt": "remove", "start": 0, "end": 1})
    for i in range(6):
        feed.op("d2", _ins(0, f"t{i}"), client=1 + i % 2)
    feed.op("d2", {"mt": "annotate", "start": 1, "end": 5,
                   "props": {"bold": True}})
    feed.op("d3", _ins(0, "x"))
    reports = []
    for eng in feed.engines:
        eng.flush()
        eng.heartbeat("d1", 1, eng.deli.doc_seq("d1"))
        reports.append(eng.recover_overflowed())
        eng.auto_recover = True
    assert reports[0] == reports[1] == {"d0": "graduated",
                                        "d1": "reuploaded"}


def _check_dup_acks(engines, feed, keys):
    for doc, client, cs in keys:
        for eng in engines:
            msg, nack = eng.submit(doc, client, cs, 0, _ins(0))
            assert msg is None and nack.reason == NackReason.DUPLICATE
            assert nack.seq == feed.seqs[(doc, client, cs)], (doc, cs)


def test_full_summary_and_tail_load_match_jax():
    j, t = JEngine(**KW), TEngine(**KW, device="cpu")
    feed = Feed((j, t))
    _grow(feed)
    sj, st = j.summarize(), t.summarize()
    assert sj["kind"] == st["kind"] == "full"
    assert sj["log_offsets"] == st["log_offsets"]
    assert sj["doc_rows"] == st["doc_rows"]
    assert sorted(st["graduated"]) == ["d0"]
    for i in range(5):   # the tail: the graduated doc, a flat doc, a new doc
        feed.op("d0", _ins(i, "T"))
        feed.op("d3", _ins(0, "y"))
    for eng in (j, t):
        eng.connect("d4", 1)
    feed.op("d4", _ins(0, "new"))
    lj = JEngine.load(sj, j.log, sequencer="native")
    lt = TEngine.load(st, t.log, device="cpu", sequencer="native")
    same_engine(lj, lt)
    same_texts(j, lt)
    assert lt.doc_row("d4") == j.doc_row("d4")   # d0's released row
    assert lt.get_properties("d2", 2) == lj.get_properties("d2", 2) == \
        {"bold": True}
    _check_dup_acks((lj, lt), feed, [("d2", 2, 2), ("d0", 1, 83),
                                     ("d3", 1, 3)])


def test_incremental_chain_and_depth_cap_match_jax():
    j, t = JEngine(**KW), TEngine(**KW, device="cpu")
    feed = Feed((j, t))
    for eng in (j, t):
        eng.auto_recover = False
        for d in ("d0", "d1", "d2", "d3"):
            eng.connect(d, 1)
    feed.op("d2", _ins(0, "base"))
    summaries = [(j.summarize(), t.summarize())]
    # delta 1: d0 graduates and d1 re-uploads (rows rewritten outside the
    # op stream), d2 idles
    for eng in (j, t):
        eng.connect("d2", 2)
    _grow_after = [("d0", 80), ("d1", 80)]
    for doc, n in _grow_after:
        for _ in range(n):
            feed.op(doc, _ins(0))
    for _ in range(75):
        feed.op("d1", {"mt": "remove", "start": 0, "end": 1})
    for eng in (j, t):
        eng.flush()
        eng.heartbeat("d1", 1, eng.deli.doc_seq("d1"))
    assert j.recover_overflowed() == t.recover_overflowed() == \
        {"d0": "graduated", "d1": "reuploaded"}
    summaries.append((j.summarize(incremental=True),
                      t.summarize(incremental=True)))
    # delta 2: the graduated doc, a doc reusing d0's row, a leave
    feed.op("d0", _ins(3, "G"))
    for eng in (j, t):
        eng.connect("d5", 1)
        eng.disconnect("d3", 1)
    feed.op("d5", _ins(0, "five"))
    summaries.append((j.summarize(incremental=True),
                      t.summarize(incremental=True)))
    for sj, st in summaries[1:]:
        assert sj["kind"] == st["kind"] == "delta"
        assert sorted(sj["store_delta"]["rows"].tolist()) == \
            sorted(st["store_delta"]["rows"].tolist())
        assert sj["members_delta"] == st["members_delta"]
        assert sj["dedup"] == st["dedup"]
    feed.op("d2", _ins(1, "tail"), client=2)
    sj, st = summaries[-1]
    lj = JEngine.load(sj, j.log, sequencer="native")
    lt = TEngine.load(st, t.log, device="cpu", sequencer="native")
    same_engine(lj, lt)
    same_texts(j, lt)
    assert lt._members == j._members
    assert lt._dedup.last("d2", 2) == lj._dedup.last("d2", 2) == 1
    _check_dup_acks((lj, lt), feed, [("d2", 2, 1), ("d1", 1, 100)])
    # the chain-depth cap: past it an incremental summary is full
    for eng in (j, t):
        eng.max_incremental_chain = 2
    assert j.summarize(incremental=True)["kind"] == \
        t.summarize(incremental=True)["kind"] == "full"


def _port_record(rec):
    """A JAX log record rebuilt as the port's, from its plain fields."""
    if isinstance(rec, JColumnarOps):
        return ColumnarOps(
            list(rec.doc_ids), *(np.asarray(getattr(rec, f)).copy() for f in
                                 ("doc", "client", "client_seq", "ref_seq",
                                  "seq", "min_seq", "kind", "a0", "a1")),
            text=rec.text, timestamp=rec.timestamp, texts=rec.texts,
            props=rec.props,
            tidx=None if rec.tidx is None else np.asarray(rec.tidx).copy())
    assert isinstance(rec, JMessage)
    return SequencedDocumentMessage(
        doc_id=rec.doc_id, client_id=rec.client_id,
        client_seq=rec.client_seq, ref_seq=rec.ref_seq, seq=rec.seq,
        min_seq=rec.min_seq, type=MessageType(int(rec.type)),
        contents=copy.deepcopy(rec.contents), timestamp=rec.timestamp)


def test_jax_summary_and_log_load_into_the_port():
    """A JAX engine's summary (plain data) and its log, carried across,
    load into the port: same texts, digests, rows and sequencing."""
    R, O = 8, 16
    j = JEngine(n_docs=R, capacity=96, batch_window=8, compact_every=1,
                sequencer="native")
    docs = [f"doc-{i}" for i in range(R)]
    for d in docs:
        j.connect(d, 1)
    rows = np.array([j.doc_row(d) for d in docs], np.int32)

    def wave(b):
        planes, _ = typing_storm(R, O, seed=b)
        cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                       dtype=np.int32), (R, O))
        j.ingest_planes(rows, np.ones((R, O), np.int32), cs, cs,
                        planes["kind"], planes["a0"], planes["a1"], "abcd")

    for b in range(3):
        wave(b)
    j.submit(docs[0], 1, 3 * O + 1, j.deli.doc_seq(docs[0]),
             {"mt": "annotate", "start": 0, "end": 3, "props": {"k": 7}})
    summary = j.summarize()
    wave_cs = 3 * O + 2
    planes, _ = typing_storm(R, O, seed=9)
    cs = np.broadcast_to(np.arange(wave_cs, wave_cs + O, dtype=np.int32),
                         (R, O)).copy()
    cs[1:] -= 1       # doc 0 spent one clientSeq on the annotate
    j.ingest_planes(rows, np.ones((R, O), np.int32), cs, cs,
                    planes["kind"], planes["a0"], planes["a1"], "abcd")
    log = PartitionedLog(j.log.n_partitions)
    for p in range(j.log.n_partitions):
        for rec in j.log.read(p):
            log.append(p, _port_record(rec))
    lj = JEngine.load(summary, j.log, sequencer="native")
    lt = TEngine.load(summary, log, device="cpu", sequencer="native")
    same_engine(lj, lt)
    props = [lt.get_properties(docs[0], p)
             for p in range(len(lt.read_text(docs[0])))]
    assert props == [lj.get_properties(docs[0], p)
                     for p in range(len(props))]
    assert {"k": 7} in props
    # sequencing resumes at the same seq in both
    for eng in (lj, lt):
        eng.submit(docs[2], 1, int(cs[2, -1]) + 1,
                   eng.deli.doc_seq(docs[2]), {"mt": "insert", "kind": 0,
                                               "pos": 0, "text": "z"})
    same_engine(lj, lt)


def test_load_refuses_what_is_not_ported():
    t = TEngine(**KW, device="cpu")
    t.connect("d0", 1)
    Feed((t,)).op("d0", _ins(0, "a"))
    base = t.summarize()
    bad = [dict(base, mega_rows={"m": 0}),
           dict(base, attribution={"d0": {}})]
    for summary in bad:
        with pytest.raises(ValueError):
            TEngine.load(summary, t.log, device="cpu", sequencer="native")
    with pytest.raises(OplogCorruptionError):
        TEngine.load(base, PartitionedLog(t.log.n_partitions), device="cpu",
                     sequencer="native")


def test_load_takes_a_summary_with_intervals():
    """The summary that the refusal test above once refused for its
    intervals now loads, anchors and counter included; so does a JAX
    engine's summary with intervals."""
    t = TEngine(**KW, device="cpu")
    t.connect("d0", 1)
    Feed((t,)).op("d0", _ins(0, "a"))
    base = t.summarize()
    summary = dict(base, store=dict(base["store"],
                                    intervals=[{"i": [None, None, {}]}]
                                    + [{}] * 5, interval_counter=1))
    lt = TEngine.load(summary, t.log, device="cpu", sequencer="native")
    assert lt.store.intervals(0) == {"i": (0, 0, {})}
    assert lt.store.add_interval(0, 0, 0) == "iv2"
    j = JEngine(**KW)
    j.connect("d0", 1)
    Feed((j,)).op("d0", _ins(0, "abc"))
    j.flush()
    iid = j.store.add_interval(j.doc_row("d0"), 1, 2, {"c": 3})
    summary = j.summarize()
    log = PartitionedLog(j.log.n_partitions)
    for p in range(j.log.n_partitions):
        for rec in j.log.read(p):
            log.append(p, _port_record(rec))
    lt = TEngine.load(summary, log, device="cpu", sequencer="native")
    assert lt.store.intervals(lt.doc_row("d0")) == {iid: (1, 2, {"c": 3})}


# ------------------------------------------------------------- sequencers

def _drive(deli, jax_side):
    """One stream of joins, ops, heartbeats and a leave; returns the
    stamped (seq, min_seq) pairs."""
    out = []
    mt = JMessageType if jax_side else MessageType
    for d in ("a", "b%\tc\n"):
        for c in (1, 2, 3):
            deli.client_join(d, c)
    for i in range(1, 13):
        d = "a" if i % 3 else "b%\tc\n"
        c = 1 + i % 3
        cs = (i + 2) // 3
        msg, nack = deli.sequence(d, c, cs, i // 2, mt.OP, {"i": i})
        out.append((msg.seq, msg.min_seq) if msg else int(nack.reason))
    deli.client_leave("a", 2)
    deli.sequence("a", 1, 0, 9, mt.NOOP, None)
    return out


def test_python_sequencer_checkpoints_match_jax():
    j, t = JDeli(), TDeli()
    assert _drive(j, True) == _drive(t, False)
    ck = t.checkpoint()
    assert ck == j.checkpoint()
    # each package restores the other's checkpoint; all continue alike
    nxt = set()
    for r, mt in ((TDeli.restore(j.checkpoint()), MessageType),
                  (JDeli.restore(ck), JMessageType), (j, JMessageType)):
        msg, _ = r.sequence("a", 1, 1, 20, mt.OP, {})
        nxt.add((msg.seq, msg.min_seq))
    assert len(nxt) == 1
    # replay advances the counters past an already-sequenced message
    r = TDeli.restore(ck)
    r.replay(SequencedDocumentMessage("a", 3, 9, 11, 40, 12,
                                      MessageType.OP))
    assert r.doc_seq("a") == 40
    assert r.checkpoint()["a"]["clients"]["3"] == [9, 11]


def test_native_sequencer_checkpoints_match_jax():
    j, t = jnative.NativeDeliAdapter(), tnative.NativeDeliAdapter()
    assert _drive(j, True) == _drive(t, False)
    blob = t.raw.checkpoint()
    assert blob == j.raw.checkpoint()
    assert t.checkpoint() == j.checkpoint() == \
        {"native": blob.decode("latin1")}
    nxt = set()
    for r in (tnative.NativeDeliAdapter.restore(j.checkpoint()),
              jnative.NativeDeliAdapter.restore(t.checkpoint()), j):
        msg, _ = r.sequence("b%\tc\n", 2, 1, 3, MessageType.OP, {})
        nxt.add((msg.seq, msg.min_seq))
    assert len(nxt) == 1
    r = tnative.NativeDeliAdapter.restore({"native": blob.decode("latin1")})
    r.replay(SequencedDocumentMessage("a", 3, 9, 11, 40, 12,
                                      MessageType.OP))
    assert r.doc_seq("a") == 40
