"""Intervals on the port's string store and engine (``device="cpu"``, plain
versions) against the JAX package fed the same inputs: anchors, the
tombstone heaps and window floors, the cut of a batch where a doc's floor
crosses a tombstone (per-message groups, columnar segments), slides at
heartbeats and compactions, the per-op handle mint, the pipeline's inline
fallback, re-anchoring after recovery, and summaries loaded both ways.
The pure-Python ``IntervalCollection`` oracle is a third witness where the
JAX tests use it. Tolerance: exact (planes bit-identical, slots past
``count`` included, where no compaction ran; ``[0, count)`` and digests
after one)."""

import random

import numpy as np
import pytest

from fluidframework_tpu.core.protocol import MessageType as JMessageType
from fluidframework_tpu.models.interval_collection import IntervalCollection
from fluidframework_tpu.models.merge_tree import LOCAL_VIEW
from fluidframework_tpu.ops.schema import OpKind
from fluidframework_tpu.ops.string_store import TensorStringStore as JStore
from fluidframework_tpu.server.serving import StringServingEngine as JEngine
from fluidframework_tpu.testing.mocks import MockSequencer
from fluidframework_tpu_torch.core.protocol import (
    MessageType, SequencedDocumentMessage,
)
from fluidframework_tpu_torch.ops.merge_tree import PLANES
from fluidframework_tpu_torch.ops.string_store import (
    TensorStringStore as TStore,
)
from fluidframework_tpu_torch.server.ingest_pipeline import (
    PipelinedIngestExecutor as TExecutor,
)
from fluidframework_tpu_torch.server.serving import (
    StringServingEngine as TEngine,
)
from tests.test_interval_columnar import (
    BASE_TEXT, IV_PROPS, IV_TEXTS, _oracle_endpoints, _wave,
)
from tests.test_merge_tree_kernel import collab_stream
from tests.test_torch_recovery import same_engine
from tests.test_torch_summary import Feed, _ins


def same_planes(js, ts, whole=True):
    """Every plane of the two stores equal: whole rows (``whole``), else
    ``[0, count)`` and the digests (after a compaction)."""
    count = np.asarray(js.state.count)
    assert np.array_equal(count, ts.state.count.numpy())
    assert np.array_equal(np.asarray(js.state.overflow),
                          ts.state.overflow.numpy())
    assert np.array_equal(js.digests(), ts.digests())
    for k in PLANES + ("prop_val",):
        a, b = np.asarray(getattr(js.state, k)), getattr(ts.state, k).numpy()
        if whole:
            assert np.array_equal(a, b), k
        else:
            for d in range(len(count)):
                assert np.array_equal(a[d, :count[d]], b[d, :count[d]]), \
                    (k, d)
    assert js._payloads == ts._payloads


def same_intervals(js, ts, rows=None, seeded=False):
    """The same anchors, ids, props, counter, floors and heaps, and the
    same endpoints resolved off the planes. A heap seeded from the planes
    (``seeded``: a loaded store) holds a seq once a tombstoned slot, a live
    one once a remove, so there only their sets must agree."""
    rows = range(js.n_docs) if rows is None else rows
    heap = set if seeded else sorted
    assert js._interval_counter == ts._interval_counter
    for r in rows:
        assert js._intervals[r] == ts._intervals[r], r
        assert js._iv_min_seq[r] == ts._iv_min_seq[r], r
        assert heap(js._iv_tombs[r]) == heap(ts._iv_tombs[r]), r
        assert (r in js._iv_docs) == (r in ts._iv_docs), r
        if js._intervals[r]:
            assert js.intervals(r) == ts.intervals(r), r


# ------------------------------------------------------------ per-op path

@pytest.mark.parametrize("seed", range(3))
def test_store_per_op_crossings_match_jax_and_oracle(seed):
    """``tests/test_merge_tree_kernel.py``'s interval storm: anchors slide
    at the messages where the floor crosses a tombstone and re-anchor at
    zamboni; the port's groups, planes and anchors equal the JAX store's
    and the endpoints the oracle's."""
    rng = random.Random(seed)
    text, length, msgs, clients = collab_stream(
        seed, n_rounds=10, return_clients=True)
    j, t = JStore(n_docs=1, capacity=1024), TStore(1, 1024, device="cpu")
    groups = {"j": [], "t": []}
    orig_j, orig_t = j._apply_batch, t._apply_group
    j._apply_batch = lambda g: (groups["j"].append(len(g)), orig_j(g))[1]
    t._apply_group = lambda g: (groups["t"].append(len(g)), orig_t(g))[1]
    for s in (j, t):
        s.apply_messages((0, m) for m in msgs)
    oracle = clients[0]
    coll = IntervalCollection("c", oracle.tree)
    ivs = []
    for i in range(6):
        if length < 2:
            break
        s = rng.randrange(length - 1)
        e = rng.randint(s + 1, length - 1)
        coll.apply_add(f"iv{i}", s, e, {}, LOCAL_VIEW, oracle.client_id)
        ids = {j.add_interval(0, s, e, {"n": i}),
               t.add_interval(0, s, e, {"n": i})}
        assert len(ids) == 1
        ivs.append((f"iv{i}", ids.pop()))

    def check(whole=True):
        same_planes(j, t, whole)
        same_intervals(j, t)
        for oid, sid in ivs:
            assert t.interval_endpoints(0, sid) == \
                coll.endpoints(coll.get(oid)), oid

    check()
    seqr = MockSequencer()
    seqr.seq = max(m.seq for m in msgs)
    for c in clients:
        seqr.connect(c)
    more = []
    orig = seqr.process_one

    def capture():
        m = orig()
        if m is not None and m.type == JMessageType.OP:
            more.append(m)
        return m
    seqr.process_one = capture
    from fluidframework_tpu.testing.fuzz import _rand_text
    for _ in range(40):
        c = rng.choice(clients)
        n = c.get_length()
        if n == 0 or rng.random() < 0.5:
            seqr.submit(c, c.insert_text_local(rng.randint(0, n),
                                               _rand_text(rng)))
        else:
            s = rng.randrange(n)
            seqr.submit(c, c.remove_range_local(
                s, rng.randint(s + 1, min(n, s + 8))))
        seqr.process_some(rng.randint(0, seqr.outstanding))
    seqr.process_all_messages()
    groups["j"].clear()
    groups["t"].clear()
    for s in (j, t):
        s.apply_messages((0, m) for m in more)
    assert groups["j"] == groups["t"]
    check()
    max_seq = max(m.seq for m in more) if more else seqr.seq
    oracle.tree.zamboni(max_seq)
    for s in (j, t):
        s.compact(max_seq)
    check(whole=False)
    assert t.read_text(0) == oracle.get_text()


def test_per_op_batch_stays_whole_until_a_crossing():
    """``tests/test_review_regressions.py``'s case: a floor advance on an
    interval doc cuts the batch only where it dooms a tombstone."""
    def mk(seq, min_seq, contents):
        return SequencedDocumentMessage(
            doc_id="d", client_id=1, client_seq=seq, ref_seq=seq - 1,
            seq=seq, min_seq=min_seq, type=MessageType.OP,
            contents=contents)

    store = TStore(1, capacity=256, device="cpu")
    store.apply_messages([(0, mk(1, 0, {"mt": "insert", "kind": 0,
                                        "pos": 0, "text": "hello world"}))])
    iid = store.add_interval(0, 2, 7)
    groups = []
    orig = store._apply_group
    store._apply_group = lambda g: (groups.append(len(g)), orig(g))[1]
    stream = [(0, mk(s, s - 1, {"mt": "insert", "kind": 0, "pos": 0,
                                "text": "x"})) for s in range(2, 18)]
    store.apply_messages(stream)
    assert groups == [len(stream)]
    groups.clear()
    stream2 = [(0, mk(18, 16, {"mt": "remove", "start": 16, "end": 19}))]
    stream2 += [(0, mk(s, 17, {"mt": "insert", "kind": 0, "pos": 0,
                               "text": "y"})) for s in (19, 20)]
    stream2 += [(0, mk(s, 19, {"mt": "insert", "kind": 0, "pos": 0,
                               "text": "z"})) for s in (21, 22)]
    store.apply_messages(stream2)
    assert groups == [4, 1]   # cut once, after the crossing message
    # the removed start slid to the first following live char
    assert store.interval_endpoints(0, iid) == (20, 24)
    text = store.read_text(0)
    assert text[20] + text[24] == "lo"


# ---------------------------------------------------------- columnar path

def _iv_engines(n_docs, seed, n_spans=3, **kw):
    """A JAX and a port engine, each with BASE_TEXT in every doc and the
    same ``n_spans`` bulk-added intervals a doc (``_iv_engine``'s spans)."""
    rng = random.Random(seed)
    args = dict(n_docs=n_docs, capacity=128, batch_window=10 ** 9,
                compact_every=10 ** 9, sequencer="native")
    args.update(kw)
    engines = (JEngine(**args), TEngine(**args, device="cpu"))
    docs = [f"iv-{i}" for i in range(n_docs)]
    for eng in engines:
        for d in docs:
            eng.connect(d, 1)
            _, nack = eng.submit(d, 1, 1, 0, {"mt": "insert", "kind": 0,
                                              "pos": 0, "text": BASE_TEXT,
                                              "clientSeq": 1})
            assert nack is None
        eng.flush()
    req = {}
    for d in docs:
        spans = []
        for _k in range(n_spans):
            s = rng.randrange(len(BASE_TEXT) - 8)
            spans.append((s, s + 2 + rng.randrange(5), None))
        req[engines[0].doc_row(d)] = spans
    ids = [eng.store.add_intervals_bulk(req) for eng in engines]
    assert ids[0] == ids[1]
    return engines, docs, ids[0], req


def _record_splits(store, out):
    orig = store._interval_scan

    def scan(*a):
        splits = orig(*a)
        out.append(dict(splits))
        return splits
    store._interval_scan = scan


@pytest.mark.parametrize("seed", [5, 23])
def test_columnar_interval_fuzz_matches_jax_and_oracle(seed):
    """``tests/test_interval_columnar.py``'s fuzz: mixed annotate / insert
    / remove waves whose refs pin at the wave's first seq, so floors cross
    the previous wave's tombstones mid-wave. Each wave's segment
    boundaries, every plane and every anchor equal the JAX engine's; texts
    and endpoints equal the oracle replay."""
    n_docs, ow, waves = 8, 8, 5
    rng = random.Random(seed)
    (j, t), docs, ids, req = _iv_engines(n_docs, seed)
    splits = {"j": [], "t": []}
    _record_splits(j.store, splits["j"])
    _record_splits(t.store, splits["t"])
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    client = np.ones((n_docs, ow), np.int32)
    lengths = [len(BASE_TEXT)] * n_docs
    segs = []
    for w in range(waves):
        kind, a0, a1, tix, cseq, ref = _wave(rng, n_docs, ow, w, lengths)
        for eng in (j, t):
            res = eng.ingest_planes(rows, client, cseq, ref, kind, a0, a1,
                                    texts=IV_TEXTS, tidx=tix, props=IV_PROPS)
            assert res["nacked"] == 0
        assert splits["j"][-1] == splits["t"][-1], w
        stats = t.store.last_apply_stats
        assert stats["segments"] == \
            j.store.last_apply_stats["segments"] == len(stats["widths"])
        assert sum(stats["widths"]) == ow
        segs.append(stats["segments"])
        same_planes(j.store, t.store)
        same_intervals(j.store, t.store)
    assert all(s >= 2 for s in segs[1:]), segs
    for di, d in enumerate(docs):
        row = t.doc_row(d)
        spans = [(s, e, sid) for (s, e, _), sid in zip(req[row], ids[row])]
        want_text, want_eps = _oracle_endpoints(j, d, spans)
        assert t.read_text(d) == want_text, d
        for k, (_s, _e, sid) in enumerate(spans):
            assert t.store.interval_endpoints(row, sid) == want_eps[k]


def test_interval_rows_mint_per_op_handles_and_others_keep_tables():
    """An interval row's inserts mint one payload handle each (the
    resolved a2 plane on the wire); the same wave on interval-free rows
    keeps the deduplicated table wire. Both as the JAX engine."""
    n_docs, ow = 8, 8
    (j, t), docs, _, _ = _iv_engines(n_docs, 7)
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    kind, a0, a1, tix, cseq, ref = _wave(random.Random(7), n_docs, ow, 0,
                                         [len(BASE_TEXT)] * n_docs)
    n_pay = len(t.store._payloads)
    for eng in (j, t):
        eng.ingest_planes(rows, np.ones((n_docs, ow), np.int32), cseq, ref,
                          kind, a0, a1, texts=IV_TEXTS, tidx=tix,
                          props=IV_PROPS)
    assert t.store.last_rich_wire == j.store.last_rich_wire == "plane"
    assert len(t.store._payloads) - n_pay == \
        int((kind == OpKind.STR_INSERT).sum()) > 0
    same_planes(j.store, t.store)
    # the interval-free twin of the same wave
    for eng in (j, t):
        for r in list(eng.store._iv_docs):
            for iid in list(eng.store._intervals[r]):
                eng.store.remove_interval(r, iid)
        assert not eng.store._iv_docs
        eng.ingest_planes(rows, np.ones((n_docs, ow), np.int32),
                          cseq + ow, ref + ow, kind, a0, a1,
                          texts=IV_TEXTS, tidx=tix, props=IV_PROPS)
    assert t.store.last_rich_wire == j.store.last_rich_wire
    assert t.store.last_rich_wire in ("tab8", "tab16")
    assert t.store.last_apply_stats["segments"] == 1
    same_planes(j.store, t.store)


def test_columnar_compaction_with_intervals_runs_after_the_segments():
    """A compaction-due wave on a store holding intervals: zamboni is not
    fused into the launch; ``compact`` runs after the segments and
    re-anchors first, as in the JAX store."""
    n_docs, ow = 4, 8
    rng = random.Random(11)
    (j, t), docs, _, _ = _iv_engines(n_docs, 11, compact_every=2)
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    lengths = [len(BASE_TEXT)] * n_docs
    compacts = []
    orig = t.store.compact
    t.store.compact = lambda ms: (compacts.append(1), orig(ms))[1]
    launches = []
    orig_d = t.store._dispatch_apply
    t.store._dispatch_apply = lambda p, m=None: (launches.append(m),
                                                 orig_d(p, m))[1]
    for w in range(4):
        kind, a0, a1, tix, cseq, ref = _wave(rng, n_docs, ow, w, lengths)
        for eng in (j, t):
            eng.ingest_planes(rows, np.ones((n_docs, ow), np.int32), cseq,
                              ref, kind, a0, a1, texts=IV_TEXTS, tidx=tix,
                              props=IV_PROPS)
        same_planes(j.store, t.store, whole=False)
        same_intervals(j.store, t.store)
    assert compacts and all(m is None for m in launches)
    for d in docs:
        assert t.read_text(d) == j.read_text(d)


# ------------------------------------------------------ heartbeat, pipeline

def test_heartbeat_slides_like_jax():
    """A floor advance carried only by a heartbeat slides the anchors off
    a doomed tombstone at once; a heartbeat on a doc with no row stays
    rowless."""
    engines = (JEngine(n_docs=4, capacity=64, batch_window=10 ** 9,
                       compact_every=10 ** 9, sequencer="native"),
               TEngine(n_docs=4, capacity=64, batch_window=10 ** 9,
                       compact_every=10 ** 9, sequencer="native",
                       device="cpu"))
    feed = Feed(engines)
    for eng in engines:
        eng.connect("d", 1)
        eng.connect("d", 2)
        eng.connect("idle", 3)
    feed.op("d", _ins(0, "hello brave new world"))
    for eng in engines:
        eng.flush()
        eng.store.add_interval(eng.doc_row("d"), 6, 10, {"k": 1})
    # client 2 lags at ref 0, so client 1's remove stays above the floor
    feed.op("d", {"mt": "remove", "start": 6, "end": 12})
    for eng in engines:
        eng.flush()
        eng.heartbeat("d", 1, eng.deli.doc_seq("d"))
        eng.heartbeat("d", 2, eng.deli.doc_seq("d"))
        eng.heartbeat("idle", 3, 0)
        assert "idle" not in eng._doc_rows
    j, t = engines
    same_intervals(j.store, t.store)
    row = t.doc_row("d")
    anchors = t.store._intervals[row]["iv1"]
    assert anchors[0] == anchors[1]   # both ends slid to the same char
    assert t.store.interval_endpoints(row, "iv1") == (6, 6)
    for eng in engines:
        eng.compact()
    same_planes(j.store, t.store, whole=False)
    same_intervals(j.store, t.store)


def _race_engines():
    return _iv_engines(4, 3, n_spans=2, compact_every=2)


def test_pipeline_race_falls_back_to_the_inline_pack():
    """Intervals added on a targeted row after the wave was prepacked:
    dispatch drops the prepacked tables and packs inline (per-op handles),
    as the JAX engine does; state and anchors equal."""
    (j, t), docs, _, _ = _race_engines()
    for eng in (j, t):   # start interval-free
        for r in list(eng.store._iv_docs):
            for iid in list(eng.store._intervals[r]):
                eng.store.remove_interval(r, iid)
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    rng = random.Random(3)
    kind, a0, a1, tix, cseq, ref = _wave(rng, 4, 8, 0,
                                         [len(BASE_TEXT)] * 4)
    for eng in (j, t):
        w = eng._ingest_prepare(rows, np.ones((4, 8), np.int32), cseq, ref,
                                kind, a0, a1, "", IV_TEXTS, tix, IV_PROPS,
                                prepack=True)
        assert w.prepacked is not None
        eng.store.add_intervals_bulk({int(rows[1]): [(2, 9, {"x": 1})]})
        eng._ingest_sequence(w)
        eng._ingest_dispatch(w)
        assert w.prepacked is None
        eng._ingest_log(w)
    assert t.store.last_rich_wire == j.store.last_rich_wire == "plane"
    same_planes(j.store, t.store)
    same_intervals(j.store, t.store)


def test_pipelined_interval_waves_equal_serial_and_jax():
    """``tests/test_ingest_pipeline.py``'s interval waves: the executor
    holds the next pack behind a wave it could not prepack, so handles
    mint in submission order; pipelined equals serial equals JAX."""
    R, O = 8, 4
    rng = random.Random(5)
    waves, lengths = [], [len(BASE_TEXT)] * R
    for w in range(3):
        kind = np.zeros((R, O), np.int32)
        a0 = np.zeros((R, O), np.int32)
        a1 = np.zeros((R, O), np.int32)
        for di in range(R):
            ln = lengths[di]
            for c in range(O):
                if rng.random() < 0.5:
                    a0[di, c], a1[di, c] = rng.randrange(ln + 1), 2
                    ln += 2
                else:
                    s = rng.randrange(ln - 3)
                    kind[di, c] = 1
                    a0[di, c], a1[di, c] = s, s + 2
                    ln -= 2
            lengths[di] = ln
        cs = np.broadcast_to(np.arange(2 + w * O, 2 + (w + 1) * O,
                                       dtype=np.int32), (R, O))
        waves.append(dict(client=np.ones((R, O), np.int32), client_seq=cs,
                          ref_seq=np.full((R, O), 2 + w * O, np.int32),
                          kind=kind, a0=a0, a1=a1, text="XY"))

    def engines():
        (j, t), docs, _, _ = _iv_engines(R, 5, n_spans=2, compact_every=16)
        return j, t, np.array([t.doc_row(d) for d in docs], np.int32)

    j, t_serial, rows = engines()
    for w in waves:
        j.ingest_planes(rows, **w)
        t_serial.ingest_planes(rows, **w)
    _, t_pipe, _ = engines()
    with TExecutor(t_pipe, depth=3) as ex:
        tickets = [ex.submit(rows, **w) for w in waves]
        ex.drain()
        assert all(tk.result()["nacked"] == 0 for tk in tickets)
    for t in (t_serial, t_pipe):
        same_planes(j.store, t.store)
        same_intervals(j.store, t.store)


# --------------------------------------------------------------- recovery

KW_R = dict(n_docs=4, capacity=32, batch_window=4, compact_every=10 ** 9,
            sequencer="native")


def _overflowed_pair():
    """d0 outgrows the capacity for good (graduates), d1 outgrows it and
    tombstones most of it (re-uploads), d2 stays; d0 and d1 hold
    intervals, one of d1's over text its removes take."""
    j, t = JEngine(**KW_R), TEngine(**KW_R, device="cpu")
    feed = Feed((j, t))
    for eng in (j, t):
        eng.auto_recover = False
        for d in ("d0", "d1", "d2"):
            eng.connect(d, 1)
    for d in ("d0", "d1", "d2"):
        feed.op(d, _ins(0, "the quick brown fox"))
    for eng in (j, t):
        eng.flush()
        eng.store.add_intervals_bulk({
            eng.doc_row("d0"): [(4, 9, {"c": 1}), (10, 14, None)],
            eng.doc_row("d1"): [(0, 3, None), (16, 18, {"c": 2})]})
    for i in range(60):
        feed.op("d0", _ins(3, f"w{i}"))
        feed.op("d1", _ins(19))
    for _ in range(55):
        feed.op("d1", {"mt": "remove", "start": 0, "end": 1})
    for eng in (j, t):
        eng.flush()
        eng.heartbeat("d1", 1, eng.deli.doc_seq("d1"))
    return j, t, feed


def test_reupload_and_graduation_readd_intervals_like_jax():
    j, t, feed = _overflowed_pair()
    assert j.recover_overflowed() == t.recover_overflowed() == \
        {"d0": "graduated", "d1": "reuploaded"}
    same_engine(j, t)
    rows = [t.doc_row(d) for d in ("d1", "d2")]
    same_intervals(j.store, t.store, rows)
    assert t.store._intervals[rows[0]]
    jg, tg = j._graduated["d0"], t._graduated["d0"]
    assert jg._intervals == tg._intervals and tg._intervals[0]
    assert jg.intervals(0) == tg.intervals(0)
    assert sorted(jg._iv_tombs[0]) == sorted(tg._iv_tombs[0])
    # the graduated doc's old row goes to the next doc, clean (C8)
    for eng in (j, t):
        eng.connect("d3", 1)
    feed.op("d3", _ins(0, "reused"))
    assert t.doc_row("d3") == j.doc_row("d3")
    r3 = t.doc_row("d3")
    assert not t.store._intervals[r3] and r3 not in t.store._iv_docs
    assert t.store._iv_min_seq[r3] == 0 and not t.store._iv_tombs[r3]
    same_engine(j, t)


def test_graduated_interval_doc_regrows_like_jax():
    j, t, feed = _overflowed_pair()
    j.recover_overflowed()
    t.recover_overflowed()
    cap0 = t._graduated["d0"].capacity
    while not t._graduated["d0"].overflowed().any():
        feed.op("d0", _ins(5, "gg"))
        for eng in (j, t):
            eng.flush()
    assert j.recover_overflowed() == t.recover_overflowed() == \
        {"d0": "regrown"}
    assert t._graduated["d0"].capacity > cap0
    same_engine(j, t)
    jg, tg = j._graduated["d0"], t._graduated["d0"]
    assert jg._intervals == tg._intervals and tg._intervals[0]
    assert jg.intervals(0) == tg.intervals(0)


def test_graduated_intervals_keep_sliding():
    """After a graduation the port's store goes on sliding the doc's
    anchors (ROADMAP C8: the JAX store does so only after a load). Held
    against a JAX engine loaded from a summary taken right after the
    recovery."""
    j, t, feed = _overflowed_pair()
    j.recover_overflowed()
    t.recover_overflowed()
    lj = JEngine.load(j.summarize(), j.log, sequencer="native")
    t.summarize()
    feed.engines = (lj, t)
    tg = t._graduated["d0"]
    (iid, (a, _b, _p)), = [kv for kv in tg._intervals[0].items()
                          if kv[1][2] == {"c": 1}]
    start, end, _ = tg.intervals(0)[iid]
    feed.op("d0", {"mt": "remove", "start": start, "end": end + 1})
    feed.op("d0", _ins(0, "Z"))
    for eng in (lj, t):
        eng.flush()
        eng.compact()
    assert tg._intervals[0][iid][0] != a       # slid off the removed text
    same_engine(lj, t)
    assert lj._graduated["d0"].intervals(0) == tg.intervals(0)


# -------------------------------------------------------------- summaries

def _summary_engines():
    (j, t), docs, ids, _ = _iv_engines(4, 9, n_spans=2)
    feed = Feed((j, t))
    feed.cs = {(d, 1): 1 for d in docs}
    for d in docs:
        feed.op(d, {"mt": "remove", "start": 3, "end": 9})
        feed.op(d, _ins(1, "ab"))
    return j, t, feed, docs


def _same_loaded(a, b):
    """Two engines (either package) hold the same intervals."""
    same_intervals(a.store, b.store, seeded=True)
    for d in a._graduated:
        assert a._graduated[d]._intervals == b._graduated[d]._intervals


def test_full_and_incremental_summaries_load_both_ways():
    j, t, feed, docs = _summary_engines()
    sj, st = j.summarize(), t.summarize()
    for key in ("intervals", "interval_counter", "iv_min_seq"):
        assert sj["store"][key] == st["store"][key], key
    loaded = [JEngine.load(sj, j.log, sequencer="native"),
              JEngine.load(st, j.log, sequencer="native"),
              TEngine.load(sj, t.log, device="cpu", sequencer="native"),
              TEngine.load(st, t.log, device="cpu", sequencer="native")]
    for eng in loaded:
        _same_loaded(t, eng)
    # the next interval id continues the counter in all of them
    row = t.doc_row(docs[0])
    new = {eng.store.add_interval(row, 0, 2) for eng in loaded + [j, t]}
    assert new == {f"iv{t.store._interval_counter}"}
    # an incremental summary after ops, a removed and an added interval
    for d in docs[:2]:
        feed.op(d, {"mt": "remove", "start": 0, "end": 2})
    for eng in (j, t):
        r = eng.doc_row(docs[1])
        eng.store.remove_interval(r, next(iter(eng.store._intervals[r])))
        eng.store.add_interval(eng.doc_row(docs[2]), 4, 6, {"z": 0})
    dj, dt = j.summarize(incremental=True), t.summarize(incremental=True)
    assert dj["kind"] == dt["kind"] == "delta"
    assert dj["store_delta"]["intervals"] == dt["store_delta"]["intervals"]
    for summary in (dj, dt):
        for eng in (JEngine.load(summary, j.log, sequencer="native"),
                    TEngine.load(summary, t.log, device="cpu",
                                 sequencer="native")):
            _same_loaded(t, eng)
            assert eng.read_text(docs[0]) == t.read_text(docs[0])


def test_store_snapshot_round_trip_both_ways():
    """``tests/test_merge_tree_kernel.py``'s snapshot round trip, across
    the packages: anchors, ids and floors survive, and a fresh id does not
    collide."""
    _, length, msgs, _ = collab_stream(4, return_clients=True)
    j = JStore(1, 512)
    j.apply_messages((0, m) for m in msgs)
    iid = j.add_interval(0, 2, min(9, length - 1), {"note": "keep"})
    t = TStore.from_jax_snapshot(j.snapshot(), device="cpu")
    back = JStore.restore(t.snapshot())
    for s in (t, back):
        assert s.interval_endpoints(0, iid) == j.interval_endpoints(0, iid)
        assert s.intervals(0)[iid][2] == {"note": "keep"}
        assert (s._iv_min_seq == j._iv_min_seq).all()
        assert s.add_interval(0, 0, 1) != iid


def test_chip_phase_slice_matches_jax():
    """The chip smoke's interval phase at a small size: every doc holds the
    base text, every 4th row 4 intervals with props, a warm-up and 4 waves
    of ``synthetic.interval_wave`` (compaction due every wave, so it runs
    unfused after the segments), the port's through its pipelined executor
    with heartbeats on half the interval docs between waves, the JAX engine's
    serially. Every wave past the warm-up is cut into segments; state and
    anchors equal the JAX engine's."""
    from fluidframework_tpu_torch.testing import synthetic
    D, O = 16, 16
    args = dict(n_docs=D, capacity=256, batch_window=10 ** 9,
                compact_every=1, sequencer="native")
    j, t = JEngine(**args), TEngine(**args, device="cpu")
    docs = [f"doc-{i}" for i in range(D)]
    rows = np.arange(D, dtype=np.int32)
    iv_rows = rows[::4]
    spans = {int(r): [(2 + k, 6 + 3 * k, {"note": k}) for k in range(4)]
             for r in iv_rows}
    base = dict(client=np.ones((D, 1), np.int32),
                client_seq=np.ones((D, 1), np.int32),
                ref_seq=np.zeros((D, 1), np.int32),
                kind=np.zeros((D, 1), np.int32), a0=np.zeros((D, 1), np.int32),
                a1=np.zeros((D, 1), np.int32),
                text=synthetic.IV_BASE_TEXT)
    for eng in (j, t):
        for d in docs:
            eng.connect(d, 1)
        assert [eng.doc_row(d) for d in docs] == rows.tolist()
        eng.ingest_planes(rows, **base)
        eng.store.add_intervals_bulk(spans)
    rng = np.random.default_rng(3)
    lengths = np.full(D, len(synthetic.IV_BASE_TEXT), np.int64)
    waves = [synthetic.interval_wave(rng, lengths, O, w) for w in range(5)]
    segments = []
    orig = t.store.apply_planes

    def apply_planes(*a, **kw):
        orig(*a, **kw)
        segments.append(t.store.last_apply_stats["segments"])
    t.store.apply_planes = apply_planes

    def heartbeats(eng, ref):
        # at the next wave's pinned ref, on half the interval docs: their
        # floor passes this group's tombstones outside the op stream
        for r in iv_rows[::2]:
            eng.heartbeat(docs[r], 1, ref)

    with TExecutor(t, depth=3) as ex:
        for lo, hi in ((0, 1), (1, 3), (3, 5)):
            tickets = [ex.submit(rows, **w) for w in waves[lo:hi]]
            ex.drain()
            assert [tk.result()["nacked"] for tk in tickets] == \
                [0] * (hi - lo)
            heartbeats(t, 2 + hi * O)
            for w in waves[lo:hi]:
                assert j.ingest_planes(rows, **w)["nacked"] == 0
            heartbeats(j, 2 + hi * O)
    assert segments[0] == 1 and all(s >= 2 for s in segments[1:]), segments
    same_planes(j.store, t.store, whole=False)
    same_intervals(j.store, t.store)
    for d in docs:
        assert j.read_text(d) == t.read_text(d)
