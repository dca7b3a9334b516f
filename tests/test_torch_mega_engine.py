"""The mega tier of the port's StringServingEngine (``device="cpu"``,
plain versions) against the JAX engine on the virtual 8-device CPU mesh,
fed the same submits.

Mirrors ``tests/test_serving.py``'s four mega-tier cases and
``tests/test_overflow_recovery.py``'s two mega overflow cases: the same
acks, texts, properties, recovery reports and mega-store state (planes,
counts, overflow flags, interner tables). Summaries load across the
packages in both directions, a ``markMega`` in the log tail included.
Tolerance: exact."""

import copy
import itertools
import random

import numpy as np
import pytest

from fluidframework_tpu.core.protocol import (
    SequencedDocumentMessage as JMessage,
)
from fluidframework_tpu.models.merge_tree_client import SequenceClient
from fluidframework_tpu.server.oplog import PartitionedLog as JLog
from fluidframework_tpu.server.serving import StringServingEngine as JEngine
from fluidframework_tpu_torch.core.protocol import (
    MessageType, SequencedDocumentMessage,
)
from fluidframework_tpu_torch.ops.megadoc_store import (
    MegaDocStringStore, live_slots,
)
from fluidframework_tpu_torch.ops.string_store import TensorStringStore
from fluidframework_tpu_torch.server import serving
from fluidframework_tpu_torch.server.oplog import PartitionedLog
from fluidframework_tpu_torch.server.serving import (
    StringServingEngine as TEngine,
)
from tests.test_serving import _drain, _run_storm
from tests.test_torch_megadoc_store import _assert_same


class Tee:
    """One engine of each package behind the engine calls the storms
    make: every submit goes to both and the acks must agree."""

    def __init__(self, **kw):
        self.j = JEngine(**kw)
        self.t = TEngine(**kw, device="cpu")

    def connect(self, doc, client):
        self.j.connect(doc, client)
        self.t.connect(doc, client)

    def mark_mega(self, doc):
        self.j.mark_mega(doc)
        self.t.mark_mega(doc)

    def submit(self, doc, client, cseq, ref, op):
        jm, jn = self.j.submit(doc, client, cseq, ref, copy.deepcopy(op))
        tm, tn = self.t.submit(doc, client, cseq, ref, copy.deepcopy(op))
        assert (jm is None) == (tm is None) and (jn is None) == (tn is None)
        if jm is not None:
            assert (jm.seq, jm.min_seq) == (tm.seq, tm.min_seq)
        return jm, jn

    @property
    def deli(self):
        return self.j.deli


def _mk(tee, docs, n_clients):
    clients = {}
    cid = 1
    for d in docs:
        clients[d] = []
        for _ in range(n_clients):
            tee.connect(d, cid)
            clients[d].append(SequenceClient(cid))
            cid += 1
    return clients


def _same_reads(j, t, docs):
    for d in docs:
        text = j.read_text(d)
        assert t.read_text(d) == text, d
        for pos in range(len(text)):
            assert t.get_properties(d, pos) == j.get_properties(d, pos)
    assert j._mega_rows == t._mega_rows
    assert sorted(j._graduated) == sorted(t._graduated)


def _port_log(jlog):
    """A JAX log carried across as the port's records."""
    log = PartitionedLog(jlog.n_partitions)
    for p in range(jlog.n_partitions):
        for rec in jlog.read(p):
            assert isinstance(rec, JMessage)
            log.append(p, SequencedDocumentMessage(
                doc_id=rec.doc_id, client_id=rec.client_id,
                client_seq=rec.client_seq, ref_seq=rec.ref_seq, seq=rec.seq,
                min_seq=rec.min_seq, type=MessageType(int(rec.type)),
                contents=copy.deepcopy(rec.contents),
                timestamp=rec.timestamp))
    return log


def _jax_log(tlog):
    from fluidframework_tpu.core.protocol import MessageType as JType
    log = JLog(tlog.n_partitions)
    for p in range(tlog.n_partitions):
        for rec in tlog.read(p):
            log.append(p, JMessage(
                doc_id=rec.doc_id, client_id=rec.client_id,
                client_seq=rec.client_seq, ref_seq=rec.ref_seq, seq=rec.seq,
                min_seq=rec.min_seq, type=JType(int(rec.type)),
                contents=copy.deepcopy(rec.contents),
                timestamp=rec.timestamp))
    return log


def _loads(tee, sj, st):
    """Each summary loaded by both packages: (JAX of JAX, port of port,
    port of JAX, JAX of port)."""
    return (JEngine.load(sj, tee.j.log), TEngine.load(st, tee.t.log,
                                                      device="cpu"),
            TEngine.load(sj, _port_log(tee.j.log), device="cpu"),
            JEngine.load(st, _jax_log(tee.t.log)))


def test_mega_tier_routes_and_converges_like_jax():
    rng = random.Random(3)
    tee = Tee(n_docs=1, capacity=256, batch_window=8, mega_docs=1,
              mega_capacity_per_shard=64)
    tee.mark_mega("huge")
    docs = ["huge", "small"]
    clients = _mk(tee, docs, 2)
    inflight = {d: [] for d in docs}
    _run_storm(tee, docs, clients, rng, 50, inflight)
    _drain(docs, clients, inflight)
    _same_reads(tee.j, tee.t, docs)
    for d in docs:
        assert tee.t.read_text(d) == clients[d][0].get_text(), d
    _assert_same(tee.j.mega_store, tee.t.mega_store)
    assert tee.t.mega_store.slot_usage().sum() > 0


def test_mega_tier_summary_loads_across_packages():
    rng = random.Random(9)
    tee = Tee(n_docs=1, capacity=256, batch_window=8, mega_docs=1,
              mega_capacity_per_shard=64, n_partitions=4)
    tee.mark_mega("huge")
    docs = ["huge", "small"]
    clients = _mk(tee, docs, 2)
    inflight = {d: [] for d in docs}
    _run_storm(tee, docs, clients, rng, 30, inflight)
    sj, st = tee.j.summarize(), tee.t.summarize()
    _run_storm(tee, docs, clients, rng, 20, inflight)
    _drain(docs, clients, inflight)
    _same_reads(tee.j, tee.t, docs)
    for eng in _loads(tee, sj, st):
        _same_reads(tee.j, eng, docs)
    # edits after the load keep landing on the mega tier
    lj, lt = JEngine.load(sj, tee.j.log), TEngine.load(st, tee.t.log,
                                                       device="cpu")
    c = clients["huge"][0]
    op = c.insert_text_local(0, "Z")
    for eng in (lj, lt):
        msg, nack = eng.submit("huge", c.client_id, op["clientSeq"],
                               c.last_processed_seq, copy.deepcopy(op))
        assert nack is None
    for cc in clients["huge"]:
        cc.apply_msg(msg)
    _same_reads(lj, lt, docs)
    assert lt.read_text("huge") == clients["huge"][0].get_text()


def test_mega_mark_in_the_tail_replays_across_packages():
    """A mark_mega after the last summary is replayed from the log tail
    (its ops would overflow the 16-slot flat tier otherwise)."""
    tee = Tee(n_docs=1, capacity=16, batch_window=4, mega_docs=1,
              mega_capacity_per_shard=64, n_partitions=4)
    tee.connect("old", 1)
    c_old = SequenceClient(1)
    op = c_old.insert_text_local(0, "x")
    msg, _ = tee.submit("old", 1, op["clientSeq"], 0, op)
    c_old.apply_msg(msg)
    sj, st = tee.j.summarize(), tee.t.summarize()
    tee.mark_mega("huge")
    tee.connect("huge", 5)
    c = SequenceClient(5)
    for i in range(30):
        op = c.insert_text_local(c.get_length(), f"t{i} ")
        msg, nack = tee.submit("huge", 5, op["clientSeq"],
                               c.last_processed_seq, op)
        assert nack is None
        c.apply_msg(msg)
    for eng in _loads(tee, sj, st):
        assert eng.read_text("huge") == c.get_text()
        assert eng.read_text("old") == "x"
        assert "huge" in eng._mega_rows
        assert not eng.overflowed_docs()
    # and again from a summary of a loaded engine
    lt = TEngine.load(st, tee.t.log, device="cpu")
    again = TEngine.load(lt.summarize(), tee.t.log, device="cpu")
    assert again.read_text("huge") == c.get_text()
    _assert_same(JEngine.load(sj, tee.j.log).mega_store, lt.mega_store)


def test_mark_mega_after_connect_like_jax():
    tee = Tee(n_docs=1, capacity=64, mega_docs=1,
              mega_capacity_per_shard=32)
    tee.connect("d", 1)
    tee.mark_mega("d")
    c = SequenceClient(1)
    op = c.insert_text_local(0, "hello")
    _, nack = tee.submit("d", 1, op["clientSeq"], 0, op)
    assert nack is None
    _same_reads(tee.j, tee.t, ["d"])
    assert tee.t.read_text("d") == "hello"
    assert "d" in tee.t._mega_rows and "d" not in tee.t._doc_rows


def _storm_mega(tee, doc, n_churn, n_keep):
    """Churn inserts + removes (tombstones), then inserts that stay;
    returns the expected text."""
    cs = 0
    for _ in range(n_churn):
        for op in ({"mt": "insert", "kind": 0, "pos": 0, "text": "ab"},
                   {"mt": "remove", "start": 0, "end": 2}):
            cs += 1
            tee.submit(doc, 1, cs, tee.deli.doc_seq(doc), op)
    shadow = ""
    for i in range(n_keep):
        cs += 1
        word = f"k{i}"
        tee.submit(doc, 1, cs, tee.deli.doc_seq(doc),
                   {"mt": "insert", "kind": 0, "pos": 0, "text": word})
        shadow = word + shadow
    tee.j.flush()
    tee.t.flush()
    return shadow


def _overflowed(n_churn, n_keep):
    tee = Tee(n_docs=1, capacity=64, batch_window=8, compact_every=10 ** 9,
              mega_docs=1, mega_capacity_per_shard=16)
    for eng in (tee.j, tee.t):
        eng.auto_recover = False
    tee.mark_mega("m")
    tee.connect("m", 1)
    want = _storm_mega(tee, "m", n_churn, n_keep)
    _assert_same(tee.j.mega_store, tee.t.mega_store)
    assert tee.t.overflowed_docs() == tee.j.overflowed_docs() == ["m"]
    return tee, want


def test_mega_overflow_reuploads_like_jax():
    tee, want = _overflowed(150, 10)
    reports = [eng.recover_overflowed() for eng in (tee.j, tee.t)]
    assert reports[0] == reports[1] == {"m": "reuploaded"}
    assert tee.t.overflowed_docs() == []
    assert tee.t.read_text("m") == want
    _assert_same(tee.j.mega_store, tee.t.mega_store)
    counts = tee.t.mega_store.slot_usage()[0]
    # dealt over the shards in order, a ceil quota each
    assert (counts <= -(-counts.sum() // 8)).all() and counts[0] > 0


def test_mega_overflow_graduates_like_jax():
    tee, want = _overflowed(0, 200)
    reports = [eng.recover_overflowed() for eng in (tee.j, tee.t)]
    assert reports[0] == reports[1] == {"m": "graduated"}
    assert tee.t.overflowed_docs() == []
    assert tee.t.read_text("m") == want
    _assert_same(tee.j.mega_store, tee.t.mega_store)
    assert np.array_equal(tee.j._graduated["m"].digests(),
                          tee.t._graduated["m"].digests())
    msg, nack = tee.submit("m", 1, 201, tee.deli.doc_seq("m"),
                           {"mt": "insert", "kind": 0, "pos": 0,
                            "text": "NEW:"})
    assert nack is None
    _same_reads(tee.j, tee.t, ["m"])
    assert tee.t.read_text("m") == "NEW:" + want
    # the freed mega row is taken by the next mega doc
    tee.mark_mega("m2")
    assert tee.t._mega_rows == tee.j._mega_rows == {"m2": 0}


def test_freed_mega_row_is_reused_after_a_load():
    """A mega row freed by a graduation is free again after a load, and a
    newly marked doc takes it, not a row another mega doc holds (the JAX
    engine forgets its free mega rows on load: ROADMAP C6)."""
    e = TEngine(n_docs=1, capacity=64, batch_window=8,
                compact_every=10 ** 9, mega_docs=2,
                mega_capacity_per_shard=16, device="cpu")
    e.auto_recover = False
    for d, c in (("m", 1), ("keep", 2)):
        e.mark_mega(d)
        e.connect(d, c)
    e.submit("keep", 2, 1, e.deli.doc_seq("keep"),
             {"mt": "insert", "kind": 0, "pos": 0, "text": "kept"})
    for i in range(200):
        e.submit("m", 1, i + 1, e.deli.doc_seq("m"),
                 {"mt": "insert", "kind": 0, "pos": 0, "text": f"k{i}"})
    e.flush()
    assert e.recover_overflowed() == {"m": "graduated"}
    loaded = TEngine.load(e.summarize(), e.log, device="cpu")
    loaded.mark_mega("new")
    assert loaded._mega_rows == {"keep": 1, "new": 0}
    loaded.connect("new", 3)
    loaded.submit("new", 3, 1, loaded.deli.doc_seq("new"),
                  {"mt": "insert", "kind": 0, "pos": 0, "text": "fresh"})
    assert loaded.read_text("new") == "fresh"
    assert loaded.read_text("keep") == "kept"
    assert loaded.read_text("m") == e.read_text("m")


def test_loaded_engine_hands_out_the_live_engines_mega_row():
    """ROADMAP C6: rows freed by graduations in the order 1, 0 leave the
    live engine's free list [1, 0] (it hands out row 0 next). A load of
    its summary restores that list and hands out the same row, with equal
    per-row digests after the same write (rebuilt ascending, as from a
    JAX summary, the list would give row 1)."""
    e = TEngine(n_docs=1, capacity=64, batch_window=8,
                compact_every=10 ** 9, mega_docs=4,
                mega_capacity_per_shard=16, device="cpu")
    e.auto_recover = False
    for i, d in enumerate(("a", "b", "c", "d")):
        e.mark_mega(d)
        e.connect(d, i + 1)
        e.submit(d, i + 1, 1, e.deli.doc_seq(d),
                 {"mt": "insert", "kind": 0, "pos": 0, "text": d})
    for d in ("b", "a"):
        c = "ab".index(d) + 1
        for i in range(200):
            e.submit(d, c, i + 2, e.deli.doc_seq(d),
                     {"mt": "insert", "kind": 0, "pos": 0, "text": f"k{i}"})
        e.flush()
        assert e.recover_overflowed() == {d: "graduated"}
    assert e._free_mega_rows == [1, 0]
    summary = e.summarize()
    loaded = TEngine.load(summary, e.log, device="cpu")
    assert loaded._free_mega_rows == [1, 0]
    for eng in (e, loaded):
        eng.mark_mega("new")
        eng.connect("new", 9)
        eng.submit("new", 9, 1, eng.deli.doc_seq("new"),
                   {"mt": "insert", "kind": 0, "pos": 0, "text": "fresh"})
        eng.flush()
    assert e._mega_rows["new"] == loaded._mega_rows["new"] == 0
    assert np.array_equal(e.mega_store.digests(), loaded.mega_store.digests())
    assert loaded.read_text("new") == "fresh"
    old = dict(summary)
    del old["free_mega_rows"]   # a summary without the list (a JAX one):
    # rebuilt ascending, the tail's markMega takes the highest free row
    assert TEngine.load(old, e.log, device="cpu")._mega_rows["new"] == 1


# ------------------------------------------- recovery through the mega tier
# The port rebuilds an overflowed mega doc through a one-doc mega store
# (the tier's own apply: K7 on the card, the plain version here), the JAX
# engine through a flat single-doc store; both end with the same mega row.

def _mega_churn(tee, doc, n_ops, keep_len, seed, clients=(1, 2, 3)):
    """Per-op edits of ``doc`` from several clients with lagging refs:
    inserts, removes and annotates keep the text near ``keep_len`` chars
    while the history grows (tombstones). Returns nothing: the engines'
    reads are compared."""
    rng = np.random.default_rng(seed)
    length, refs, cs = 0, {}, {}
    for c in clients:
        tee.connect(doc, c)
    for _ in range(n_ops):
        c = int(rng.choice(clients))
        cs[c] = cs.get(c, 0) + 1
        refs[c] = max(refs.get(c, 0),
                      tee.deli.doc_seq(doc) - int(rng.integers(0, 5)))
        r = rng.random()
        # positions stay 8 below the length: a lagging ref sees at least
        # that much of the text
        if length < keep_len or r < 0.3:
            op = {"mt": "insert", "kind": 0,
                  "pos": int(rng.integers(0, max(length - 8, 0) + 1)),
                  "text": "abc"[:1 + int(rng.integers(0, 3))]}
            length += len(op["text"])
        elif r < 0.8:
            s = int(rng.integers(0, length - 10))
            op = {"mt": "remove", "start": s, "end": s + 2}
            length -= 2
        else:
            s = int(rng.integers(0, length - 10))
            op = {"mt": "annotate", "start": s, "end": s + 3,
                  "props": {"k": int(rng.integers(0, 3))}}
        _, nack = tee.submit(doc, c, cs[c], refs[c], op)
        assert nack is None
    tee.j.flush()
    tee.t.flush()


def _churned_tee(n_ops, keep_len, seed=0, **kw):
    tee = Tee(n_docs=1, capacity=64, batch_window=8, compact_every=10 ** 9,
              mega_docs=1, mega_capacity_per_shard=16, **kw)
    for eng in (tee.j, tee.t):
        eng.auto_recover = False
    tee.mark_mega("m")
    _mega_churn(tee, "m", n_ops, keep_len, seed)
    assert tee.t.overflowed_docs() == tee.j.overflowed_docs() == ["m"]
    return tee


@pytest.mark.parametrize("want,n_ops,keep_len,seed", [
    ("reuploaded", 250, 24, 0), ("reuploaded", 300, 40, 1),
    ("graduated", 200, 400, 2)])
def test_mega_recovery_through_the_mega_tier_like_jax(want, n_ops, keep_len,
                                                      seed):
    """Multi-client churn with lagging refs and annotates overflows the
    mega doc; both engines recover it alike: the same report, the mega
    row's planes and interner tables bit-identical, reads and digests
    equal, and a later edit lands alike."""
    tee = _churned_tee(n_ops, keep_len, seed)
    reports = [eng.recover_overflowed() for eng in (tee.j, tee.t)]
    assert reports[0] == reports[1] == {"m": want}
    assert tee.t.overflowed_docs() == []
    _assert_same(tee.j.mega_store, tee.t.mega_store)
    if want == "graduated":
        assert np.array_equal(tee.j._graduated["m"].digests(),
                              tee.t._graduated["m"].digests())
    _same_reads(tee.j, tee.t, ["m"])
    tee.submit("m", 1, 10 ** 4, tee.deli.doc_seq("m"),
               {"mt": "insert", "kind": 0, "pos": 0, "text": "NEW"})
    _same_reads(tee.j, tee.t, ["m"])


def test_mega_rebuild_flattens_to_jax_flat_rebuild():
    """The port's one-doc mega rebuild, compacted, holds in document order
    (shard by shard, [0, count) of each) exactly the JAX engine's flat
    rebuild's [0, count): every plane, property handles and the payload
    and client tables."""
    tee = _churned_tee(300, 32, seed=3)
    t = tee.t._rebuild_mega("m", tee.t.mega_store, 1 << 20)
    j = tee.j._rebuild_doc("m", 16, 1 << 20, tee.j.mega_store.n_props)
    assert t.n_shards == 8 and t.capacity_per_shard > 16
    live = live_slots(t.state)
    n = int(np.asarray(j.state.count[0]))
    assert len(live["seq"]) == n
    for k in live:
        assert np.array_equal(live[k],
                              np.asarray(getattr(j.state, k)[0][:n])), k
    assert t._payloads == j._payloads
    assert t._client_idx[0] == j._client_idx[0]
    assert t._prop_planes == j._prop_planes


def test_mega_rebuild_grows_capacity_then_shards():
    """Under K7's limits (here a stand-in: 64 slots a shard, 8 shards) a
    rebuild of a 2-shard tier grows the capacity a shard first, then the
    shard count, and holds the history; its compacted live slots equal a
    flat replay of the same log, and the doc re-uploads."""
    e = TEngine(n_docs=1, capacity=64, batch_window=8, compact_every=10 ** 9,
                mega_store=MegaDocStringStore(1, 16, n_shards=2,
                                              device="cpu"),
                device="cpu")
    e.auto_recover = False
    e._mega_limits = lambda mega: (64, 8)
    e.mark_mega("m")
    e.connect("m", 1)
    ops = [{"mt": "insert", "kind": 0, "pos": 0, "text": "ab"},
           {"mt": "remove", "start": 0, "end": 2}] * 140 + \
        [{"mt": "insert", "kind": 0, "pos": 0, "text": "ab"}] * 10
    for cs, op in enumerate(ops, 1):   # 290 slots of history, 20 live
        assert e.submit("m", 1, cs, e.deli.doc_seq("m"), op)[1] is None
    e.flush()
    assert e.overflowed_docs() == ["m"]
    tried = []
    grow = serving.mega_rebuild_layouts

    def record(*args):
        for layout in grow(*args):
            tried.append(layout)
            yield layout

    serving.mega_rebuild_layouts = record
    try:
        t = e._rebuild_mega("m", e.mega_store, 1 << 20)
    finally:
        serving.mega_rebuild_layouts = grow
    assert tried[:3] == [(2, 32), (2, 64), (4, 64)]
    assert (t.n_shards, t.capacity_per_shard) == tried[-1]
    flat = TensorStringStore(1, 1024, device="cpu")
    flat.apply_messages((0, m) for m in e._docs_log_messages(["m"])["m"])
    flat.compact(e._min_seq.get("m", 0))
    live = live_slots(t.state)
    n = int(flat.state.count[0])
    for k in live:
        assert np.array_equal(live[k],
                              getattr(flat.state, k)[0, :n].numpy()), k
    assert e.recover_overflowed() == {"m": "reuploaded"}
    assert e.read_text("m") == "ab" * 10


def test_mega_rebuild_layouts():
    """The layout sequence: on the CPU the capacity a shard doubles up to
    ``grow_limit``; under the card's limits it stops at the widest
    capacity, then the shards double; past either, MemoryError."""
    grow = serving.mega_rebuild_layouts
    assert list(itertools.islice(grow("d", 8, 16, 1 << 20), 3)) == [
        (8, 32), (8, 64), (8, 128)]
    with pytest.raises(MemoryError, match="grow limit 512"):
        list(grow("d", 8, 16, 512))
    assert list(itertools.islice(grow("d", 8, 4096, 1 << 20), 1)) == [
        (8, 8192)]
    with pytest.raises(MemoryError, match="megadoc_apply"):
        layouts = []
        for layout in grow("d", 8, 4096, 1 << 20, (5000, 16)):
            layouts.append(layout)
    assert layouts == [(8, 5000), (16, 5000)]
    with pytest.raises(MemoryError, match="grow limit 60000"):
        list(grow("d", 8, 4096, 60000, (5000, 16)))


def _history_slots(eng, doc):
    """Slots the doc's whole history takes in a flat store (no
    compaction): what JAX's doubling rebuild must hold."""
    flat = TensorStringStore(1, 1 << 14, device="cpu")
    flat.apply_messages((0, m) for m in eng._docs_log_messages([doc])[doc])
    assert not flat.overflowed().any()
    return int(flat.state.count[0])


@pytest.mark.parametrize("grow_limit,refused", [(255, True), (256, False)])
def test_mega_recovery_grow_limit_like_jax(grow_limit, refused):
    """A history of 129 - 256 slots: JAX's flat doubling from 128 fits it
    at 256 slots, past a grow limit of 255; the port refuses
    (MemoryError) exactly where JAX does."""
    tee = _churned_tee(300, 24, seed=4)
    assert 128 < _history_slots(tee.t, "m") <= 256
    for eng in (tee.j, tee.t):
        if refused:
            with pytest.raises(MemoryError, match="grow limit"):
                eng.recover_overflowed(grow_limit=grow_limit)
        else:
            assert eng.recover_overflowed(grow_limit=grow_limit) == {
                "m": "reuploaded"}
    if not refused:
        _assert_same(tee.j.mega_store, tee.t.mega_store)
