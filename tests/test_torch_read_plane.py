"""The port's read plane (``server/read_plane.py``, ``server/observer.py``,
``runtime/summarizer.py``, ``parallel/replicated.py::OplogFollower``,
``drivers/resilient.py::ResilientObserver``) against the JAX package's,
on the CPU at a small size (4 docs, a few dozen ops).

- Window bytes: the same ops through a JAX engine and a port engine (per-op
  submits from the JAX ``chaos.OpGen``, seeded, plus each family's
  columnar route) leave logs whose ``encode_window`` bytes are identical
  across the packages, for all four families, and at the u8 table and u16
  doc bounds.
- Catch-up: a generation diff plus the short tail gives the digests of a
  full load, of the live engine and of the JAX engine (4 families × seeds
  3 and 11, as ``tests/test_read_plane.py::test_catchup_parity_fuzz``);
  delta summaries are refused; both checkpoint forms are read.
- The hub: encode-once identity, shed / park / resume, ring replay and
  ``catchup_needed``, the dead-sink unsubscribe, and resubscribes racing
  a publisher (replayed windows, then live ones, each once in order).
- Sockets (string): delivery exactly once, and exactly once across
  sockets torn inside a window run mid-storm. Every test waits until the
  hub counts its subscribers before the first op, and every wait is
  bounded.
- Replicas: ``ReadReplica`` converges and feeds ``read_staleness_p99_s``;
  ``OplogFollower.catch_up`` is idempotent over a record read twice and
  safe while the leader appends.
- The ladder: a corrupt newest blob loads depth 1, ``keep`` prunes, and
  generations written by each package load in the other (no blob names a
  module of either package).

Tolerance: exact (bytes, digests)."""

import json
import os
import pickletools
import random
import threading
import time

import numpy as np
import pytest

from fluidframework_tpu.runtime import summarizer as jsumm
from fluidframework_tpu.server import oplog as joplog
from fluidframework_tpu.server import read_plane as jrp
from fluidframework_tpu.server import serving as jserving
from fluidframework_tpu.testing import chaos as jchaos
from fluidframework_tpu_torch.drivers.resilient import ResilientObserver
from fluidframework_tpu_torch.parallel.replicated import OplogFollower
from fluidframework_tpu_torch.runtime import summarizer as tsumm
from fluidframework_tpu_torch.server import oplog as toplog
from fluidframework_tpu_torch.server import read_plane as trp
from fluidframework_tpu_torch.server import serving as tserving
from fluidframework_tpu_torch.server.columnar_ingress import (
    encode_json, read_frame,
)
from fluidframework_tpu_torch.server.observer import ObserverDoor, ObserverHub
from fluidframework_tpu_torch.testing import chaos as tchaos
from fluidframework_tpu_torch.testing.synthetic import map_serving_batch
from fluidframework_tpu_torch.utils.telemetry import REGISTRY

FAMILIES = ("string", "map", "matrix", "tree")
DOCS = [f"d{i}" for i in range(4)]
#: seconds any one wait may take
WAIT_S = 30.0


def _make(S, family, sequencer="python", log=None, **kw):
    """``chaos.make_engine``'s engine of ``family`` from serving module
    ``S`` (either package's)."""
    common = dict(n_docs=len(DOCS), batch_window=8, n_partitions=4, log=log,
                  sequencer=sequencer, **kw)
    if family == "string":
        return S.StringServingEngine(capacity=512, **common)
    if family == "map":
        return S.MapServingEngine(n_keys=16, **common)
    if family == "matrix":
        return S.MatrixServingEngine(cell_capacity=4096, **common)
    return S.TreeServingEngine(capacity=256, **common)


def _pair(family, sequencer="python"):
    return (_make(jserving, family, sequencer),
            _make(tserving, family, sequencer, device="cpu"))


def _dump(d) -> str:
    return json.dumps(d, sort_keys=True)


class _Feed:
    """One seeded op stream fed to several engines alike."""

    def __init__(self, engines, family, seed):
        self.engines = engines
        self.family = family
        self.gen = jchaos.OpGen(random.Random(seed), family, DOCS)
        self.cseq = {d: 0 for d in DOCS}
        for e in engines:
            for d in DOCS:
                e.connect(d, 1)
                e.doc_row(d)

    def push(self, n):
        for i in range(n):
            d = DOCS[i % len(DOCS)]
            self.cseq[d] += 1
            op = self.gen.op(d)
            for e in self.engines:
                _msg, nack = e.submit(d, 1, self.cseq[d], 0,
                                      json.loads(json.dumps(op)))
                assert not nack, nack
        for e in self.engines:
            e.flush()

    def columnar(self):
        """One wave of the family's columnar route on every engine."""
        fam, cs = self.family, self.cseq
        tree_ops = [self.gen.op(d) for d in DOCS] if fam == "tree" else None
        for e in self.engines:
            rows = np.array([e.doc_row(d) for d in DOCS], np.int32)
            if fam == "string":
                # a rich wave: inserts from a text table, an annotate
                R, O = len(DOCS), 3
                kind = np.tile(np.array([0, 2, 0], np.int32), (R, 1))
                a0 = np.tile(np.array([0, 0, 1], np.int32), (R, 1))
                a1 = np.tile(np.array([0, 1, 0], np.int32), (R, 1))
                tidx = np.tile(np.array([0, 1, 1], np.int32), (R, 1))
                out = e.ingest_planes(
                    rows, np.ones((R, O), np.int32), self._cseqs(O),
                    np.zeros((R, O), np.int32), kind, a0, a1,
                    texts=["ab", "c"], tidx=tidx,
                    props=[{"bold": True}, {"color": "red"}])
            elif fam == "map":
                R, O = len(DOCS), 4
                kind, kidx, keys, vidx, values = map_serving_batch(
                    R, O, 0, n_keys=8, n_values=8)
                out = e.ingest_planes(
                    rows, np.ones((R, O), np.int32), self._cseqs(O),
                    np.zeros((R, O), np.int32), kind, kidx, keys, values,
                    vidx)
            elif fam == "matrix":
                ids = [d for d in DOCS if min(self.gen._dims[d]) > 0]
                out = e.ingest_cells(
                    ids, [1] * len(ids), [cs[d] + 1 for d in ids],
                    [0] * len(ids), [0] * len(ids), [0] * len(ids),
                    [f"cell-{d}" for d in ids])
                e.flush()
            else:
                out = e.ingest_batch(list(DOCS), [1] * len(DOCS),
                                     [cs[d] + 1 for d in DOCS],
                                     [0] * len(DOCS),
                                     json.loads(json.dumps(tree_ops)))
            assert out["nacked"] == 0, out
        width = {"string": 3, "map": 4}.get(fam, 1)
        for d in DOCS:
            if fam != "matrix" or min(self.gen._dims[d]) > 0:
                cs[d] += width

    def _cseqs(self, O):
        return np.array([[self.cseq[d] + 1 + k for k in range(O)]
                         for d in DOCS], np.int32)


def _records(log):
    return [rec for p in range(log.n_partitions) for rec in log.read(p)]


# ---------------------------------------------------------- window bytes

@pytest.mark.parametrize("family", FAMILIES)
def test_encode_window_bytes_equal_jax(family):
    """Per-op submits and the family's columnar route through a JAX and a
    port engine: every record's frames and the whole log's window encode
    to the same bytes in both packages (B / R frames for string batches,
    a T frame for tree batches, JSON for the rest)."""
    j, t = _pair(family, sequencer="native")
    drv = _Feed((j, t), family, seed=5)
    drv.push(16)
    drv.columnar()
    drv.push(12)
    jrecs, trecs = _records(j.log), _records(t.log)
    assert len(jrecs) == len(trecs)
    kinds = set()
    for wid, (jr, tr) in enumerate(zip(jrecs, trecs), start=1):
        jf, jn = jrp.encode_record(jr, wid)
        tf, tn = trp.encode_record(tr, wid)
        assert (jf, jn) == (tf, tn)
        # the port's encoder on the JAX package's record, too
        assert trp.encode_record(jr, wid) == (jf, jn)
        kinds |= {f[:1] for f in tf}
    want = {"string": {b"J", b"R"}, "tree": {b"J", b"T"}}.get(family,
                                                               {b"J"})
    assert kinds == want
    assert trp.encode_window(trecs, 7) == jrp.encode_window(jrecs, 7)
    assert trp.encode_window([], 1) == jrp.encode_window([], 1)
    payload, n_ops = trp.encode_window([], 1)
    assert n_ops == 0 and payload


def _wide_string_record(S, n_texts, n_docs):
    """A string ``ColumnarOps`` of module ``S`` with ``n_texts`` distinct
    texts and props over ``n_docs`` docs."""
    n = 2 * n_texts
    kind = np.array([0, 2] * n_texts, np.int64)
    return S.ColumnarOps(
        doc_ids=[f"doc{i}" for i in range(n_docs)],
        doc=np.arange(n) % n_docs, client=np.ones(n, np.int64),
        client_seq=np.arange(1, n + 1), ref_seq=np.zeros(n, np.int64),
        seq=np.arange(2, n + 2), min_seq=np.zeros(n, np.int64),
        kind=kind, a0=np.zeros(n, np.int64), a1=np.where(kind == 2, 1, 0),
        text="", texts=[f"t{i}" for i in range(n_texts)],
        props=[{"k": i} for i in range(n_texts)],
        tidx=np.repeat(np.arange(n_texts), 2), timestamp=1.5)


@pytest.mark.parametrize("n_texts,n_docs,frames", [
    (300, 4, 3),        # past the u8 tables: two op frames
    (4, 70_000, 1),     # a doc index past u16: the JSON frame
])
def test_encode_bounds_equal_jax(n_texts, n_docs, frames):
    jr = _wide_string_record(jserving, n_texts, min(n_docs, 8 * n_texts))
    tr = _wide_string_record(tserving, n_texts, min(n_docs, 8 * n_texts))
    if n_docs > 8 * n_texts:     # one op on a doc past u16
        for r in (jr, tr):
            r.doc_ids = [f"doc{i}" for i in range(n_docs)]
            r.doc = np.array(r.doc)
            r.doc[-1] = n_docs - 1
    tf, _ = trp.encode_record(tr, 3)
    assert tf == jrp.encode_record(jr, 3)[0]
    assert len(tf) == frames


# -------------------------------------------------------------- catch-up

def _lineage(family, seed, n1=40, n2=60, tail=20):
    """JAX and port engines fed one seeded stream, with a summary after
    ``n1`` ops and one after ``n1 + n2`` in each, and ``tail`` more."""
    j, t = _pair(family)
    drv = _Feed((j, t), family, seed)
    drv.push(n1)
    froms = (j.summarize(), t.summarize())
    drv.push(n2)
    tos = (j.summarize(), t.summarize())
    drv.push(tail)
    return (j, t), froms, tos


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [3, 11])
def test_catchup_parity(family, seed):
    """The port's diff (FROM → TO) over the FROM base plus the TO tail
    reads as a full load of TO, as the live port engine, as the JAX
    engine and as the JAX package's own diff catch-up."""
    (j, t), (jf, tf), (jt, tt) = _lineage(family, seed)
    diff = trp.build_generation_diff(family, tf, tt, device="cpu")
    e_diff = trp.apply_generation_diff(family, diff, tf, t.log,
                                       device="cpu")
    e_full = tchaos.engine_class(family).load(tt, t.log, device="cpu")
    want = _dump(jchaos.digest(j, family, DOCS))
    assert _dump(tchaos.digest(e_diff, family, DOCS)) == want
    assert _dump(tchaos.digest(e_full, family, DOCS)) == want
    assert _dump(tchaos.digest(t, family, DOCS)) == want
    j_diff = jrp.apply_generation_diff(
        family, jrp.build_generation_diff(family, jf, jt), jf, j.log)
    assert _dump(jchaos.digest(j_diff, family, DOCS)) == want
    # the diff resumed sequencing where the live engine is
    for d in DOCS:
        assert e_diff.deli.doc_seq(d) == t.deli.doc_seq(d)


def test_generation_diff_needs_full_generations():
    (_j, t), (_jf, tf), (_jt, tt) = _lineage("map", 5, tail=0)
    delta = dict(tt, kind="delta")
    with pytest.raises(ValueError, match="FULL generations"):
        trp.build_generation_diff("map", tf, delta, device="cpu")
    with pytest.raises(ValueError, match="FULL generations"):
        trp.build_generation_diff("map", delta, tt, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        trp.build_generation_diff("list", tf, tt, device="cpu")
    inc = t.summarize(incremental=True)
    assert inc["kind"] == "delta"
    with pytest.raises(ValueError, match="FULL generations"):
        trp.build_generation_diff("map", tt, inc, device="cpu")


def test_sharded_matrix_generations_are_refused():
    (_j, _t), (_jf, tf), (_jt, tt) = _lineage("matrix", 5, tail=0)
    sharded = dict(tt, store={"sharded_docs": []})
    with pytest.raises(ValueError, match="sharded"):
        trp.build_generation_diff("matrix", tf, sharded, device="cpu")


@pytest.mark.parametrize("sequencer", ["python", "native"])
def test_summary_doc_seqs_reads_both_checkpoints(sequencer):
    j, t = _pair("string", sequencer)
    drv = _Feed((j, t), "string", 7)
    drv.push(12)
    s_from = t.summarize()
    drv.push(12)
    s_to = t.summarize()
    assert ("native" in s_to["deli"]) == (sequencer == "native")
    seqs_from = trp.summary_doc_seqs(s_from)
    seqs_to = trp.summary_doc_seqs(s_to)
    assert seqs_to == {d: t.deli.doc_seq(d) for d in DOCS}
    assert all(seqs_to[d] > seqs_from[d] for d in DOCS)
    assert seqs_to == jrp.summary_doc_seqs(j.summarize())


# ----------------------------------------------------------------- the hub

def _hub(**kw):
    return ObserverHub(tracker=trp.StalenessTracker(), **kw)


def test_hub_encode_once_shares_bytes():
    """Every subscriber's sink receives the same bytes object."""
    hub = _hub()
    got = [[], []]
    hub.subscribe(got[0].append)
    hub.subscribe(got[1].append)
    payload = b"window-bytes"
    assert hub.publish(hub.next_wid(), payload, 3) == 2
    assert got[0][0] is payload and got[1][0] is payload
    assert hub.stats()["ops_published"] == 3


def test_hub_shed_park_resume():
    """A subscriber whose byte budget cannot take a whole window is shed
    that window (a gap notice, parked) and resumes by a ring replay."""
    hub = _hub(byte_rate=1.0, byte_burst=64.0)
    got = []
    ack = hub.subscribe(got.append)
    big = bytes(200)
    wid = hub.next_wid()
    before = REGISTRY.snapshot().get("observer_sheds_total", 0)
    assert hub.publish(wid, big, 1) == 0
    assert REGISTRY.snapshot()["observer_sheds_total"] == before + 1
    rows = hub.readers()
    assert rows[0]["parked"] and rows[0]["sheds"] == 1
    # the gap notice arrived in place of the window
    assert got == [encode_json({"t": "gap", "wid": wid})]
    assert hub.publish(hub.next_wid(), b"x", 1) == 0    # parked: skipped
    assert len(got) == 1
    assert hub.resume(ack["sid"], wid)
    assert got[1:] == [big, b"x"]
    assert not hub.readers()[0]["parked"]


def test_hub_ring_replay_and_catchup_signal():
    hub = ObserverHub(ring=4, tracker=trp.StalenessTracker())
    payloads = [f"w{i}".encode() for i in range(8)]
    for p in payloads:
        hub.publish(hub.next_wid(), p, 1)
    assert hub.oldest_retained() == 5
    got = []
    ack = hub.subscribe(got.append, from_wid=6)
    assert not ack["catchup_needed"] and ack["next_wid"] == 9
    assert got == payloads[5:]
    got2 = []
    ack2 = hub.subscribe(got2.append, from_wid=2)
    assert ack2["catchup_needed"] and ack2["ring_from"] == 5
    assert got2 == []
    assert not hub.resume(ack2["sid"], 2)


def test_hub_dead_sink_unsubscribes():
    hub = _hub()

    def dead(_b):
        raise OSError("gone")

    hub.subscribe(dead)
    assert hub.publish(hub.next_wid(), b"x", 1) == 0
    assert hub.stats()["subscribers"] == 0


def test_hub_resubscribe_racing_a_publisher_is_in_order():
    """Subscribers that resume from the ring while another thread
    publishes get every window from their ``from_wid`` on, each once and
    in order: no live window overtakes the replay."""
    hub = ObserverHub(ring=4096, tracker=trp.StalenessTracker())
    n = 3000
    for _ in range(8):
        wid = hub.next_wid()
        hub.publish(wid, str(wid).encode(), 1)
    done = threading.Event()

    def publisher():
        for _ in range(n):
            wid = hub.next_wid()
            hub.publish(wid, str(wid).encode(), 1)
        done.set()

    th = threading.Thread(target=publisher)
    th.start()
    subs = []

    def slow_first(got):
        # the first calls (the replay) yield the interpreter, which
        # widens the window for a live publish to overtake them
        def sink(b):
            if len(got) < 4:
                time.sleep(0.0005)
            got.append(b)
        return sink

    while len(subs) < 64 and (not done.is_set() or not subs):
        got = []
        from_wid = max(1, hub.windows_published - 4)
        hub.subscribe(slow_first(got), from_wid=from_wid)
        subs.append((from_wid, got))
    th.join(WAIT_S)
    assert not th.is_alive()
    last = n + 8
    for from_wid, got in subs:
        wids = [int(g) for g in got]
        assert wids == list(range(from_wid, last + 1)), from_wid


# ------------------------------------------------------------- sockets

def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _plane(**kw):
    eng = tserving.StringServingEngine(
        n_docs=len(DOCS), capacity=512, batch_window=8, n_partitions=4,
        sequencer="native", device="cpu", **kw)
    hub = ObserverHub(ring=1024, tracker=trp.StalenessTracker())
    eng.attach_read_plane(trp.ReadPlane(eng, hub))
    door = ObserverDoor(hub).start_in_thread()
    return eng, hub, door


def _observers(door, hub, n, **kw):
    obs = [ResilientObserver("127.0.0.1", door.port, name=f"o{i}",
                             rng=random.Random(100 + i), **kw)
           for i in range(n)]
    # the first subscribe joins at the live head: no op before the hub
    # counts every observer
    _wait(lambda: hub.stats()["subscribers"] == n, "the subscriptions")
    return obs


def _check_exactly_once(o, eng, total):
    assert o.wait_ops(total, WAIT_S), (o.name, o.ops_applied, o.gave_up)
    assert o.ops_applied == total
    assert (o.gaps, o.op_gaps, o.dups, o.window_dups) == (0, 0, 0, 0)
    assert o.doc_seqs == {d: eng.deli.doc_seq(d) for d in DOCS}


def test_socket_delivery_exactly_once():
    """Per-op windows (JSON frames) and a rich columnar wave (``R``
    frames) reach a socket observer once each, decoded by the client."""
    eng, hub, door = _plane()
    seen = []
    obs = _observers(door, hub, 1, on_op=lambda doc, seq, client, op:
                     seen.append((doc, seq, op)))
    try:
        drv = _Feed((eng,), "string", 9)
        drv.push(24)
        drv.columnar()
        drv.push(8)
        total = 24 + 3 * len(DOCS) + 8
        _check_exactly_once(obs[0], eng, total)
        assert any(op.get("props") == {"color": "red"} for _d, _s, op in seen)
        assert any(op.get("text") == "ab" for _d, _s, op in seen)
    finally:
        obs[0].close()
        door.stop()


def test_socket_reconnect_mid_storm_exactly_once():
    """Three observers lose their sockets inside a window run (after the
    first of its per-op frames) on every chunk of a storm but the last,
    and the next chunk lands while they redial. The cursor stays on the
    torn window, the ring replays it whole, and its ops applied before
    the loss are dropped by their seqs: every op once, no gap, no
    duplicate. One socket is also killed from outside while idle."""
    eng, hub, door = _plane()
    obs = _observers(door, hub, 3, base_delay=0.01)
    try:
        drv = _Feed((eng,), "string", 13)
        chunks, per = 4, 40
        for k in range(chunks):
            if k < chunks - 1:
                for o in obs:
                    o.tear_window()
            drv.push(per)
            if k < chunks - 1:
                for o in obs:
                    _wait(lambda: o.torn_windows == k + 1,
                          f"{o.name}'s torn window")
        assert obs[0].wait_ops(chunks * per, WAIT_S)
        obs[0].kill_socket()
        drv.push(per)
        for o in obs:
            _check_exactly_once(o, eng, (chunks + 1) * per)
            assert o.torn_windows == chunks - 1
            assert o.reconnects >= chunks - 1
        assert obs[0].reconnects >= chunks
    finally:
        for o in obs:
            o.close()
        door.stop()


def test_catchup_rung_answers_from_the_ladder(tmp_path):
    store = tsumm.SummaryGenerationStore(str(tmp_path))
    eng = _make(tserving, "string", device="cpu")
    store.save(eng.summarize(), 0)
    store.save(eng.summarize(), 0)
    door = ObserverDoor(_hub(), gen_store=store).start_in_thread()
    try:
        import socket
        with socket.create_connection(("127.0.0.1", door.port),
                                      timeout=WAIT_S) as s:
            s.sendall(encode_json({"t": "subscribe", "name": "joiner"}))
            _t, ack = read_frame(s)
            assert json.loads(ack)["t"] == "subscribed"
            for gen, ok in ((0, True), (1, False), (None, False)):
                s.sendall(encode_json({"t": "catchup", "from_gen": gen}))
                _t, info = read_frame(s)
                info = json.loads(info)
                assert info["generations"] == [0, 1]
                assert info["diff_ok"] is ok
            s.sendall(encode_json({"t": "close"}))
    finally:
        door.stop()


# -------------------------------------------------------------- replicas

def _push_texts(eng, cseq, n0, n1):
    for i in range(n0, n1):
        d = DOCS[i % len(DOCS)]
        cseq[d] += 1
        _m, nack = eng.submit(d, 1, cseq[d], 0,
                              {"mt": "insert", "kind": 0, "pos": 0,
                               "text": f"r{i}"})
        assert nack is None
    eng.flush()


def test_read_replica_converges_and_feeds_staleness():
    """A replica anchored a summary behind its leader drains the tail,
    samples staleness, and reads as the leader (and as the JAX replica
    fed the same ops)."""
    replicas = []
    for S, R, kw in ((tserving, trp, {"device": "cpu"}),
                     (jserving, jrp, {})):
        leader = _make(S, "string", **kw)
        for d in DOCS:
            leader.connect(d, 1)
        cseq = {d: 0 for d in DOCS}
        _push_texts(leader, cseq, 0, 12)
        s0 = leader.summarize()
        tracker = R.StalenessTracker()
        rep = R.ReadReplica(leader, summary=s0,
                            tracker=tracker, **kw)
        _push_texts(leader, cseq, 12, 24)
        assert rep.poll() == 12
        assert rep.poll() == 0       # caught up: an idle poll applies none
        assert rep.polls == 2 and rep.ops_applied == 12
        replicas.append((leader, rep))
    (leader, rep), (jleader, jrep) = replicas
    assert tchaos.digest(rep.engine, "string", DOCS) == \
        tchaos.digest(leader, "string", DOCS) == \
        jchaos.digest(jrep.engine, "string", DOCS)
    assert rep.tracker.p99() >= 0.0 and len(rep.tracker._samples) == 1
    assert REGISTRY.snapshot()["read_staleness_p99_s"] >= 0.0


def test_oplog_follower_catch_up_is_idempotent():
    """Records read twice (the cursors rewound to the start) are skipped
    by their seqs: nothing is applied twice."""
    leader = _make(tserving, "string", device="cpu")
    for d in DOCS:
        leader.connect(d, 1)
    cseq = {d: 0 for d in DOCS}
    _push_texts(leader, cseq, 0, 8)
    fol = OplogFollower(leader, summary=leader.summarize(), device="cpu")
    _push_texts(leader, cseq, 8, 20)
    assert fol.catch_up() == 12
    before = tchaos.digest(fol.engine, "string", DOCS)
    fol._offsets = [0] * leader.log.n_partitions
    assert fol.catch_up() == 0
    assert tchaos.digest(fol.engine, "string", DOCS) == before == \
        tchaos.digest(leader, "string", DOCS)
    assert fol.caught_up_ops == 12


def test_replica_polls_while_the_leader_appends():
    """Polls race a writer thread's appends (each poll takes only the
    records below the sizes it read); a last poll after the writer ends
    reads as the leader."""
    leader = _make(tserving, "string", device="cpu")
    for d in DOCS:
        leader.connect(d, 1)
    rep = trp.ReadReplica(leader, tracker=trp.StalenessTracker(),
                          device="cpu")
    cseq = {d: 0 for d in DOCS}
    errors = []

    def writer():
        try:
            for k in range(20):
                _push_texts(leader, cseq, 8 * k, 8 * (k + 1))
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    th = threading.Thread(target=writer)
    th.start()
    while th.is_alive():
        rep.poll()
    th.join(WAIT_S)
    assert not th.is_alive() and not errors
    rep.poll()
    assert rep.ops_applied == 160
    assert tchaos.digest(rep.engine, "string", DOCS) == \
        tchaos.digest(leader, "string", DOCS)


# ------------------------------------------------------------- the ladder

def _blob_path(store, gen):
    return os.path.join(store.directory, store._BLOB.format(gen))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_ladder_skips_a_corrupt_newest_blob(tmp_path, pkg):
    M = tsumm if pkg == "port" else jsumm
    store = M.SummaryGenerationStore(str(tmp_path), keep=3)
    for i in range(3):
        assert store.save({"i": i, "a": np.arange(i + 1)}, seq=10 * i) == i
    with open(_blob_path(store, 2), "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 0xFF]))
    summary, seq, depth = store.load_latest()
    assert (summary["i"], seq, depth) == (1, 10, 1)
    assert [p["generation"] for p in store.verify_all()] == [2]
    with pytest.raises(M.SummaryIntegrityError, match="sha256"):
        store.load_generation(2)
    for gen in (0, 1):
        os.remove(_blob_path(store, gen))
    with pytest.raises(M.SummaryIntegrityError, match="3 tried"):
        store.load_latest()


def test_keep_prunes_old_generations(tmp_path):
    store = tsumm.SummaryGenerationStore(str(tmp_path), keep=2)
    for i in range(4):
        store.save({"i": i}, seq=i)
    assert store.generations() == [2, 3]
    assert sorted(os.listdir(str(tmp_path))) == [
        "gen-00000002.manifest.json", "gen-00000002.summary.pkl",
        "gen-00000003.manifest.json", "gen-00000003.summary.pkl"]
    assert store.load_latest()[0] == {"i": 3}
    with pytest.raises(ValueError):
        tsumm.SummaryGenerationStore(str(tmp_path), keep=0)


def _modules_named(blob: bytes):
    """Module names a pickle refers to (GLOBAL / STACK_GLOBAL)."""
    out, strings = set(), []
    for op, arg, _pos in pickletools.genops(blob):
        if isinstance(arg, str):
            strings.append(arg)
        if op.name == "GLOBAL":
            out.add(arg.split(" ")[0])
        elif op.name == "STACK_GLOBAL":
            out.add(strings[-2])
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_generations_load_across_packages(tmp_path, writer):
    """A string engine on a JSONL spill saves a generation; the other
    package's store verifies and unpickles it, and the other package's
    engine loads it over the recovered spill, reading the same texts.
    Neither blob names a module of either package."""
    W = (tserving, toplog, tsumm, {"device": "cpu"}) if writer == "port" \
        else (jserving, joplog, jsumm, {})
    Rd = (jserving, joplog, jsumm, {}) if writer == "port" \
        else (tserving, toplog, tsumm, {"device": "cpu"})
    logdir, gendir = str(tmp_path / "log"), str(tmp_path / "gens")
    eng = _make(W[0], "string", log=W[1].PartitionedLog(4, logdir, "t"),
                **W[3])
    drv = _Feed((eng,), "string", 17)
    drv.push(24)
    W[2].SummaryGenerationStore(gendir).save(eng.summarize(), seq=24)
    drv.push(8)
    want = {d: eng.read_text(d) for d in DOCS}
    eng.log.close()
    with open(os.path.join(gendir, "gen-00000000.summary.pkl"), "rb") as f:
        mods = _modules_named(f.read())
    assert not any(m.startswith("fluidframework_tpu") for m in mods), mods
    summary, seq, depth = Rd[2].SummaryGenerationStore(gendir).load_latest()
    assert (seq, depth) == (24, 0)
    log = Rd[1].PartitionedLog.recover(4, logdir, "t")
    other = Rd[0].StringServingEngine.load(summary, log, **Rd[3])
    assert {d: other.read_text(d) for d in DOCS} == want


def test_chip_readplane_phase_at_small_size(capsys):
    """``chip_smoke.py``'s readplane phase on the CPU at a small size:
    the door storm with the read plane attached passes every check
    (observers exactly once across sockets torn inside window runs and
    killed while idle, encode-once identity,
    the replica equal to the leader, the diff catch-up equal to a full
    load and to the live engine, the catch-up rung) and prints its line."""
    import chip_smoke
    out = chip_smoke.readplane_phase("cpu", "cpu", D=64, n_clients=4,
                                     waves=6, tears=(1, 4), kills=(3,),
                                     n_sinks=4,
                                     window_rows=16, trials=2)
    assert out["max_abs_err"] == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "readplane" and line["catchup_rung"] is True
    assert line["ops"] == line["ops_published"] == 64 * 8
    assert all(o["reconnects"] >= 3 and o["torn_windows"] == 2
               for o in line["observers"])
    assert line["replica"]["ops"] == 64 * 8
    assert line["generations"] == [0, 1] and line["dirty_rows"] == 64
