"""The port's ``ServingLocalService`` (``server/serving_service.py``) with
``device="cpu"``: the in-process service whose sequenced stream feeds a
replica of every string channel, merged through the store's apply (B1 on
the card, its plain version here).

- ``tests/test_serving.py``'s ``TestServingLocalService`` cases and
  ``tests/test_chaos.py``'s replica-full shedding, on the port;
- one seeded container session (an editor in turn mode with a compressed
  and a chunked paste, an immediate viewer) through the JAX and the port
  services: equal reads for every doc, equal sequenced streams, and the
  replica stores equal under the parity contract, also through
  ``TensorStringStore.from_jax_snapshot``;
- the same session with the viewer's edits crossing the editor's turns,
  on the port (ROADMAP C13 repaired): every server read equals both
  clients;
- a client that submits inside an ``on_op`` listener (the reentrant
  publish the seq-sorted flush exists for);
- the registry attachments of the service's collectors.

Tolerance: exact."""

import random

import pytest

from fluidframework_tpu_torch.framework import LocalClient
from fluidframework_tpu_torch.ops.string_store import (
    TensorStringStore as TStore,
)
from fluidframework_tpu_torch.server.serving_service import (
    ServingLocalService,
)
from fluidframework_tpu_torch.testing.service_session import (
    ServiceSession, doc_ids,
)
from fluidframework_tpu_torch.utils.telemetry import (
    REGISTRY, BufferSink, TelemetryLogger,
)
from tests.test_torch_store import _assert_same


def _mk(**kw):
    svc = ServingLocalService(n_docs=8, capacity=512, device="cpu", **kw)
    return svc, LocalClient(service=svc)


# ------------------------------------- tests/test_serving.py, on the port

def test_container_edits_served_on_device():
    svc, client = _mk()
    schema = {"initialObjects": {"text": "sharedString"}}
    c1, doc_id = client.create_container(schema)
    c2 = client.get_container(doc_id, schema)
    t1 = c1.initial_objects["text"]
    t2 = c2.initial_objects["text"]
    t1.insert_text(0, "hello world", {"bold": True})
    t2.insert_text(0, "[b] ")
    t1.annotate_range(0, 2, {"color": "red"})
    t1.remove_text(0, 1)
    assert t1.get_text() == t2.get_text()
    assert svc.read_text(doc_id, "text") == t1.get_text()
    for pos in range(t1.get_length()):
        assert svc.get_properties(doc_id, "text", pos) == \
            t1.get_properties(pos), pos


def test_multiple_docs_and_channels():
    svc, client = _mk()
    schema = {"initialObjects": {"a": "sharedString", "b": "sharedString"}}
    c1, d1 = client.create_container(schema)
    c2, d2 = client.create_container(schema)
    c1.initial_objects["a"].insert_text(0, "doc1-a")
    c1.initial_objects["b"].insert_text(0, "doc1-b")
    c2.initial_objects["a"].insert_text(0, "doc2-a")
    assert svc.read_text(d1, "a") == "doc1-a"
    assert svc.read_text(d1, "b") == "doc1-b"
    assert svc.read_text(d2, "a") == "doc2-a"
    assert set(svc.served_channels(d1)) == {("default", "a"),
                                            ("default", "b")}


def test_storm_with_compaction_matches_clients():
    rng = random.Random(13)
    svc, client = _mk(batch_window=8, compact_every=2)
    schema = {"initialObjects": {"text": "sharedString"}}
    c1, doc_id = client.create_container(schema)
    c2 = client.get_container(doc_id, schema)
    texts = [c1.initial_objects["text"], c2.initial_objects["text"]]
    compactions = []
    compact = svc.store.compact
    svc.store.compact = lambda ms: (compactions.append(1), compact(ms))
    for i in range(120):
        t = rng.choice(texts)
        n = t.get_length()
        roll = rng.random()
        if n == 0 or roll < 0.6:
            t.insert_text(rng.randint(0, n), f"w{i} ")
        elif roll < 0.8:
            s = rng.randrange(n)
            t.remove_text(s, rng.randint(s + 1, min(n, s + 5)))
        else:
            s = rng.randrange(n)
            t.annotate_range(s, rng.randint(s + 1, min(n, s + 4)),
                             {"k": rng.randint(0, 3)})
    assert texts[0].get_text() == texts[1].get_text()
    assert svc.read_text(doc_id, "text") == texts[0].get_text()
    assert compactions


def test_non_string_channels_ignored():
    svc, client = _mk()
    schema = {"initialObjects": {"m": "map", "text": "sharedString"}}
    c1, doc_id = client.create_container(schema)
    c1.initial_objects["m"].set("k", 1)
    c1.initial_objects["text"].insert_text(0, "served")
    assert svc.read_text(doc_id, "text") == "served"
    assert svc.served_channels(doc_id) == [("default", "text")]


def test_replica_full_sheds_visibly():
    """``tests/test_chaos.py``: one store row, two string channels; the
    second is shed from the replica (counted, warned, listed) while the
    ordering service and the clients stay correct."""
    svc = ServingLocalService(n_docs=1, capacity=256, device="cpu")
    sink = BufferSink()
    svc.telemetry = TelemetryLogger(sink, "servingService")
    client = LocalClient(service=svc)
    schema = {"initialObjects": {"a": "sharedString", "b": "sharedString"}}
    c, doc_id = client.create_container(schema)
    c.initial_objects["a"].insert_text(0, "served")
    c.initial_objects["b"].insert_text(0, "shed")
    c.initial_objects["b"].insert_text(4, "!")
    assert svc.read_text(doc_id, "a") == "served"
    assert svc.metrics.counters["replica_channels_dropped"] == 1
    assert svc.metrics.counters["replica_ops_dropped"] >= 2
    assert svc.dropped_channels() == [(doc_id, "default", "b")]
    warns = sink.named("replicaChannelDropped")
    assert warns and warns[0]["channel"] == "b" \
        and warns[0]["capacity"] == 1
    with pytest.raises(KeyError):
        svc.read_text(doc_id, "b")
    assert c.initial_objects["b"].get_text() == "shed!"


# ------------------------------------------------- against the JAX package

def _jax_session(n_docs, **kw):
    from fluidframework_tpu.framework import LocalClient as JClient
    from fluidframework_tpu.runtime import (
        ContainerRuntimeOptions as JOptions, SummaryConfig as JConfig,
    )
    from fluidframework_tpu.server.serving_service import (
        ServingLocalService as JService,
    )
    svc = JService(n_docs=n_docs, capacity=256, **kw)
    return svc, ServiceSession(svc, doc_ids(n_docs), client_cls=JClient,
                               options_cls=JOptions, summary_cls=JConfig)


def test_container_session_matches_jax_service():
    """One seeded session (4 rounds, a compressed paste in every other
    doc and a chunked one in every fourth, summaries every 8 ops) through
    both packages' services: equal streams, reads, summaries and stores,
    compactions included."""
    n, kw = 8, dict(batch_window=16, compact_every=3)
    jsvc, js = _jax_session(n, **kw)
    tsvc = ServingLocalService(n_docs=n, capacity=256, device="cpu", **kw)
    ts = ServiceSession(tsvc, doc_ids(n))
    flushes = []
    apply = tsvc.store.apply_messages
    tsvc.store.apply_messages = lambda m: (flushes.append(1), apply(m))
    for svc, s in ((jsvc, js), (tsvc, ts)):
        s.run(4, seed=7, paste_round=2, paste_every=2, chunk_every=4,
              cross=False)
        svc.flush_replica()
    for d in ts.docs:
        jm = [(m.seq, m.min_seq, m.ref_seq, m.client_id, m.client_seq,
               int(m.type), m.contents) for m in jsvc.get_deltas(d)]
        tm = [(m.seq, m.min_seq, m.ref_seq, m.client_id, m.client_seq,
               int(m.type), m.contents) for m in tsvc.get_deltas(d)]
        assert tm == jm, d
        assert tsvc.read_text(d, "text") == jsvc.read_text(d, "text")
    for (ta, tb, _), (ja, _jb, _) in zip(ts.texts, js.texts):
        assert ta.get_text() == tb.get_text() == ja.get_text()
    assert ts.summaries_acked() == js.summaries_acked() > 0
    assert tsvc.metrics.counters == jsvc.metrics.counters
    assert tsvc.metrics.counters["replica_flushes"] == len(flushes) > 3
    _assert_same(jsvc.store, tsvc.store)
    # the JAX replica's state carried into the port goes on in step
    back = TStore.from_jax_snapshot(jsvc.store.snapshot(), device="cpu")
    _assert_same(jsvc.store, back)


def test_crossing_session_converges_on_the_port():
    """The viewer's edit lands between the editor's turn and its flush in
    every doc of every round: every server read equals both clients', the
    props too (ROADMAP C13 repaired in the port's outbox)."""
    svc = ServingLocalService(n_docs=6, capacity=256, batch_window=16,
                              compact_every=2, device="cpu")
    s = ServiceSession(svc, doc_ids(6))
    s.run(4, seed=3, paste_round=1, paste_every=3, chunk_every=6)
    for d, (ta, tb, _) in zip(s.docs, s.texts):
        assert svc.read_text(d, "text") == ta.get_text() == tb.get_text()
        for pos in range(0, ta.get_length(), 97):
            assert svc.get_properties(d, "text", pos) == \
                ta.get_properties(pos)
    assert svc.served_channels(s.docs[0]) == [("default", "text")]
    assert not svc.dropped_channels() and not svc.nacks
    assert s.edits["annotate"] and s.edits["paste"] == 2


def test_reentrant_submit_inside_a_listener_is_merged_in_seq_order():
    """A viewer that answers every remote op inside its ``op`` listener
    re-enters the service's publish: the replica queue takes the answer
    before the op that caused it, and the seq-sorted flush still merges
    the channel as the clients see it."""
    svc, client = _mk(batch_window=4)
    schema = {"initialObjects": {"text": "sharedString"}}
    c1, doc = client.create_container(schema)
    c2 = client.get_container(doc, schema)
    t1, t2 = c1.initial_objects["text"], c2.initial_objects["text"]
    out_of_order = []
    consume = svc._replica_consume

    def watch(p, off, msg):
        q = [m.seq for _, m in svc._replica_queue]
        consume(p, off, msg)
        q2 = [m.seq for _, m in svc._replica_queue]
        if q2 and q2 != sorted(q2):
            out_of_order.append(q2)
        del q

    for p in range(svc.deltas_log.n_partitions):
        subs = svc.deltas_log._subs[p]
        subs[:] = [watch if getattr(f, "__name__", "") == "_replica_consume"
                   else f for f in subs]

    def answer(msg):
        if msg.client_id == c1.container.client_id and \
                t2.get_length() < 40:
            t2.insert_text(0, "r")

    c2.container.on("op", answer)
    for i in range(6):
        t1.insert_text(t1.get_length(), f"{i}")
    assert out_of_order, "no reentrant publish reached the replica"
    assert t1.get_text() == t2.get_text()
    assert svc.read_text(doc, "text") == t1.get_text()


def test_collectors_attach_to_the_registry():
    svc, _ = _mk(n_partitions=2)
    comps = REGISTRY.components()
    mine = {k for k, v in comps.items()
            if v is svc.metrics or v in svc.partition_metrics}
    assert len(mine) == 3
    labeled = sorted(REGISTRY.component_labels(k).get("partition", "")
                     for k in mine)
    assert labeled == ["", "0", "1"]
    assert REGISTRY.component_key("x", {"b": 1, "a": 2}) == "x{a=2,b=1}"


def test_chip_service_phase_at_small_size():
    """``chip_smoke.py``'s service phase on the CPU at a small size: the
    session, every read and property check, the envelope census, the
    launch bookkeeping and the twin's step-by-step fingerprints."""
    import chip_smoke
    out = chip_smoke.service_phase("cpu", "cpu", D=64, twin_docs=32,
                                   prop_docs=16, paste_every=8,
                                   chunk_every=32)
    assert out == {"launches": 0, "twin_launches": 0, "max_abs_err": 0}
