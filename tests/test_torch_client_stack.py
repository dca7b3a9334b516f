"""The port's client stack (``models/``, ``runtime/``, ``loader/``,
``drivers/``, ``framework/``) against the JAX package's, on the same
seeded inputs:

- ``MockSequencer`` storms of three SharedString replicas whose ops cross
  in flight (partial ``process_some``), with annotates, heartbeats that
  move the window floor, and sliding intervals: equal text, properties,
  ``structure_digest`` and interval endpoints across packages;
- SharedMap storms the same way;
- the outbox's grouped, compressed and chunked envelopes, byte-equal
  across packages and decoded by each package's
  ``RemoteMessageProcessor``;
- ``tests/test_loader.py``'s ``TestContainerLocalService`` cases and its
  nack reconnect, on both packages;
- container summaries (protocol, runtime, SharedString with intervals,
  SharedMap) that load both ways, and a port container that converges
  where the JAX outbox makes replicas diverge (ROADMAP C13).

Tolerance: exact."""

import json
import random
import types

import pytest

from fluidframework_tpu.core.protocol import (
    MessageType as JMessageType,
    SequencedDocumentMessage as JMsg,
)
from fluidframework_tpu.drivers.local_driver import (
    LocalDocumentServiceFactory as JFactory,
)
from fluidframework_tpu.framework import LocalClient as JLocalClient
from fluidframework_tpu.loader import Loader as JLoader
from fluidframework_tpu.models.shared_map import SharedMap as JSharedMap
from fluidframework_tpu.models.shared_string import (
    SharedString as JSharedString,
)
from fluidframework_tpu.runtime import (
    ContainerRuntimeOptions as JOptions, SummaryConfig as JSummaryConfig,
)
from fluidframework_tpu.runtime.outbox import Outbox as JOutbox
from fluidframework_tpu.runtime.remote_message_processor import (
    RemoteMessageProcessor as JRMP,
)
from fluidframework_tpu.server.tinylicious import LocalService as JService
from fluidframework_tpu.testing.mocks import (
    MockSequencer as JMockSequencer,
    create_connected_dds as jcreate,
)
from fluidframework_tpu_torch.core.protocol import (
    MessageType, SequencedDocumentMessage,
)
from fluidframework_tpu_torch.drivers.local_driver import (
    LocalDocumentServiceFactory,
)
from fluidframework_tpu_torch.framework import LocalClient
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.models.shared_map import SharedMap
from fluidframework_tpu_torch.models.shared_object import default_registry
from fluidframework_tpu_torch.models.shared_string import SharedString
from fluidframework_tpu_torch.runtime.container_runtime import (
    ContainerRuntimeOptions,
)
from fluidframework_tpu_torch.runtime.outbox import Outbox
from fluidframework_tpu_torch.runtime.remote_message_processor import (
    RemoteMessageProcessor,
)
from fluidframework_tpu_torch.runtime.summarizer import SummaryConfig
from fluidframework_tpu_torch.server.tinylicious import LocalService
from fluidframework_tpu_torch.testing.mocks import (
    MockSequencer, create_connected_dds,
)
from fluidframework_tpu_torch.testing.service_session import (
    SCHEMA, ServiceSession, doc_ids,
)
from tests.test_loader import RecordingRuntime

JAX = types.SimpleNamespace(
    MockSequencer=JMockSequencer, create=jcreate, SharedString=JSharedString,
    SharedMap=JSharedMap, MessageType=JMessageType, Msg=JMsg,
    Outbox=JOutbox, RMP=JRMP, LocalService=JService, Factory=JFactory,
    Loader=JLoader, LocalClient=JLocalClient, Options=JOptions,
    SummaryConfig=JSummaryConfig)
PORT = types.SimpleNamespace(
    MockSequencer=MockSequencer, create=create_connected_dds,
    SharedString=SharedString, SharedMap=SharedMap, MessageType=MessageType,
    Msg=SequencedDocumentMessage, Outbox=Outbox, RMP=RemoteMessageProcessor,
    LocalService=LocalService, Factory=LocalDocumentServiceFactory,
    Loader=Loader, LocalClient=LocalClient, Options=ContainerRuntimeOptions,
    SummaryConfig=SummaryConfig)


# ------------------------------------------------------ MockSequencer storms

def string_storm(ns, seed, steps=160, n_clients=3):
    """Seeded edits from ``n_clients`` SharedStrings; the sequencer
    processes a few queued ops between edits, so ops cross in flight."""
    rng = random.Random(seed)
    seqr = ns.MockSequencer()
    reps = [ns.create(seqr, ns.SharedString, "s") for _ in range(n_clients)]
    ivs = [[] for _ in reps]
    for step in range(steps):
        i = rng.randrange(n_clients)
        s = reps[i]
        n = s.get_length()
        roll = rng.random()
        if n < 2 or roll < 0.45:
            s.insert_text(rng.randint(0, n), f"<{step}>",
                          {"k": rng.randrange(3)} if roll < 0.1 else None)
        elif roll < 0.65:
            a = rng.randrange(n)
            s.remove_text(a, min(n, a + rng.randint(1, 5)))
        elif roll < 0.80:
            a = rng.randrange(n)
            s.annotate_range(a, min(n, a + rng.randint(1, 6)),
                             {f"p{rng.randrange(4)}": rng.randrange(9)})
        elif roll < 0.90:
            a = rng.randrange(n)
            iid = s.get_interval_collection("c").add(
                a, min(n - 1, a + rng.randint(0, 6)), {"n": step})
            ivs[i].append(iid)
        elif ivs[i]:
            view = s.get_interval_collection("c")
            iid = rng.choice(ivs[i])
            if iid in view._coll.intervals:
                a = rng.randrange(n)
                view.change(iid, start=a, end=min(n - 1, a + 2))
        if rng.random() < 0.15:
            for r in reps:   # heartbeats: the window floor moves, zamboni
                seqr.submit(r, None, type=ns.MessageType.NOOP)
        seqr.process_some(rng.randint(0, 3))
    seqr.process_all_messages()
    for r in reps:
        seqr.submit(r, None, type=ns.MessageType.NOOP)
    seqr.process_all_messages()
    return reps


def _string_view(s):
    view = s.get_interval_collection("c")
    return {"text": s.get_text(),
            "props": [s.get_properties(p) for p in range(s.get_length())],
            "digest": s.tree.structure_digest(),
            "intervals": sorted((iid, view.endpoints(iid),
                                 dict(view.get(iid).props))
                                for iid in view._coll.intervals)}


@pytest.mark.parametrize("seed", range(4))
def test_mock_sequencer_string_storm_matches_jax(seed):
    jreps = string_storm(JAX, seed)
    treps = string_storm(PORT, seed)
    views = [_string_view(s) for s in treps]
    assert all(v == views[0] for v in views)      # the port converges
    assert views == [_string_view(s) for s in jreps]
    assert views[0]["intervals"], "the storm made no interval"


def map_storm(ns, seed, steps=120):
    rng = random.Random(seed)
    seqr = ns.MockSequencer()
    reps = [ns.create(seqr, ns.SharedMap, "m") for _ in range(3)]
    for step in range(steps):
        m = rng.choice(reps)
        roll = rng.random()
        key = f"k{rng.randrange(6)}"
        if roll < 0.7:
            m.set(key, [step, rng.randrange(10)])
        elif roll < 0.95:
            m.delete(key)
        else:
            m.clear()
        seqr.process_some(rng.randint(0, 3))
    seqr.process_all_messages()
    return [sorted(m.items()) for m in reps]


@pytest.mark.parametrize("seed", range(2))
def test_mock_sequencer_map_storm_matches_jax(seed):
    got = map_storm(PORT, seed)
    assert all(v == got[0] for v in got)
    assert got == map_storm(JAX, seed)


# ------------------------------------------------------------- envelopes

def _batch(rng, paste):
    ops = [{"address": "default", "contents": {
        "address": "text", "contents": {
            "mt": "insert", "pos": rng.randrange(50), "kind": 0,
            "text": "".join(rng.choices("abcdefgh", k=rng.randint(1, 9))),
            "props": None, "clientSeq": i + 1}}}
        for i in range(rng.randint(2, 5))]
    if paste:
        ops.append({"address": "default", "contents": {
            "address": "text", "contents": {
                "mt": "insert", "pos": 0, "kind": 0, "props": None,
                "clientSeq": 99, "text": "".join(rng.choices(
                    "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789abcdefgh",
                    k=paste))}}})
    return ops


@pytest.mark.parametrize("paste,kind", [(0, "groupedBatch"),
                                        (6000, "compressed"),
                                        (20000, "chunkedOp")])
def test_outbox_envelopes_byte_equal_and_decoded(paste, kind):
    rng = random.Random(paste)
    batches = [_batch(rng, paste) for _ in range(3)]
    wire = {}
    for ns in (JAX, PORT):
        sent = []
        if ns is JAX:
            box = ns.Outbox(lambda c, m: sent.append((c, m)))
        else:
            box = ns.Outbox(lambda c, m, r: sent.append((c, m)),
                            lambda: 0)
        for batch in batches:
            for op in batch:
                box.submit(op, {"b": op["contents"]["contents"]["clientSeq"]})
            box.flush()
        wire[ns is PORT] = [json.dumps(c, sort_keys=True,
                                       separators=(",", ":")).encode()
                            + json.dumps(m, sort_keys=True).encode()
                            for c, m in sent]
        kinds = {c.get("type") for c, _ in sent}
        assert kind in kinds
        # each package's processor decodes each package's envelopes
        for dec in (JAX, PORT):
            rmp = dec.RMP()
            out = []
            for seq, (c, m) in enumerate(sent, 1):
                msg = dec.Msg(doc_id="d", client_id=3, client_seq=seq,
                              ref_seq=0, seq=seq, min_seq=0,
                              type=dec.MessageType.OP,
                              contents={"type": "withMeta", "contents": c,
                                        "metadata": m} if m else c)
                out += [r.contents for r in rmp.process(msg)]
            assert out == [op for batch in batches for op in batch]
    assert wire[True] == wire[False]


# ------------------------------------------------ loader on the local service

def two_containers_converge(ns):
    loader = ns.Loader(ns.Factory(), RecordingRuntime)
    a = loader.resolve("doc")
    b = loader.resolve("doc")
    assert a.connected and b.connected
    a.submit({"x": 1})
    b.submit({"y": 2})
    ops_a = [c for _, c, _ in a.runtime.ops]
    ops_b = [c for _, c, _ in b.runtime.ops]
    assert ops_a == ops_b == [{"x": 1}, {"y": 2}]
    assert a.runtime.ops[0][2] is True and a.runtime.ops[1][2] is False
    assert b.runtime.ops[0][2] is False and b.runtime.ops[1][2] is True
    return [a.runtime.ops, b.runtime.ops]


def quorum_tracks_joins(ns):
    loader = ns.Loader(ns.Factory(), RecordingRuntime)
    a = loader.resolve("doc")
    b = loader.resolve("doc")
    assert set(a.quorum.members) == {a.client_id, b.client_id}
    assert set(b.quorum.members) == {a.client_id, b.client_id}
    b.close()
    assert set(a.quorum.members) == {a.client_id}
    return sorted(a.quorum.members)


def late_joiner_catches_up(ns):
    loader = ns.Loader(ns.Factory(), RecordingRuntime)
    a = loader.resolve("doc")
    for i in range(5):
        a.submit({"i": i})
    b = loader.resolve("doc")
    assert [c for _, c, _ in b.runtime.ops] == [{"i": i} for i in range(5)]
    assert b.delta_manager.last_sequence_number == \
        a.delta_manager.last_sequence_number
    return b.runtime.ops


def disconnect_reconnect_new_client_id(ns):
    loader = ns.Loader(ns.Factory(), RecordingRuntime)
    a = loader.resolve("doc")
    first = a.client_id
    a.disconnect("test")
    assert not a.connected and a.runtime.connected is False
    a.connect()
    assert a.connected and a.client_id != first
    assert a.runtime.connected and a.runtime.client_id == a.client_id
    return [first, a.client_id]


def ops_while_disconnected_arrive_on_reconnect(ns):
    loader = ns.Loader(ns.Factory(), RecordingRuntime)
    a = loader.resolve("doc")
    b = loader.resolve("doc")
    a.disconnect("offline")
    b.submit({"while": "away"})
    assert {"while": "away"} not in [c for _, c, _ in a.runtime.ops]
    a.connect()
    assert {"while": "away"} in [c for _, c, _ in a.runtime.ops]
    return a.runtime.ops


def proposal_via_containers(ns):
    loader = ns.Loader(ns.Factory(), RecordingRuntime)
    a = loader.resolve("doc")
    b = loader.resolve("doc")
    a.propose("code", "pkg-v3")
    a.delta_manager.submit_noop()
    b.delta_manager.submit_noop()
    a.submit({"tick": 1})
    a.delta_manager.submit_noop()
    b.delta_manager.submit_noop()
    a.submit({"tick": 2})
    assert a.quorum.get("code") == "pkg-v3"
    assert b.quorum.get("code") == "pkg-v3"
    return [a.protocol.snapshot(), b.protocol.snapshot()]


def offline_load_sees_stored_ops(ns):
    loader = ns.Loader(ns.Factory(), RecordingRuntime)
    a = loader.resolve("doc")
    a.submit({"n": 1})
    c = loader.resolve("doc", connect=False)
    assert not c.connected
    assert {"n": 1} in [x for _, x, _ in c.runtime.ops]
    return c.runtime.ops


def nack_triggers_reconnect(ns):
    service = ns.LocalService()
    loader = ns.Loader(ns.Factory(service), RecordingRuntime)
    a = loader.resolve("doc")
    first_client = a.client_id
    seen = []
    a.delta_manager.on("nack", seen.append)
    a.delta_manager.connection._conn._client_seq += 5
    a.submit({"gap": True})
    assert seen, "nack should surface"
    assert a.connected and a.client_id != first_client
    return [(n.client_seq, int(n.reason)) for n in seen]


LOADER_CASES = {f.__name__: f for f in (
    two_containers_converge, quorum_tracks_joins, late_joiner_catches_up,
    disconnect_reconnect_new_client_id,
    ops_while_disconnected_arrive_on_reconnect, proposal_via_containers,
    offline_load_sees_stored_ops, nack_triggers_reconnect)}


@pytest.mark.parametrize("name", sorted(LOADER_CASES))
def test_container_on_local_service_matches_jax(name):
    assert LOADER_CASES[name](PORT) == LOADER_CASES[name](JAX)


# --------------------------------------------------- containers, both ways

def container_session(ns, cross=False, n_docs=3, rounds=3):
    """A seeded container session (``testing/service_session.py``) with
    intervals and map entries on top; returns the service and session."""
    svc = ns.LocalService()
    s = ServiceSession(svc, doc_ids(n_docs), client_cls=ns.LocalClient,
                       options_cls=ns.Options, summary_cls=ns.SummaryConfig)
    s.run(rounds, seed=5, paste_round=1, paste_every=2, chunk_every=3,
          cross=cross)
    for i, ((a, _), (ta, _, meta)) in enumerate(zip(s.containers, s.texts)):
        n = ta.get_length()
        ta.get_interval_collection("marks").add(1, min(n - 1, 6),
                                                {"doc": i})
        meta.set("count", i)
        meta.set("tags", ["a", i])
        a.flush()
    return svc, s


def _container_view(fc):
    objs = fc.initial_objects
    text, meta = objs["text"], objs["meta"]
    view = text.get_interval_collection("marks")
    return {"text": text.get_text(),
            "props": [text.get_properties(p)
                      for p in range(0, text.get_length(), 7)],
            "intervals": sorted((iid, view.endpoints(iid))
                                for iid in view._coll.intervals),
            "meta": sorted(meta.items())}


def _summary(fc):
    c = fc.container
    return {"protocol": c.protocol.snapshot(),
            "runtime": c.runtime.summarize(incremental=False)}, c.protocol.seq


def test_container_session_and_summaries_match_jax():
    """The same session through both packages' LocalService: equal
    sequenced streams, equal container views and equal summaries."""
    jsvc, js = container_session(JAX)
    tsvc, ts = container_session(PORT)
    for jd, td in zip(js.docs, ts.docs):
        jm = [(m.seq, m.min_seq, m.ref_seq, m.client_id, m.client_seq,
               int(m.type), m.contents) for m in jsvc.get_deltas(jd)]
        tm = [(m.seq, m.min_seq, m.ref_seq, m.client_id, m.client_seq,
               int(m.type), m.contents) for m in tsvc.get_deltas(td)]
        assert tm == jm
    for (ja, jb), (ta, tb) in zip(js.containers, ts.containers):
        assert _container_view(ta) == _container_view(tb) == \
            _container_view(ja) == _container_view(jb)
        assert _summary(ta) == _summary(ja)
    assert ts.summaries_acked() == js.summaries_acked() > 0
    assert ts.edits == js.edits


def _load_view(ns, doc, summary, seq):
    """Load ``summary`` (through JSON, as the Historian stores it) into a
    fresh service of ``ns``'s package; the loaded container's view."""
    target = ns.LocalService()
    loader = ns.Loader(ns.Factory(target), _runtime_factory(ns))
    target.upload_summary(doc, json.loads(json.dumps(summary)), seq)
    return _container_view(_fluid(ns, loader.resolve(doc, connect=False)))


@pytest.mark.parametrize("source", ["jax", "port"])
def test_container_summary_loads_both_ways(source):
    """A summary of one package's container loads into both packages:
    the two loaded containers are equal, and their text, properties and
    map entries are the source container's. Interval endpoints are the
    ones the reference's load gives (ROADMAP C14: they resolve in the
    window floor's view, so an interval can land shifted), in both."""
    src = JAX if source == "jax" else PORT
    _svc, s = container_session(src)
    shifted = 0
    for d, (a, _b) in zip(s.docs, s.containers):
        summary, seq = _summary(a)
        got = _load_view(PORT, d, summary, seq)
        assert got == _load_view(JAX, d, summary, seq)
        want = _container_view(a)
        for k in ("text", "props", "meta"):
            assert got[k] == want[k], k
        assert [i for i, _ in got["intervals"]] == \
            [i for i, _ in want["intervals"]]
        shifted += got["intervals"] != want["intervals"]
    assert shifted == 1      # C14, pinned: svc00001's interval moves


def _runtime_factory(ns):
    if ns is PORT:
        from fluidframework_tpu_torch.runtime.container_runtime import (
            ContainerRuntime,
        )
    else:
        from fluidframework_tpu.runtime import ContainerRuntime
    return ContainerRuntime.factory()


def _fluid(ns, container):
    if ns is PORT:
        from fluidframework_tpu_torch.framework import FluidContainer
    else:
        from fluidframework_tpu.framework import FluidContainer
    return FluidContainer(container, SCHEMA)


def test_turn_batches_cross_remote_ops_and_converge():
    """ROADMAP C13: a turn's edits, then a remote op, then the flush. The
    port sends the batch with the seq its ops were made against, so every
    replica converges; the JAX outbox stamps the seq of the flush and its
    replicas diverge (pinned here)."""
    views = {}
    for ns in (JAX, PORT):
        svc = ns.LocalService()
        a_client = ns.LocalClient(service=svc, runtime_options=ns.Options(
            flush_mode="turn"))
        b_client = ns.LocalClient(service=svc)
        a, d = a_client.create_container(SCHEMA, doc_id="d")
        b = b_client.get_container(d, SCHEMA)
        ta, tb = a.initial_objects["text"], b.initial_objects["text"]
        ta.insert_text(0, "abc")
        a.flush()
        ta.insert_text(3, "X")
        tb.insert_text(0, "Y")
        a.flush()
        views[ns is PORT] = (ta.get_text(), tb.get_text())
    assert views[True] == ("YabcX", "YabcX")
    assert views[False] == ("YabcX", "YabXc")


def test_turn_batch_made_across_a_remote_op_flushes_its_part_first():
    """An edit made after a remote op moved the seq flushes the turn's
    earlier part with its own seq (the reference's flushPartialBatches):
    two wire ops with two reference seqs, and the replicas converge."""
    svc = LocalService()
    a_client = LocalClient(service=svc, runtime_options=ContainerRuntimeOptions(
        flush_mode="turn"))
    a, d = a_client.create_container(SCHEMA, doc_id="d")
    b = LocalClient(service=svc).get_container(d, SCHEMA)
    ta, tb = a.initial_objects["text"], b.initial_objects["text"]
    ta.insert_text(0, "abc")
    a.flush()
    start = svc.deli.doc_seq(d)
    ta.insert_text(3, "X")
    tb.insert_text(0, "Y")
    ta.insert_text(0, "Z")
    a.flush()
    ops = [m for m in svc.get_deltas(d, start)
           if m.client_id == a.container.client_id]
    assert [m.ref_seq for m in ops] == [start, start + 1]
    assert ta.get_text() == tb.get_text() == "ZYabcX"


def test_registry_names_the_types_it_lacks():
    reg = default_registry()
    assert reg.types() == ["directory", "map", "sharedString"]
    with pytest.raises(KeyError, match="matrix"):
        reg.get("matrix")
