"""The port's in-process ordering service (``server/tinylicious.py``,
``server/services.py``) against the JAX package's: the nine scenarios of
``tests/test_server.py``, a checkpoint restart and a recovery from the
JSONL spill, each run through both packages' ``LocalService`` with the
same inputs. The sequenced streams must be equal field by field (doc,
seq, min_seq, ref_seq, client id, client seq, type, contents, address),
and so must the nacks, the dup-acks and the Historian's handles. The Deli
timestamps and the trace ids are the only fields left out: both are the
wall clock's and the process's. Tolerance: exact."""

import types

import pytest

from fluidframework_tpu.core.protocol import MessageType as JMessageType
from fluidframework_tpu.models.merge_tree import MergeTree as JMergeTree
from fluidframework_tpu.models.merge_tree_client import (
    SequenceClient as JSequenceClient,
)
from fluidframework_tpu.server.deli import NackReason as JNackReason
from fluidframework_tpu.server.oplog import (
    FencedWriterError as JFencedWriterError,
)
from fluidframework_tpu.server.oplog import partition_of as jpartition_of
from fluidframework_tpu.server.tinylicious import LocalService as JService
from fluidframework_tpu_torch.core.protocol import MessageType
from fluidframework_tpu_torch.models.merge_tree import MergeTree
from fluidframework_tpu_torch.models.merge_tree_client import SequenceClient
from fluidframework_tpu_torch.server.deli import NackReason
from fluidframework_tpu_torch.server.oplog import (
    FencedWriterError, partition_of,
)
from fluidframework_tpu_torch.server.tinylicious import LocalService

JAX = types.SimpleNamespace(
    LocalService=JService, SequenceClient=JSequenceClient,
    MessageType=JMessageType, NackReason=JNackReason, MergeTree=JMergeTree,
    partition_of=jpartition_of, FencedWriterError=JFencedWriterError)
PORT = types.SimpleNamespace(
    LocalService=LocalService, SequenceClient=SequenceClient,
    MessageType=MessageType, NackReason=NackReason, MergeTree=MergeTree,
    partition_of=partition_of, FencedWriterError=FencedWriterError)


class StringReplica:
    """``tests/test_server.py``'s minimal client binding: a SequenceClient
    wired to a DeltaConnection."""

    def __init__(self, ns, service, doc_id):
        self.ns = ns
        self.conn = service.connect(doc_id)
        self.client = ns.SequenceClient(self.conn.client_id)
        self.conn.on_op(self._on_op)

    def _on_op(self, msg):
        if msg.type == self.ns.MessageType.OP:
            self.client.apply_msg(msg)
        else:
            self.client.last_processed_seq = msg.seq
            if msg.min_seq > self.client.tree.min_seq:
                self.client.tree.zamboni(msg.min_seq)

    def insert(self, pos, text):
        op = self.client.insert_text_local(pos, text)
        self.conn.submit(op, ref_seq=self.client.last_processed_seq)

    def remove(self, start, end):
        op = self.client.remove_range_local(start, end)
        self.conn.submit(op, ref_seq=self.client.last_processed_seq)

    @property
    def text(self):
        return self.client.get_text()


def stream(svc):
    """Every doc's sequenced stream from the Scriptorium, field by field."""
    out = {}
    for doc in sorted(svc.scriptorium._ops):
        out[doc] = [(m.doc_id, m.seq, m.min_seq, m.ref_seq, m.client_id,
                     m.client_seq, int(m.type), m.contents, m.address)
                    for m in svc.get_deltas(doc)]
    return out


def nacks(svc):
    return [(n.doc_id, n.client_id, n.client_seq, int(n.reason), n.seq)
            for n in svc.nacks]


# ------------------------------------------------------------- scenarios
# Each runs one of tests/test_server.py's scenarios on the namespace's
# package, asserts what that test asserts, and returns what both
# packages must agree on.

def two_clients_collaborate(ns, _tmp):
    svc = ns.LocalService()
    a = StringReplica(ns, svc, "doc1")
    b = StringReplica(ns, svc, "doc1")
    a.insert(0, "hello")
    b.insert(0, "world ")
    a.insert(5, "!")
    assert a.text == b.text
    assert "hello" in a.text and "world" in a.text
    return {"stream": stream(svc), "text": a.text}


def documents_are_isolated(ns, _tmp):
    svc = ns.LocalService()
    a = StringReplica(ns, svc, "docA")
    b = StringReplica(ns, svc, "docB")
    a.insert(0, "aaa")
    b.insert(0, "bbb")
    assert a.text == "aaa" and b.text == "bbb"
    return {"stream": stream(svc)}


def unknown_client_nacked(ns, _tmp):
    svc = ns.LocalService()
    svc.connect("doc")
    conn2 = svc.connect("doc")
    conn2.disconnect()
    svc._ingest("doc", conn2.client_id, 1, 0, ns.MessageType.OP, {"x": 1},
                None)
    assert svc.nacks and \
        svc.nacks[-1].reason == ns.NackReason.UNKNOWN_CLIENT
    return {"stream": stream(svc), "nacks": nacks(svc)}


def duplicate_and_gap_nacks(ns, _tmp):
    svc = ns.LocalService()
    conn = svc.connect("doc")
    op = ns.MessageType.OP
    svc._ingest("doc", conn.client_id, 1, 0, op, {"n": 1}, None)
    svc._ingest("doc", conn.client_id, 1, 0, op, {"n": 1}, None)
    # a duplicate of a durable op is dup-acked with its original seq
    assert not svc.nacks
    assert conn.dup_acks and conn.dup_acks[-1].client_seq == 1
    assert conn.dup_acks[-1].seq > 0
    svc._ingest("doc", conn.client_id, 5, 0, op, {"n": 5}, None)
    assert svc.nacks[-1].reason == ns.NackReason.CLIENT_SEQ_GAP
    assert len([m for m in svc.get_deltas("doc", 0) if m.type == op]) == 1
    return {"stream": stream(svc), "nacks": nacks(svc),
            "dup_acks": [(n.client_seq, n.seq) for n in conn.dup_acks]}


def catchup_via_scriptorium(ns, _tmp):
    svc = ns.LocalService()
    a = StringReplica(ns, svc, "doc")
    a.insert(0, "abc")
    a.insert(3, "def")
    late = StringReplica(ns, svc, "doc")
    for msg in svc.get_deltas("doc"):
        if msg.type == ns.MessageType.OP and \
                msg.seq > late.client.last_processed_seq:
            late.client.apply_msg(msg)
    assert late.text == a.text == "abcdef"
    return {"stream": stream(svc),
            "tail": [m.seq for m in svc.get_deltas("doc", 2, 4)]}


def summary_upload_and_ack(ns, _tmp):
    svc = ns.LocalService()
    a = StringReplica(ns, svc, "doc")
    a.insert(0, "summarize me")
    summary = a.client.tree.summarize()
    seq = a.client.last_processed_seq
    sha = svc.upload_summary("doc", summary, seq)
    acks = []
    a.conn.on_op(lambda m: acks.append(m) if m.type in (
        ns.MessageType.SUMMARY_ACK, ns.MessageType.SUMMARY_NACK) else None)
    a.conn.submit({"handle": sha}, type=ns.MessageType.SUMMARIZE,
                  ref_seq=seq)
    assert acks and acks[0].type == ns.MessageType.SUMMARY_ACK
    loaded, got_seq, got_sha = svc.latest_summary("doc")
    assert got_sha == sha and got_seq == seq
    assert ns.MergeTree.load(loaded, 99).get_text() == "summarize me"
    a.conn.submit({"handle": "deadbeef"}, type=ns.MessageType.SUMMARIZE,
                  ref_seq=seq)
    assert acks[-1].type == ns.MessageType.SUMMARY_NACK
    return {"stream": stream(svc), "sha": sha,
            "blob": svc.historian.read_blob(sha),
            "scribe": dict(svc.scribe.last_summary_seq)}


def sequencer_checkpoint_restart(ns, _tmp):
    svc = ns.LocalService()
    a = StringReplica(ns, svc, "doc")
    a.insert(0, "x")
    ckpt = svc.checkpoint()
    seq_before = svc.deli.doc_seq("doc")
    svc.restart_sequencer(ckpt)
    assert svc.deli.doc_seq("doc") == seq_before
    a.insert(1, "y")
    assert a.text == "xy"
    return {"stream": stream(svc), "checkpoint": ckpt}


def msn_advances_and_zamboni(ns, _tmp):
    svc = ns.LocalService()
    a = StringReplica(ns, svc, "doc")
    b = StringReplica(ns, svc, "doc")
    a.insert(0, "abcdef")
    a.remove(1, 3)
    noop = ns.MessageType.NOOP
    a.conn.submit({}, type=noop, ref_seq=a.client.last_processed_seq)
    b.conn.submit({}, type=noop, ref_seq=b.client.last_processed_seq)
    a.conn.submit({}, type=noop, ref_seq=a.client.last_processed_seq)
    assert a.text == b.text == "adef"
    assert all(s.removed_seq is None for s in a.client.tree.segments)
    return {"stream": stream(svc),
            "digest": a.client.tree.structure_digest()}


def partitioning_is_stable(ns, _tmp):
    assert ns.partition_of("doc-42", 8) == ns.partition_of("doc-42", 8)
    spread = [ns.partition_of(f"doc-{i}", 8) for i in range(100)]
    assert len(set(spread)) > 4
    return {"spread": spread}


def checkpoint_file_restart(ns, tmp):
    """``save_checkpoint`` / ``load_checkpoint`` (sequencer state and both
    logs' offsets), then a restart of the sequencer from the file."""
    svc = ns.LocalService(n_partitions=2)
    a = StringReplica(ns, svc, "doc")
    b = StringReplica(ns, svc, "other")
    a.insert(0, "ab")
    b.insert(0, "cd")
    path = str(tmp / "ckpt.json")
    svc.save_checkpoint(path)
    loaded = ns.LocalService.load_checkpoint(path)
    svc.restart_sequencer(loaded["deli"])
    a.insert(2, "e")
    b.remove(0, 1)
    assert a.text == "abe" and b.text == "d"
    return {"stream": stream(svc), "checkpoint": loaded}


def recover_from_spill(ns, tmp):
    """A crash and ``recover`` from the JSONL spill: the epoch and the
    writer fence move, every acked op comes back, the deposed instance is
    refused, a resubmit of a durable op is dup-acked and a reconnect keeps
    its seat; then the session goes on."""
    d = str(tmp / "spill")
    svc = ns.LocalService(n_partitions=2, spill_dir=d)
    a = StringReplica(ns, svc, "doc")
    b = StringReplica(ns, svc, "doc2")
    a.insert(0, "hello")
    a.insert(5, " world")
    b.insert(0, "x")
    before = stream(svc)
    rec = ns.LocalService.recover(d, n_partitions=2)
    assert stream(rec) == before
    assert rec.epoch == 1 and rec.writer_epoch > svc.writer_epoch
    with pytest.raises(ns.FencedWriterError):
        svc._ingest("doc", a.conn.client_id, 3, 0, ns.MessageType.OP,
                    {"late": True}, None)
    conn = rec.reconnect("doc", a.conn.client_id)
    assert conn._client_seq == rec.last_client_seq("doc", a.conn.client_id)
    rec._ingest("doc", conn.client_id, 2, 0, ns.MessageType.OP,
                {"again": True}, None)
    assert conn.dup_acks and conn.dup_acks[-1].seq > 0
    late = StringReplica(ns, rec, "doc")
    for m in rec.get_deltas("doc"):
        if m.type == ns.MessageType.OP and \
                m.seq > late.client.last_processed_seq:
            late.client.apply_msg(m)
    late.insert(0, ">")
    assert late.text == ">hello world"
    rec.close()
    return {"stream": stream(rec), "epoch": rec.epoch,
            "writer_epoch": rec.writer_epoch, "nacks": nacks(rec),
            "dup_acks": [(n.client_seq, n.seq) for n in conn.dup_acks]}


SCENARIOS = {f.__name__: f for f in (
    two_clients_collaborate, documents_are_isolated, unknown_client_nacked,
    duplicate_and_gap_nacks, catchup_via_scriptorium,
    summary_upload_and_ack, sequencer_checkpoint_restart,
    msn_advances_and_zamboni, partitioning_is_stable,
    checkpoint_file_restart, recover_from_spill)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = SCENARIOS[name](JAX, tmp_path / "jax")
    got = SCENARIOS[name](PORT, tmp_path / "port")
    assert got == want


def test_port_recovers_the_jax_spill(tmp_path):
    """Both packages spill the same records: the port recovers a spill
    the JAX service wrote and goes on exactly as the JAX recovery does."""
    d = str(tmp_path)
    svc = JService(n_partitions=2, spill_dir=d)
    a = StringReplica(JAX, svc, "doc")
    a.insert(0, "abc")
    a.remove(0, 1)
    svc.close()
    import shutil
    shutil.copytree(d, str(tmp_path / "copy"), dirs_exist_ok=True)
    jrec = JService.recover(d, n_partitions=2)
    trec = LocalService.recover(str(tmp_path / "copy"), n_partitions=2)
    assert stream(trec) == stream(jrec)
    assert (trec.epoch, trec.writer_epoch) == (jrec.epoch, jrec.writer_epoch)
    for ns, rec in ((JAX, jrec), (PORT, trec)):
        r = StringReplica(ns, rec, "doc")
        for m in rec.get_deltas("doc"):
            if m.type == ns.MessageType.OP and \
                    m.seq > r.client.last_processed_seq:
                r.client.apply_msg(m)
        r.insert(2, "d")
        assert r.text == "bcd"
    assert stream(trec) == stream(jrec)


def test_signals_bypass_sequencing():
    """Signals fan out to every connection on the doc, the sender's
    included, and are never sequenced or stored (both packages)."""
    seen = {}
    for ns in (JAX, PORT):
        svc = ns.LocalService()
        c1, c2 = svc.connect("d"), svc.connect("d")
        other = svc.connect("e")
        got = []
        for c in (c1, c2, other):
            c.on_signal(lambda s, c=c: got.append((c.client_id, s.client_id,
                                                   s.contents)))
        c1.submit_signal({"cursor": 3})
        seen[ns is PORT] = (got, stream(svc))
    assert seen[True] == seen[False]
    assert len(seen[True][0]) == 2


def test_tracing_parents_deli_and_apply_spans():
    """The raw-log record carries the submitter's context and the Deli and
    apply spans parent on it (the port's tracer)."""
    from fluidframework_tpu_torch.utils import tracing
    svc = LocalService()
    conn = svc.connect("doc")
    with tracing.span("client.batch") as root:
        conn.submit({"x": 1})
    deli = [e for e in tracing.TRACER.events(root.ctx.trace_id)
            if e["name"] == "deli.sequence"]
    apply = [e for e in tracing.TRACER.events(root.ctx.trace_id)
             if e["name"] == "serving.apply"]
    assert deli and deli[-1]["parent_id"] == root.ctx.span_id
    assert apply and apply[-1]["parent_id"] == deli[-1]["span_id"]
    msg = svc.get_deltas("doc")[-1]
    assert msg.trace["tid"] == root.ctx.trace_id
    assert tracing.current_wire() is None


def test_deli_checkpoint_files_are_the_jax_files(tmp_path):
    """``DeliSequencer.save_checkpoint`` writes the JAX package's bytes,
    and each package's ``load_checkpoint`` restores the other's."""
    from fluidframework_tpu.server.deli import DeliSequencer as JDeli
    from fluidframework_tpu_torch.server.deli import DeliSequencer
    delis = {}
    for key, cls in (("jax", JDeli), ("port", DeliSequencer)):
        d = cls(clock=lambda: 0.0)
        d.client_join("doc", 1)
        d.client_join("doc", 2)
        d.sequence("doc", 1, 1, 1, 0, {"x": 1})
        d.sequence("doc", 2, 1, 2, 0, {"y": 2})
        d.client_leave("doc", 1)
        assert d.is_member("doc", 2) and not d.is_member("doc", 1)
        assert d.last_client_seq("doc", 2) == 1
        assert d.last_client_seq("nope", 2) == 0
        d.save_checkpoint(str(tmp_path / f"{key}.json"))
        delis[key] = d
    a = (tmp_path / "jax.json").read_bytes()
    assert a == (tmp_path / "port.json").read_bytes()
    back = DeliSequencer.load_checkpoint(str(tmp_path / "jax.json"))
    jback = JDeli.load_checkpoint(str(tmp_path / "port.json"))
    assert back.checkpoint() == jback.checkpoint() == \
        delis["jax"].checkpoint()
