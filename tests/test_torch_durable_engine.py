"""The port's serving engines on the durable log, on the CPU, against the
JAX engines: crash drills (the engine writes to the native log or the
JSONL spill, a summary is cut, more ops land, the log is closed as a
crash closes it, the directory is reopened and the summary loaded) for
the map, string and columnar string engines and the tree engine; a map,
matrix or tree summary and its spill directory carried across packages
in both directions with its chain heads verified; a spliced, truncated
or foreign log refused by both packages with the same index and reason;
and the epoch fence: a deposed engine's next append — per op, columnar
or through the pipelined executor — raises ``FencedWriterError`` after
another engine's ``acquire_write_authority``; and the card's kill drill
(``testing/durable_drill.py``) at a small size. Every JAX wave is
blocked on before it is read. Tolerance: exact."""

import os
import shutil

import jax
import numpy as np
import pytest

from fluidframework_tpu.models.merge_tree_client import SequenceClient
from fluidframework_tpu.server import native_oplog as jnative
from fluidframework_tpu.server import oplog as joplog
from fluidframework_tpu.server import serving as jserving
from fluidframework_tpu_torch.server import native_oplog as tnative
from fluidframework_tpu_torch.server import oplog as toplog
from fluidframework_tpu_torch.server import serving as tserving
from fluidframework_tpu_torch.server.ingest_pipeline import (
    PipelinedIngestExecutor,
)
from fluidframework_tpu_torch.testing import durable_drill
from fluidframework_tpu_torch.testing.synthetic import (
    map_serving_batch, typing_storm,
)
from fluidframework_tpu_torch.utils import faultpoints as tfault
from tests.test_torch_tree_engine import _wave_args, _waves

PKGS = {
    "jax": dict(oplog=joplog, native=jnative, serving=jserving, kw={}),
    "port": dict(oplog=toplog, native=tnative, serving=tserving,
                 kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _jax_native_log():
    assert jnative.available(), "the JAX package's native log built"


def _log(name, backend, d, n=4):
    pkg = PKGS[name]
    if backend == "native":
        return pkg["native"].NativePartitionedLog(d, n)
    if os.path.isdir(d) and any(f.endswith(".jsonl") for f in os.listdir(d)):
        return pkg["oplog"].PartitionedLog.recover(n, d, "t")
    return pkg["oplog"].PartitionedLog(n, d, "t")


def _crash(log):
    """What a crash leaves: whatever was synced (the native log) or
    flushed line by line (the spill), with the handles gone."""
    if hasattr(log, "sync"):
        log.sync()
    log.close()


def _settle(eng):
    """Block on a JAX engine's device state before anything reads it."""
    state = getattr(getattr(eng, "store", None), "state", None)
    if isinstance(eng, jserving.ServingEngineBase) and state is not None:
        jax.block_until_ready(state)


# ---------------------------------------------------------- crash drills

@pytest.mark.parametrize("name", ["jax", "port"])
def test_map_engine_recovers_from_native_log(tmp_path, name):
    S = PKGS[name]["serving"]
    d = str(tmp_path)
    log = _log(name, "native", d)
    eng = S.MapServingEngine(n_docs=2, log=log, **PKGS[name]["kw"])
    eng.connect("a", 1)
    eng.submit("a", 1, 1, 0, {"op": "set", "key": "x", "value": 1})
    summary = eng.summarize()
    assert all(h is not None for h in summary["chain_heads"])
    eng.submit("a", 1, 2, 0, {"op": "set", "key": "y", "value": 2})
    eng.connect("b", 7)
    _crash(log)
    eng2 = S.MapServingEngine.load(summary, _log(name, "native", d),
                                   **PKGS[name]["kw"])
    assert eng2.read_doc("a") == {"x": 1, "y": 2}
    _, nack = eng2.submit("b", 7, 1, 0, {"op": "set", "key": "k",
                                         "value": "v"})
    assert nack is None and eng2.read_doc("b") == {"k": "v"}


@pytest.mark.parametrize("backend", ["native", "jsonl"])
def test_string_engine_per_op_crash_drill_like_jax(tmp_path, backend):
    """Per-op submits from a merge-tree client, a summary, a remove in the
    tail, a crash: both packages' loads read the client's text."""
    texts = {}
    for name in ("jax", "port"):
        S = PKGS[name]["serving"]
        d = str(tmp_path / name)
        log = _log(name, backend, d)
        eng = S.StringServingEngine(n_docs=1, capacity=128, log=log,
                                    **PKGS[name]["kw"])
        eng.connect("doc", 1)
        c = SequenceClient(1)
        for i in range(10):
            op = c.insert_text_local(c.get_length(), f"w{i} ")
            msg, nack = eng.submit("doc", 1, op["clientSeq"],
                                   c.last_processed_seq, op)
            assert nack is None
            c.apply_msg(msg)
        summary = eng.summarize()
        op = c.remove_range_local(0, 3)
        msg, _ = eng.submit("doc", 1, op["clientSeq"],
                            c.last_processed_seq, op)
        c.apply_msg(msg)
        _crash(log)
        eng2 = S.StringServingEngine.load(summary, _log(name, backend, d),
                                          **PKGS[name]["kw"])
        texts[name] = eng2.read_text("doc")
        assert texts[name] == c.get_text()
    assert texts["jax"] == texts["port"]


def _string_waves(R, O, n):
    out = []
    for b in range(n):
        planes, _ = typing_storm(R, O, seed=b)
        cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                       dtype=np.int32), (R, O))
        out.append((np.ones((R, O), np.int32), cs, np.zeros((R, O), np.int32),
                    planes["kind"], planes["a0"], planes["a1"], "abcd"))
    return out


@pytest.mark.parametrize("backend", ["native", "jsonl"])
def test_columnar_string_crash_recovery_like_jax(tmp_path, backend):
    """Columnar ingest on the durable log, a crash, a reopen: summary +
    tail replay reads what the live engine read, in both packages, and
    the port's load equals the JAX package's."""
    R, O = 4, 16
    docs = [f"doc-{i}" for i in range(R)]
    out = {}
    for name in ("jax", "port"):
        S = PKGS[name]["serving"]
        d = str(tmp_path / name)
        log = _log(name, backend, d)
        eng = S.StringServingEngine(n_docs=R, capacity=256,
                                    batch_window=10 ** 9, sequencer="native",
                                    log=log, **PKGS[name]["kw"])
        for doc in docs:
            eng.connect(doc, 1)
        rows = np.array([eng.doc_row(doc) for doc in docs], np.int32)
        summary = eng.summarize()
        for w in _string_waves(R, O, 3):
            assert eng.ingest_planes(rows, *w)["nacked"] == 0
        _settle(eng)
        want = {doc: eng.read_text(doc) for doc in docs}
        _crash(log)
        revived = S.StringServingEngine.load(
            summary, _log(name, backend, d), sequencer="native",
            **PKGS[name]["kw"])
        _settle(revived)
        got = {doc: revived.read_text(doc) for doc in docs}
        assert got == want
        out[name] = got
    assert out["jax"] == out["port"]


@pytest.mark.parametrize("backend", ["native", "jsonl"])
def test_map_columnar_crash_recovery_like_jax(tmp_path, backend):
    R, O = 6, 8
    docs = [f"m-{i}" for i in range(R)]
    out = {}
    for name in ("jax", "port"):
        S = PKGS[name]["serving"]
        log = _log(name, backend, str(tmp_path / name))
        eng = S.MapServingEngine(n_docs=R, batch_window=10 ** 9,
                                 sequencer="native", log=log, n_partitions=4,
                                 **PKGS[name]["kw"])
        for doc in docs:
            eng.connect(doc, 1)
        rows = np.array([eng.doc_row(doc) for doc in docs], np.int32)
        summary = eng.summarize()
        kind, kidx, keys, vidx, values = map_serving_batch(R, O, 2, n_keys=6)
        cseq = np.broadcast_to(np.arange(1, O + 1, dtype=np.int32), (R, O))
        eng.ingest_planes(rows, np.ones((R, O), np.int32), cseq,
                          np.zeros((R, O), np.int32), kind, kidx, keys,
                          values, vidx)
        _settle(eng)
        want = {doc: eng.read_doc(doc) for doc in docs}
        _crash(log)
        revived = S.MapServingEngine.load(
            summary, _log(name, backend, str(tmp_path / name)),
            **PKGS[name]["kw"])
        out[name] = {doc: revived.read_doc(doc) for doc in docs}
        assert out[name] == want
    assert out["jax"] == out["port"]


def _tree_engine(name, log, docs):
    eng = PKGS[name]["serving"].TreeServingEngine(
        n_docs=len(docs), capacity=128, batch_window=10 ** 9,
        sequencer="native", log=log, **PKGS[name]["kw"])
    for doc in docs:
        eng.connect(doc, 1)
        eng.doc_row(doc)
    return eng


def test_tree_engine_on_native_log_like_jax(tmp_path):
    """Tree record batches (``TreeRecordOps``, tag T) on the native log:
    crash, reopen, load; the port's trees equal the JAX package's."""
    docs = [f"t{i}" for i in range(6)]
    waves = _waves(docs, 3, seed=31)
    out = {}
    for name in ("jax", "port"):
        S = PKGS[name]["serving"]
        d = str(tmp_path / name)
        log = _log(name, "native", d)
        eng = _tree_engine(name, log, docs)
        cs = {}
        eng.ingest_batch(*_wave_args(waves[0], cs))
        _settle(eng)
        summary = eng.summarize()
        for wave in waves[1:]:
            eng.ingest_batch(*_wave_args(wave, cs))
            _settle(eng)
        want = {doc: eng.to_dict(doc) for doc in docs}
        _crash(log)
        revived = S.TreeServingEngine.load(
            summary, _log(name, "native", d), sequencer="native",
            **PKGS[name]["kw"])
        _settle(revived)
        out[name] = {doc: revived.to_dict(doc) for doc in docs}
        assert out[name] == want
    assert out["jax"] == out["port"]


# ------------------------------------------------- summaries across packages

def _map_run(name, log, docs, waves=2, seed=0):
    S = PKGS[name]["serving"]
    eng = S.MapServingEngine(n_docs=len(docs), batch_window=10 ** 9,
                             sequencer="native", log=log, n_partitions=4,
                             **PKGS[name]["kw"])
    for doc in docs:
        eng.connect(doc, 1)
    rows = np.array([eng.doc_row(doc) for doc in docs], np.int32)
    R, O = len(docs), 8
    summary = None
    for b in range(waves):
        kind, kidx, keys, vidx, values = map_serving_batch(
            R, O, seed + b, n_keys=6)
        cseq = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                         dtype=np.int32), (R, O))
        eng.ingest_planes(rows, np.ones((R, O), np.int32), cseq,
                          np.zeros((R, O), np.int32), kind, kidx, keys,
                          values, vidx)
        _settle(eng)
        if b == 0:
            summary = eng.summarize()
    return eng, summary


def _matrix_run(name, log, docs):
    S = PKGS[name]["serving"]
    eng = S.MatrixServingEngine(n_docs=len(docs), cell_capacity=256,
                                axis_capacity=32, batch_window=10 ** 9,
                                sequencer="native", log=log,
                                **PKGS[name]["kw"])
    for doc in docs:
        eng.connect(doc, 1)
    cs = {doc: 0 for doc in docs}

    def op(doc, contents):
        cs[doc] += 1
        _, nack = eng.submit(doc, 1, cs[doc], eng.deli.doc_seq(doc) - 1,
                             contents)
        assert nack is None

    for doc in docs:
        op(doc, {"mx": "insRow", "pos": 0, "count": 3, "opKey": (1, 0)})
        op(doc, {"mx": "insCol", "pos": 0, "count": 3, "opKey": (1, 1)})
    eng.flush()
    summary = eng.summarize()
    for i, doc in enumerate(docs):
        op(doc, {"mx": "setCell", "row": i % 3, "col": 1, "value": i})
        op(doc, {"mx": "insRow", "pos": 1, "count": 1, "opKey": (1, 2)})
    eng.flush()
    _settle(eng)
    return eng, summary


def _tree_run(name, log, docs):
    eng = _tree_engine(name, log, docs)
    cs = {}
    waves = _waves(docs, 2, seed=41)
    eng.ingest_batch(*_wave_args(waves[0], cs))
    _settle(eng)
    summary = eng.summarize()
    eng.ingest_batch(*_wave_args(waves[1], cs))
    _settle(eng)
    return eng, summary


def _reads(family, eng, docs):
    if family == "map":
        return {d: eng.read_doc(d) for d in docs}
    if family == "matrix":
        return {d: eng.to_lists(d) for d in docs}
    return {d: eng.to_dict(d) for d in docs}


RUNS = {"map": (_map_run, "MapServingEngine"),
        "matrix": (_matrix_run, "MatrixServingEngine"),
        "tree": (_tree_run, "TreeServingEngine")}


@pytest.mark.parametrize("family", sorted(RUNS))
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_summary_and_spill_load_across_packages(tmp_path, family, writer,
                                                reader):
    """One package's summary and its spill directory load into the other
    package's engine: the chain heads are checked against the reader's
    own recovery of the directory, and the reads equal the writer's."""
    run, cls = RUNS[family]
    docs = [f"{family}-{i}" for i in range(4)]
    d = str(tmp_path)
    log = _log(writer, "jsonl", d)
    eng, summary = run(writer, log, docs)
    want = _reads(family, eng, docs)
    assert all(h not in (None, 0) for h in summary["chain_heads"][:1])
    _crash(log)
    rlog = _log(reader, "jsonl", d)
    assert [rlog.chain_at(p, o) for p, o in
            enumerate(summary["log_offsets"])] == summary["chain_heads"]
    kw = dict(PKGS[reader]["kw"], sequencer="native")
    loaded = getattr(PKGS[reader]["serving"], cls).load(summary, rlog, **kw)
    _settle(loaded)
    assert _reads(family, loaded, docs) == want


def _refusal(name, summary, d):
    """(index, reason) of the refusal of ``summary`` over directory
    ``d`` by package ``name`` (recovery or load, whichever refuses)."""
    O = PKGS[name]["oplog"]
    try:
        log = O.PartitionedLog.recover(4, d, "t")
        PKGS[name]["serving"].MapServingEngine.load(
            summary, log, sequencer="native", **PKGS[name]["kw"])
    except O.OplogCorruptionError as e:
        return e.index, e.reason
    raise AssertionError(f"{name} loaded a corrupt log")


@pytest.mark.parametrize("damage", ["splice", "boundary", "foreign"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corrupt_log_refused_by_both_alike(tmp_path, damage, writer):
    """A spliced spill (a record cut out mid-file), a spill truncated at a
    record boundary behind the summary, and a spill of another history
    with the same record counts: both packages refuse the summary's load
    with the same ``OplogCorruptionError`` index and reason."""
    docs = [f"m-{i}" for i in range(8)]
    src = str(tmp_path / "src")
    log = _log(writer, "jsonl", src)
    eng, summary = _map_run(writer, log, docs, waves=6)
    _crash(log)
    spills = [open(os.path.join(src, f"t-p{p}.jsonl"), "rb").read()
              for p in range(4)]
    part = (int(np.argmax([s.count(b"\n") for s in spills]))
            if damage == "splice" else int(np.argmax(summary["log_offsets"])))
    path = os.path.join(src, f"t-p{part}.jsonl")
    lines = spills[part].splitlines(True)
    if damage == "splice":
        assert len(lines) >= 3
        open(path, "wb").write(b"".join(lines[:1] + lines[2:]))
    elif damage == "boundary":
        open(path, "wb").write(b"".join(
            lines[:summary["log_offsets"][part] - 1]))
    else:
        other = str(tmp_path / "other")
        olog = _log(writer, "jsonl", other)
        _map_run(writer, olog, docs, waves=6, seed=7)
        _crash(olog)
        shutil.rmtree(src)
        shutil.copytree(other, src)
    refusals = {}
    for name in ("jax", "port"):
        d = str(tmp_path / f"copy-{name}")
        shutil.copytree(src, d)
        refusals[name] = _refusal(name, summary, d)
    assert refusals["jax"] == refusals["port"]
    reason = refusals["port"][1]
    assert reason == {"splice": "chain mismatch",
                      "boundary": "log shorter than summary anchor",
                      "foreign": "chain anchor mismatch"}[damage]


# --------------------------------------------------------------- the fence

@pytest.mark.parametrize("backend", ["native", "jsonl"])
def test_deposed_engine_is_fenced(tmp_path, backend):
    """A second engine on the same directory loads the first's summary
    and takes write authority: the first engine's next append — per op,
    columnar, or a join — raises ``FencedWriterError`` and lands nothing,
    while the new writer goes on appending."""
    R, O = 4, 8
    d = str(tmp_path)
    old = tserving.StringServingEngine(
        n_docs=R, capacity=128, batch_window=10 ** 9, sequencer="native",
        log=_log("port", backend, d), device="cpu")
    docs = [f"doc-{i}" for i in range(R)]
    for doc in docs:
        old.connect(doc, 1)
    rows = np.array([old.doc_row(doc) for doc in docs], np.int32)
    waves = _string_waves(R, O, 3)
    old.ingest_planes(rows, *waves[0])
    assert old.writer_epoch == 0 and old.deli.epoch == 0
    summary = old.summarize()
    if backend == "native":
        old.log.sync()
    new = tserving.StringServingEngine.load(
        summary, _log("port", backend, d), device="cpu", sequencer="native")
    assert new.writer_epoch == 0        # a load alone deposes nobody
    assert new.acquire_write_authority() == 1 and new.deli.epoch == 1
    sizes = [old.log.size(p) for p in range(4)]
    with pytest.raises(toplog.FencedWriterError) as ei:
        old.submit(docs[0], 1, O + 1, old.deli.doc_seq(docs[0]),
                   {"mt": "insert", "kind": 0, "pos": 0, "text": "z"})
    assert (ei.value.epoch, ei.value.fence) == (0, 1)
    with pytest.raises(toplog.FencedWriterError):
        old.connect(docs[1], 9)
    with pytest.raises(toplog.FencedWriterError):
        old.ingest_planes(rows, *waves[1])
    assert [old.log.size(p) for p in range(4)] == sizes
    assert new.ingest_planes(rows, *waves[1])["nacked"] == 0
    assert sum(new.log.size(p) for p in range(4)) > sum(sizes)


def test_pipelined_log_stage_reaches_the_fence(tmp_path):
    """The pipelined executor's log stage appends through the engine, so
    a deposed engine's wave fails at the fence, not in the log."""
    R, O = 4, 8
    d = str(tmp_path)
    old = tserving.StringServingEngine(
        n_docs=R, capacity=128, batch_window=10 ** 9, sequencer="native",
        log=_log("port", "jsonl", d), device="cpu")
    docs = [f"doc-{i}" for i in range(R)]
    for doc in docs:
        old.connect(doc, 1)
    rows = np.array([old.doc_row(doc) for doc in docs], np.int32)
    waves = _string_waves(R, O, 2)
    ex = PipelinedIngestExecutor(old, depth=2)
    ex.submit(rows, *waves[0]).result()
    toplog.PartitionedLog.recover(4, d, "t").bump_fence()
    ticket = ex.submit(rows, *waves[1])
    with pytest.raises(toplog.FencedWriterError):
        ticket.result()
    with pytest.raises(RuntimeError, match="failed at wave 1") as ei:
        ex.drain()
    assert isinstance(ei.value.__cause__, toplog.FencedWriterError)
    ex.close()


def test_crash_mid_spill_acks_nothing_and_recovers(tmp_path):
    """A crash between the write syscalls of a columnar record's line (a
    partial line on disk) fails the wave before its ack; the reopened
    spill drops the torn line and the load serves the acked waves."""
    R, O = 4, 8
    d = str(tmp_path)
    log = _log("port", "jsonl", d)
    eng = tserving.StringServingEngine(
        n_docs=R, capacity=128, batch_window=10 ** 9, sequencer="native",
        log=log, device="cpu")
    docs = [f"doc-{i}" for i in range(R)]
    for doc in docs:
        eng.connect(doc, 1)
    rows = np.array([eng.doc_row(doc) for doc in docs], np.int32)
    summary = eng.summarize()
    waves = _string_waves(R, O, 2)
    eng.ingest_planes(rows, *waves[0])
    want = {doc: eng.read_text(doc) for doc in docs}

    class TearOnce:
        def hit(self, site, **ctx):
            if site == tfault.SITE_OPLOG_MID_SPILL:
                ctx["fh"].write(ctx["line"][:len(ctx["line"]) // 2])
                ctx["fh"].flush()
                raise tfault.CrashInjected(site)

    with tfault.armed(TearOnce()):
        with pytest.raises(tfault.CrashInjected):
            eng.ingest_planes(rows, *waves[1])
    log.close()
    shutil.copytree(d, str(tmp_path / "j"))
    revived = tserving.StringServingEngine.load(
        summary, _log("port", "jsonl", d), device="cpu", sequencer="native")
    assert {doc: revived.read_text(doc) for doc in docs} == want
    # the JAX package truncates the same torn line at the same byte
    jlog = joplog.PartitionedLog.recover(4, str(tmp_path / "j"), "t")
    assert [jlog.size(p) for p in range(4)] == \
        [revived.log.size(p) for p in range(4)]
    for p in range(4):
        f = f"t-p{p}.jsonl"
        assert (tmp_path / "j" / f).read_bytes() == \
            open(os.path.join(d, f), "rb").read()


def test_kill_drill_recovers_the_acked_batches_on_the_cpu(tmp_path):
    """The card's kill drill at a small size on the CPU: a child serves
    config #4's waves on the native log with a sync a batch, is
    SIGKILLed inside a batch's log append after its summary, and the
    reopened directory loads to exactly the batches on disk — every
    acked one, and the killed one only if its record landed whole."""
    D, S, O = 64, 512, 64
    ev = durable_drill.kill_drill(str(tmp_path), D, S, O, summary_after=1,
                                  kill_batch=3, device="cpu")
    assert ev["killed_mid_batch"] and ev["rc"] == -9, ev
    assert ev["last_acked"] >= 2
    eng, log, torn = durable_drill.recover(str(tmp_path), ev["summary"],
                                           device="cpu")
    m = durable_drill.batches_on_disk(log, D)
    assert m in (ev["last_acked"] + 1, ev["last_acked"] + 2), (m, ev)
    # the kill landed inside the killed batch's append: its frame was
    # torn (the reopen cut it) or already whole
    assert torn > 0 or m == ev["last_acked"] + 2, (torn, m, ev)
    docs = durable_drill.doc_ids(D)
    ref, rows = durable_drill.make_engine(docs, S, toplog.PartitionedLog(8),
                                          "cpu")
    for b in range(m):
        ref.ingest_planes(rows, **durable_drill.config4_wave(D, O, b))
    assert np.array_equal(durable_drill.ranked_digests(eng, rows),
                          durable_drill.ranked_digests(ref, rows))
    for d in docs:
        assert eng.read_text(d) == ref.read_text(d), d
        assert eng.deli.doc_seq(d) == ref.deli.doc_seq(d), d
    # the recovered engine keeps serving on the reopened log
    wave = durable_drill.config4_wave(D, O, m)
    assert eng.ingest_planes(rows, **wave)["nacked"] == 0
    ref.ingest_planes(rows, **wave)
    assert np.array_equal(durable_drill.ranked_digests(eng, rows),
                          durable_drill.ranked_digests(ref, rows))
    log.close()
