"""The port's durable op log against the JAX package's: the JSONL spill
(``server/oplog.py``) and the native CRC-framed segments
(``server/native_oplog.py`` + ``native/oplog.cpp``) are a file format, so
the same records give byte-identical files in both packages, and each
package recovers the other's directory to the same records, chain words
and torn-tail truncation point. Then the integrity cases (checksum chain,
torn tail, splice, bit flip, boundary truncation, regrowth, epoch fence)
run through both packages, with the counters each reads from its own
``REGISTRY``, and the codec and reopen cases of the native log. Records
carry fixed timestamps; every case writes under ``tmp_path``. Tolerance:
exact."""

import dataclasses
import json
import os
import random
import shutil
import types

import numpy as np
import pytest

from fluidframework_tpu.core import protocol as jprotocol
from fluidframework_tpu.server import native_oplog as jnative
from fluidframework_tpu.server import oplog as joplog
from fluidframework_tpu.server import serving as jserving
from fluidframework_tpu.utils import faultpoints as jfault
from fluidframework_tpu.utils import telemetry as jtelemetry
from fluidframework_tpu_torch.core import protocol as tprotocol
from fluidframework_tpu_torch.native import build as tbuild
from fluidframework_tpu_torch.server import native_oplog as tnative
from fluidframework_tpu_torch.server import oplog as toplog
from fluidframework_tpu_torch.server import serving as tserving
from fluidframework_tpu_torch.testing.synthetic import typing_storm
from fluidframework_tpu_torch.utils import faultpoints as tfault
from fluidframework_tpu_torch.utils import telemetry as ttelemetry

JAX = types.SimpleNamespace(
    name="jax", protocol=jprotocol, oplog=joplog, native=jnative,
    serving=jserving, fault=jfault, REGISTRY=jtelemetry.REGISTRY, kw={})
PORT = types.SimpleNamespace(
    name="port", protocol=tprotocol, oplog=toplog, native=tnative,
    serving=tserving, fault=tfault, REGISTRY=ttelemetry.REGISTRY,
    kw={"device": "cpu"})
PKGS = {"jax": JAX, "port": PORT}
BACKENDS = ("jsonl", "native")


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    if request.param == "jax":
        assert jnative.available(), "the JAX package's native log built"
    return PKGS[request.param]


def _counter(pkg, name):
    return pkg.REGISTRY.snapshot().get(name, 0)


def _open(pkg, backend, d, n=4):
    """A new (or reopened, torn tail truncated) log on directory ``d``."""
    if backend == "native":
        return pkg.native.NativePartitionedLog(d, n)
    if os.path.isdir(d) and any(f.endswith(".jsonl") for f in os.listdir(d)):
        return pkg.oplog.PartitionedLog.recover(n, d, "t")
    return pkg.oplog.PartitionedLog(n, d, "t")


def _records(pkg):
    """One of every record kind the engines append, from fixed data."""
    P = pkg.protocol
    rng = np.random.default_rng(11)
    n = 23
    planes = {f: rng.integers(0, 1 << 12, n).astype(np.int64) for f in (
        "client", "client_seq", "ref_seq", "seq", "min_seq")}
    planes["seq"] = np.arange(5, 5 + n, dtype=np.int64)
    str_rec = pkg.serving.ColumnarOps(
        doc_ids=["doc-α", "doc-b"], doc=rng.integers(0, 2, n),
        kind=rng.integers(0, 3, n), a0=rng.integers(0, 90, n),
        a1=rng.integers(0, 90, n), text="abcd αβ", timestamp=1234.5,
        texts=["x", "yz", "ω"],
        props=[{"bold": True}, {"k": 2}, {"s": "v"}],
        tidx=rng.integers(0, 3, n), **planes)
    map_rec = pkg.serving.ColumnarOps(
        doc_ids=["m0"], doc=np.zeros(n, np.int64),
        kind=rng.integers(0, 3, n), a0=rng.integers(0, 4, n),
        a1=rng.integers(0, 2, n), text="", timestamp=1235.0, family="map",
        keys=["k0", "k1", "k2", "k3"], values=[[1, 2], {"v": None}],
        **planes)
    r = 9
    tree_rec = pkg.serving.TreeRecordOps(
        doc_ids=["t0", "t1"], doc=rng.integers(0, 2, 4),
        client=np.ones(4, np.int64), client_seq=np.arange(1, 5),
        ref_seq=np.zeros(4, np.int64), seq=np.arange(2, 6),
        min_seq=np.zeros(4, np.int64),
        rec_op=np.sort(rng.integers(0, 4, r)),
        recs=rng.integers(-3, 1 << 17, (r, 8)).astype(np.int32),
        ids=["a", "b"], fields=["f"], types=["T"], values=[3.5, "s"],
        timestamp=1236.25)
    msgs = [P.SequencedDocumentMessage(
        doc_id="d", client_id=1, client_seq=0, ref_seq=0, seq=1, min_seq=0,
        type=P.MessageType.CLIENT_JOIN, contents={"clientId": 1}),
        P.SequencedDocumentMessage(
        doc_id="d", client_id=1, client_seq=1, ref_seq=1, seq=2, min_seq=1,
        type=P.MessageType.OP, contents={"mt": "insert", "kind": 0,
                                         "pos": 0, "text": "αβ\x00γ"},
        metadata={"m": [1]}, address="ds/ch", timestamp=1237.75)]
    return [msgs[0], str_rec, map_rec, tree_rec, msgs[1],
            {"kind": "markMega", "doc": "d", "shards": 8}]


def _append_all(log, recs, n=4):
    for i, rec in enumerate(recs):
        log.append(i % n, rec)


def _canon(rec):
    """A package-neutral form of a record (type name + JSON fields)."""
    if dataclasses.is_dataclass(rec):
        d = {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}
        return [type(rec).__name__, json.loads(json.dumps(
            d, default=lambda o: o.tolist() if hasattr(o, "tolist")
            else int(o)))]
    return ["json", rec]


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


# ------------------------------------------------------ same bytes on disk

@pytest.mark.parametrize("backend", BACKENDS)
def test_same_records_give_byte_identical_files(tmp_path, backend):
    """Records, a fence bump and a fenced append: the JAX log and the
    port's write the same files, byte for byte."""
    assert jnative.available()
    out = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        log = _open(pkg, backend, d)
        _append_all(log, _records(pkg))
        log.bump_fence()
        log.open_for_append(log.fence_epoch).append(1, {"after": "fence"})
        heads = [log.chain_head(p) for p in range(4)]
        if backend == "native":
            log.sync()
        log.close()
        out[name] = (_files(d), heads)
    files_j, heads_j = out["jax"]
    files_t, heads_t = out["port"]
    assert sorted(files_j) == sorted(files_t)
    want = {"jsonl": {"t-fence.json"} | {f"t-p{i}.jsonl" for i in range(4)},
            "native": {"fence.json"} | {f"p{i}.log" for i in range(4)}}
    assert set(files_t) == want[backend]
    for f in files_j:
        assert files_j[f] == files_t[f], f
    assert heads_j == heads_t and all(heads_t)


@pytest.mark.parametrize("backend", BACKENDS)
def test_columnar_engines_write_byte_identical_logs(tmp_path, backend):
    """The string engines of both packages, fed the same joins and
    columnar waves under one fixed clock, spill the same bytes and cut
    summaries with the same chain heads."""
    assert jnative.available()
    R, O = 4, 8
    out = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        eng = pkg.serving.StringServingEngine(
            n_docs=R, capacity=128, batch_window=10 ** 9,
            sequencer="native", log=_open(pkg, backend, d), **pkg.kw)
        eng.deli.clock = lambda: 1700000000.5
        docs = [f"doc-{i}" for i in range(R)]
        for doc in docs:
            eng.connect(doc, 1)
        rows = np.array([eng.doc_row(doc) for doc in docs], np.int32)
        for b in range(3):
            planes, _ = typing_storm(R, O, seed=b)
            cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                           dtype=np.int32), (R, O))
            res = eng.ingest_planes(rows, np.ones((R, O), np.int32), cs, cs,
                                    planes["kind"], planes["a0"],
                                    planes["a1"], "abcd")
            assert res["nacked"] == 0
        heads = eng.summarize()["chain_heads"]
        if backend == "native":
            eng.log.sync()
        eng.log.close()
        out[name] = (_files(d), heads)
    assert out["jax"] == out["port"]
    assert all(out["port"][1])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_cross_recovery(tmp_path, backend, writer, reader):
    """Each package reopens the other's directory: the same records, the
    same chain words at every offset, and a torn tail truncated at the
    same byte as the writer's own package truncates it."""
    assert jnative.available()
    W, Rd = PKGS[writer], PKGS[reader]
    d = str(tmp_path / "w")
    log = _open(W, backend, d)
    recs = _records(W)
    _append_all(log, recs)
    chains = [[log.chain_at(p, i) for i in range(log.size(p) + 1)]
              for p in range(4)]
    if backend == "native":
        log.sync()
    log.close()
    # tear the tail of partition 1: half a record appended / chopped off
    if backend == "jsonl":
        path = os.path.join(d, "t-p1.jsonl")
        with open(path, "ab") as f:
            f.write(open(path, "rb").read().splitlines(True)[-1][:13])
    else:
        path = os.path.join(d, "p1.log")
        with open(path, "ab") as f:
            f.write(b"\x40\x00\x00\x00\x01\x02\x03")
    torn_size = os.path.getsize(path)
    shutil.copytree(d, str(tmp_path / "own"))
    own = _open(W, backend, str(tmp_path / "own"))
    other = _open(Rd, backend, d)
    assert os.path.getsize(path) < torn_size
    assert os.path.getsize(path) == os.path.getsize(
        os.path.join(str(tmp_path / "own"), os.path.basename(path)))
    for p in range(4):
        assert other.size(p) == own.size(p) == len(chains[p]) - 1
        assert [other.chain_at(p, i) for i in range(other.size(p) + 1)] \
            == chains[p]
        got = [_canon(r) for r in other.read(p)]
        assert got == [_canon(r) for r in own.read(p)]
        assert got == [_canon(r) for r in recs[p::4]]
        for r in other.read(p):   # revived as the reader's own classes
            if dataclasses.is_dataclass(r):
                assert type(r) in (Rd.serving.ColumnarOps,
                                   Rd.serving.TreeRecordOps,
                                   Rd.protocol.SequencedDocumentMessage)
    own.close()
    other.close()


def test_codecs_encode_the_same_bytes():
    for rj, rt in zip(_records(JAX), _records(PORT)):
        if isinstance(rt, tprotocol.SequencedDocumentMessage):
            assert jnative.encode_message(rj) == tnative.encode_message(rt)
            assert tnative.decode_message(tnative.encode_message(rt)) == rt
        elif isinstance(rt, tserving.ColumnarOps):
            assert jnative.encode_columnar(rj) == tnative.encode_columnar(rt)
        elif isinstance(rt, tserving.TreeRecordOps):
            assert jnative.encode_tree_records(rj) == \
                tnative.encode_tree_records(rt)
    a, b = b'{"x": 1}', b'{"x": 2}'
    assert toplog.chain_step(b, toplog.chain_step(a, 0)) == \
        joplog.chain_step(b, joplog.chain_step(a, 0))
    assert toplog.chain_step(b, toplog.chain_step(a, 0)) != \
        toplog.chain_step(a, toplog.chain_step(b, 0))


# ------------------------------------------------------------ the chain

def _fill(pkg, log, n_ops=8, doc="d"):
    """A string engine on ``log`` with ``n_ops`` sequenced inserts."""
    eng = pkg.serving.StringServingEngine(n_docs=4, capacity=128, log=log,
                                          **pkg.kw)
    eng.connect(doc, 1)
    for i in range(n_ops):
        _, nack = eng.submit(doc, 1, i + 1, 0, {"mt": "insert", "kind": 0,
                                                "pos": 0, "text": f"w{i}"})
        assert nack is None
    eng.flush()
    return eng


def test_chain_verifies_on_clean_replay(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(2, str(tmp_path), "t")
    _fill(pkg, log, n_ops=10)
    heads = [log.chain_head(p) for p in range(2)]
    sizes = [log.size(p) for p in range(2)]
    log.close()
    rec = pkg.oplog.PartitionedLog.recover(2, str(tmp_path), "t")
    assert [rec.size(p) for p in range(2)] == sizes
    assert [rec.chain_head(p) for p in range(2)] == heads
    assert any(h not in (None, 0) for h in heads)
    rec.close()


def test_memory_log_keeps_no_chain_and_no_files(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(2)
    before = _counter(pkg, "oplog_appends")
    _fill(pkg, log, n_ops=3)
    assert log.chain_head(0) is None and log.chain_at(0, 0) is None
    assert log.fence_epoch == 0 and log.spill_dir is None
    assert _counter(pkg, "oplog_appends") - before == 4
    stats = log.mem_stats()
    assert stats["records"] == 4 and stats["total_bytes"] > 0
    assert not os.listdir(tmp_path)


def test_memory_log_charges_the_same_bytes_in_both():
    """The memory-only log's byte charge (``record_nbytes``) is the
    reference's, for per-op messages and a columnar batch."""
    stats = []
    for pkg in (JAX, PORT):
        log = pkg.oplog.PartitionedLog(2)
        _fill(pkg, log, n_ops=5)
        a = np.arange(6, dtype=np.int64)
        log.append(1, pkg.serving.ColumnarOps(["d"], *([a] * 9), text="x",
                                              timestamp=1.0))
        stats.append(log.mem_stats())
    assert stats[0] == stats[1] and stats[0]["records"] == 7


def _corrupt_second_record(path):
    clean = open(path, "rb").read()
    lines = clean.splitlines(keepends=True)
    assert len(lines) >= 5
    off = len(lines[0]) + len(lines[1]) // 2
    rotted = bytearray(clean)
    rotted[off] ^= 0x10
    open(path, "wb").write(bytes(rotted))


def test_single_bit_flip_detected(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(1, str(tmp_path), "t")
    _fill(pkg, log)
    log.close()
    _corrupt_second_record(str(tmp_path / "t-p0.jsonl"))
    before = _counter(pkg, "oplog_chain_verify_failures_total")
    with pytest.raises(pkg.oplog.OplogCorruptionError, match="mid-file") \
            as ei:
        pkg.oplog.PartitionedLog.recover(1, str(tmp_path), "t")
    assert ei.value.index == 1 and ei.value.path.endswith("t-p0.jsonl")
    assert _counter(pkg, "oplog_chain_verify_failures_total") > before


def test_bit_flip_same_evidence_in_both(tmp_path):
    """One flipped bit (``corrupt_bitflip``, one seed) in two copies of a
    spill: both packages refuse it with the same index, offset, reason."""
    log = toplog.PartitionedLog(1, str(tmp_path / "a"), "t")
    _fill(PORT, log, n_ops=8)
    log.close()
    shutil.copytree(str(tmp_path / "a"), str(tmp_path / "b"))
    ev = [f.corrupt_bitflip(str(tmp_path / d / "t-p0.jsonl"),
                            random.Random(3))
          for f, d in ((tfault, "a"), (jfault, "b"))]
    assert ev[0]["offset"] == ev[1]["offset"]
    errs = []
    for pkg, d in ((PORT, "a"), (JAX, "b")):
        with pytest.raises(pkg.oplog.OplogCorruptionError) as ei:
            pkg.oplog.PartitionedLog.recover(1, str(tmp_path / d), "t")
        errs.append((ei.value.index, ei.value.offset, ei.value.reason))
    assert errs[0] == errs[1]


def test_record_splice_detected(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(1, str(tmp_path), "t")
    _fill(pkg, log)
    log.close()
    path = str(tmp_path / "t-p0.jsonl")
    ev = pkg.fault.corrupt_splice(path, random.Random(5))
    assert "skipped" not in ev
    scan = pkg.oplog.scan_chained_spill(path)
    assert scan["problems"][0]["reason"] == "chain mismatch"
    with pytest.raises(pkg.oplog.OplogCorruptionError, match="mid-file") \
            as ei:
        pkg.oplog.PartitionedLog.recover(1, str(tmp_path), "t")
    assert ei.value.index == ev["line"] and ei.value.reason == \
        "chain mismatch"


def test_torn_tail_still_recovers(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(1, str(tmp_path), "t")
    _fill(pkg, log, n_ops=6)
    n = log.size(0)
    log.close()
    path = tmp_path / "t-p0.jsonl"
    clean = path.read_bytes()
    path.write_bytes(clean + clean.splitlines(keepends=True)[-1][:9])
    before = _counter(pkg, "oplog_torn_tails_recovered")
    rec = pkg.oplog.PartitionedLog.recover(1, str(tmp_path), "t")
    assert rec.size(0) == n
    assert path.read_bytes() == clean
    assert _counter(pkg, "oplog_torn_tails_recovered") == before + 1
    rec.close()


def test_boundary_truncation_caught_by_summary_anchor(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(1, str(tmp_path), "t")
    summary = _fill(pkg, log).summarize()
    assert summary["chain_heads"][0] not in (None, 0)
    log.close()
    path = tmp_path / "t-p0.jsonl"
    lines = path.read_bytes().splitlines(keepends=True)
    path.write_bytes(b"".join(lines[:-2]))
    rec = pkg.oplog.PartitionedLog.recover(1, str(tmp_path), "t")
    before = _counter(pkg, "oplog_chain_verify_failures_total")
    with pytest.raises(pkg.oplog.OplogCorruptionError,
                       match="truncated behind the summary") as ei:
        pkg.serving.StringServingEngine.load(summary, rec, **pkg.kw)
    assert ei.value.index == len(lines)
    assert ei.value.reason == "log shorter than summary anchor"
    assert _counter(pkg, "oplog_chain_verify_failures_total") > before
    rec.close()


def test_mid_record_truncation_then_regrowth_detected(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(1, str(tmp_path), "t")
    _fill(pkg, log)
    log.close()
    path = tmp_path / "t-p0.jsonl"
    clean = path.read_bytes()
    lines = clean.splitlines(keepends=True)
    cut = sum(len(ln) for ln in lines[:-2]) + len(lines[-2]) // 2
    path.write_bytes(clean[:cut] + lines[-1])
    with pytest.raises(pkg.oplog.OplogCorruptionError, match="mid-file") \
            as ei:
        pkg.oplog.PartitionedLog.recover(1, str(tmp_path), "t")
    assert ei.value.index == len(lines) - 2


# ------------------------------------------------------------ the fence

def test_unfenced_appends_still_pass(tmp_path, pkg):
    log = pkg.oplog.PartitionedLog(1, str(tmp_path), "t")
    log.append(0, {"a": 1})
    log.bump_fence()
    log.append(0, {"a": 2})
    w = log.open_for_append(log.fence_epoch)
    w.append(0, {"a": 3})
    stale = log.open_for_append(log.fence_epoch)
    log.bump_fence()
    before = _counter(pkg, "fenced_appends_rejected_total")
    with pytest.raises(pkg.oplog.FencedWriterError) as ei:
        stale.append(0, {"a": 4})
    assert (ei.value.epoch, ei.value.fence) == (1, 2)
    assert log.size(0) == 3
    assert _counter(pkg, "fenced_appends_rejected_total") == before + 1
    with pytest.raises(pkg.oplog.FencedWriterError):
        log.open_for_append(1)
    log.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_fence_file_bumped_by_the_other_package(tmp_path, backend):
    """A fence bump written by one package's log on a directory fences
    the other package's writer on the same directory (the fence file is
    shared format)."""
    assert jnative.available()
    for a, b in (("jax", "port"), ("port", "jax")):
        d = str(tmp_path / a)
        la = _open(PKGS[a], backend, d, n=1)
        wa = la.open_for_append(la.fence_epoch)
        wa.append(0, {"i": 0})
        lb = _open(PKGS[b], backend, d, n=1)
        assert lb.fence_epoch == 0
        assert lb.bump_fence() == 1
        with pytest.raises(PKGS[a].oplog.FencedWriterError):
            wa.append(0, {"i": 1})
        lb.close()
        la.close()


def test_native_chain_detects_frame_splice(tmp_path, pkg):
    d = str(tmp_path)
    log = pkg.native.NativePartitionedLog(d, 1)
    for m in _records(pkg)[:1] * 6:
        log.append(0, m)
    log.sync()
    log.close()
    path = os.path.join(d, "p0.log")
    data = open(path, "rb").read()
    frames, off = [], 0
    while off + 8 <= len(data):
        ln = int.from_bytes(data[off:off + 4], "little")
        frames.append(data[off:off + 8 + ln])
        off += 8 + ln
    assert len(frames) == 6
    open(path, "wb").write(b"".join(frames[:2] + frames[3:]))
    with pytest.raises(pkg.oplog.OplogCorruptionError, match="chain break") \
            as ei:
        pkg.native.NativePartitionedLog(d, 1)
    assert (ei.value.index, ei.value.reason) == (2, "chain mismatch")


def test_native_fence_rejects_stale_writer(tmp_path, pkg):
    d = str(tmp_path)
    log = pkg.native.NativePartitionedLog(d, 1)
    msgs = [dict(i=i) for i in range(4)]
    w = log.open_for_append(log.fence_epoch)
    w.append(0, msgs[0])
    log.bump_fence()
    with pytest.raises(pkg.oplog.FencedWriterError):
        w.append(0, msgs[1])
    log.append(0, msgs[2], epoch=log.fence_epoch)
    log.append(0, msgs[3])
    log.sync()
    assert log.size(0) == 3
    log.close()
    log2 = pkg.native.NativePartitionedLog(d, 1)
    assert log2.fence_epoch == 1 and log2.size(0) == 3
    log2.close()


# ---------------------------------------------------- fault points

def test_fault_plans_are_per_package(tmp_path):
    """Arming the port's spill site crashes the port's append mid-line
    and leaves the JAX log alone; the reverse holds too. The torn line
    the crash leaves recovers by truncation in both packages."""
    for armed, other in ((PORT, JAX), (JAX, PORT)):
        d = tmp_path / armed.name
        la = armed.oplog.PartitionedLog(1, str(d / "a"), "t")
        lo = other.oplog.PartitionedLog(1, str(d / "o"), "t")
        la.append(0, {"i": 0})

        class Partial:
            def hit(self, site, **ctx):
                if site == armed.fault.SITE_OPLOG_MID_SPILL:
                    ctx["fh"].write(ctx["line"][:7])
                    ctx["fh"].flush()
                    raise armed.fault.CrashInjected(site)

        with armed.fault.armed(Partial()):
            assert other.fault.active_plan() is None
            lo.append(0, {"i": 1})
            with pytest.raises(armed.fault.CrashInjected):
                la.append(0, {"i": 1})
        la.close()
        lo.close()
        for pkg in (JAX, PORT):
            shutil.copytree(str(d / "a"), str(d / pkg.name))
            rec = pkg.oplog.PartitionedLog.recover(1, str(d / pkg.name), "t")
            assert list(rec.read(0)) == [{"i": 0}]
            rec.close()


def test_probabilistic_arm_is_per_package():
    plan = tfault.arm(tfault.SITE_OPLOG_MID_APPEND, p=1.0,
                      rng=random.Random(1))
    try:
        assert jfault.active_plan() is None
        log = toplog.PartitionedLog(1)
        with pytest.raises(tfault.CrashInjected):
            log.append(0, {"x": 1})
        joplog.PartitionedLog(1).append(0, {"x": 1})
        assert plan.fires == {tfault.SITE_OPLOG_MID_APPEND: 1}
    finally:
        tfault.disarm(tfault.SITE_OPLOG_MID_APPEND)
        tfault.uninstall()
    assert tfault.SITE_CHECKPOINT_MID_WRITE in tfault.registered_sites()


def test_atomic_write_survives_a_crash_mid_write(tmp_path):
    from fluidframework_tpu_torch.utils.atomicfile import (
        atomic_write_json, read_json,
    )
    path = str(tmp_path / "f.json")
    atomic_write_json(path, {"epoch": 1})
    tfault.arm(tfault.SITE_CHECKPOINT_MID_WRITE, p=1.0)
    try:
        with pytest.raises(tfault.CrashInjected):
            atomic_write_json(path, {"epoch": 2})
    finally:
        tfault.uninstall()
    assert read_json(path) == {"epoch": 1}
    assert os.listdir(tmp_path) == ["f.json"]


# ------------------------------------- native codec and reopen cases

def _msg(pkg, seq, contents, doc="d"):
    P = pkg.protocol
    return P.SequencedDocumentMessage(
        doc_id=doc, client_id=1, client_seq=seq, ref_seq=seq - 1, seq=seq,
        min_seq=0, type=P.MessageType.OP, contents=contents)


def test_codec_roundtrip_property(pkg):
    rng = random.Random(3)
    P = pkg.protocol
    for i in range(50):
        msg = P.SequencedDocumentMessage(
            doc_id="doc-%d-αβ" % i, client_id=rng.randint(-1, 2 ** 31),
            client_seq=rng.randint(0, 2 ** 40), ref_seq=rng.randint(0, 9),
            seq=rng.randint(0, 2 ** 50), min_seq=rng.randint(0, 5),
            type=rng.choice(list(P.MessageType)),
            contents=rng.choice([None, {"mt": "insert", "text": "αβ\x00γ"},
                                 [1, [2, {"k": None}]], "s"]),
            metadata=rng.choice([None, {"x": 1}]),
            address=rng.choice([None, "ds/ch"]))
        assert pkg.native.decode_message(pkg.native.encode_message(msg)) \
            == msg


def test_append_read_survives_reopen(tmp_path, pkg):
    d = str(tmp_path)
    log = pkg.native.NativePartitionedLog(d, 4)
    msgs = [_msg(pkg, i, {"op": "set", "key": f"k{i}", "value": i})
            for i in range(1, 21)]
    for i, m in enumerate(msgs):
        log.append(i % 4, m)
    log.sync()
    log.close()
    log2 = pkg.native.NativePartitionedLog(d, 4)
    back = [m for p in range(4) for m in log2.read(p)]
    assert sorted(m.seq for m in back) == [m.seq for m in msgs]
    assert all(isinstance(m, pkg.protocol.SequencedDocumentMessage)
               for m in back)
    assert log2.append(0, _msg(pkg, 99, None)) == log2.size(0) - 1
    log2.close()


def test_native_torn_tail_truncated_on_reopen(tmp_path, pkg):
    d = str(tmp_path)
    log = pkg.native.NativePartitionedLog(d, 1)
    for i in range(1, 6):
        log.append(0, _msg(pkg, i, {"v": i}))
    log.sync()
    log.close()
    path = os.path.join(d, "p0.log")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    log2 = pkg.native.NativePartitionedLog(d, 1)
    assert [m.seq for m in log2.read(0)] == [1, 2, 3, 4]
    log2.append(0, _msg(pkg, 6, {"v": 6}))
    assert [m.seq for m in log2.read(0)] == [1, 2, 3, 4, 6]
    log2.close()


def test_corrupt_middle_record_cuts_log_at_corruption(tmp_path, pkg):
    d = str(tmp_path)
    log = pkg.native.NativePartitionedLog(d, 1)
    for i in range(1, 4):
        log.append(0, _msg(pkg, i, {"v": "x" * 40}))
    log.close()
    rec1 = 8 + 1 + 5 + len(pkg.native.encode_message(
        _msg(pkg, 1, {"v": "x" * 40})))
    with open(os.path.join(d, "p0.log"), "r+b") as f:
        f.seek(rec1 + 20)
        f.write(b"\xff\xff")
    log2 = pkg.native.NativePartitionedLog(d, 1)
    assert [m.seq for m in log2.read(0)] == [1]
    log2.close()


def test_native_bit_flip_mid_segment_cuts_later_records(tmp_path, pkg):
    """ROADMAP C9, the reference's behaviour pinned in both packages: one
    flipped bit in a middle frame of a synced segment fails that frame's
    CRC, and the reopen cuts the partition there — the frame and every
    synced record after it are gone from the file, with no error and no
    chain-failure count."""
    d = str(tmp_path)
    log = pkg.native.NativePartitionedLog(d, 1)
    for i in range(1, 6):
        log.append(0, _msg(pkg, i, {"v": "x" * 40}))
    log.sync()
    log.close()
    rec1 = 8 + 1 + 4 + 1 + len(pkg.native.encode_message(
        _msg(pkg, 1, {"v": "x" * 40})))
    path = os.path.join(d, "p0.log")
    with open(path, "r+b") as f:
        f.seek(rec1 + 8 + 12)          # inside record 2's payload
        byte = f.read(1)[0]
        f.seek(rec1 + 8 + 12)
        f.write(bytes([byte ^ 0x10]))
    before = _counter(pkg, "oplog_chain_verify_failures_total")
    log2 = pkg.native.NativePartitionedLog(d, 1)
    assert [m.seq for m in log2.read(0)] == [1]
    assert os.path.getsize(path) == rec1
    assert _counter(pkg, "oplog_chain_verify_failures_total") == before
    assert log2.append(0, _msg(pkg, 6, {"v": 6})) == 1
    log2.close()


def test_json_records_roundtrip(tmp_path, pkg):
    log = pkg.native.NativePartitionedLog(str(tmp_path), 2)
    log.append(1, {"plain": "json", "n": [1, 2]})
    log.close()
    log2 = pkg.native.NativePartitionedLog(str(tmp_path), 2)
    assert list(log2.read(1)) == [{"plain": "json", "n": [1, 2]}]
    log2.close()


def test_columnar_codec_roundtrip(pkg):
    for rec in _records(pkg):
        if isinstance(rec, pkg.serving.ColumnarOps):
            back = pkg.native.decode_columnar(pkg.native.encode_columnar(rec))
            assert _canon(back) == _canon(rec)
            assert back.expand() == rec.expand()
        elif isinstance(rec, pkg.serving.TreeRecordOps):
            back = pkg.native.decode_tree_records(
                pkg.native.encode_tree_records(rec))
            assert _canon(back) == _canon(rec)


def test_columnar_record_survives_reopen(tmp_path, pkg):
    n = 600
    rec = pkg.serving.ColumnarOps(
        doc_ids=["d"], doc=np.zeros(n, np.int32), client=np.ones(n, np.int32),
        client_seq=np.arange(1, n + 1), ref_seq=np.zeros(n, np.int64),
        seq=np.arange(1, n + 1), min_seq=np.zeros(n, np.int64),
        kind=np.ones(n, np.int32), a0=np.zeros(n, np.int32),
        a1=np.full(n, 4, np.int32), text="abcd", timestamp=1.0)
    log = pkg.native.NativePartitionedLog(str(tmp_path), 2)
    log.append(0, rec)
    log.sync()
    log.close()
    log2 = pkg.native.NativePartitionedLog(str(tmp_path), 2)
    back = list(log2.read(0))[0]
    assert isinstance(back, pkg.serving.ColumnarOps)
    assert (back.client_seq == rec.client_seq).all()
    assert len(back.expand()) == n
    log2.close()


def test_unloggable_record_raises_not_corrupts(tmp_path, pkg):
    log = pkg.native.NativePartitionedLog(str(tmp_path), 1)
    with pytest.raises(TypeError, match="losslessly"):
        log.append(0, object())
    assert log.size(0) == 0 and log.chain_head(0) == 0
    log.close()


# ------------------------------------------------ no quiet fallback

def test_native_log_build_failure_raises(tmp_path, monkeypatch):
    """Without a compiler the port's native log refuses to exist: the
    build raises, and so does ``NativePartitionedLog`` (it never serves
    from another log)."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="liboplog.so"):
        tbuild.ensure_built("liboplog.so")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="liboplog.so"):
        tnative.NativePartitionedLog(str(tmp_path / "log"), 2)
    assert not (tmp_path / "log").exists()
    assert not hasattr(tnative, "available")
