"""The port's ``MatrixServingEngine(device="cpu")`` against the JAX engine
fed the same submits and ``ingest_cells`` batches, under LWW and FWW:
dims, ``get_cell``, ``to_lists``, the axis planes and the cell table;
nacks (malformed, cell capacity, axis capacity, the 33rd client); the
axis admission bound after ``load``; full and incremental summaries, each
loaded by its own package; a JAX summary and log loaded into the port.
Held against direct engine reads only. Tolerance: exact."""

import copy
import random

import numpy as np
import pytest

from fluidframework_tpu.core.protocol import (
    SequencedDocumentMessage as JMessage,
)
from fluidframework_tpu.server.serving import (
    ColumnarOps as JColumnarOps, MatrixServingEngine as JEngine,
)
from fluidframework_tpu_torch.core.protocol import (
    MessageType, SequencedDocumentMessage,
)
from fluidframework_tpu_torch.ops import merge_tree as mt
from fluidframework_tpu_torch.server.oplog import PartitionedLog
from fluidframework_tpu_torch.server.serving import (
    ColumnarOps, MatrixServingEngine as TEngine,
)


def _pair(**kw):
    # one doc-row count and axis capacity wherever a test allows, so the
    # JAX engine compiles few shapes
    kw.setdefault("n_docs", 4)
    kw.setdefault("cell_capacity", 4096)
    kw.setdefault("axis_capacity", 64)
    return JEngine(**kw), TEngine(device="cpu", **kw)


def _outcome(res):
    msg, nack = res
    return (msg.seq if msg is not None else None,
            nack.reason.name if nack is not None else None)


def _submit(engines, doc, client, cs, ref, op):
    out = [_outcome(e.submit(doc, client, cs, ref, op)) for e in engines]
    assert out[0] == out[1], (op, out)
    return out[0]


def _same_engine(j, t, docs, probes=24):
    for d in docs:
        assert j.dims(d) == t.dims(d), d
        assert j.to_lists(d) == t.to_lists(d), d
    js, ts = j.axis_store.state, t.axis_store.state
    cnt = ts.count.numpy()
    assert np.array_equal(np.asarray(js.count), cnt)
    assert np.array_equal(np.asarray(js.overflow), ts.overflow.numpy())
    for k in mt.PLANES:   # [0, count): the engines compact
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        for r in range(len(cnt)):
            assert np.array_equal(a[r, :cnt[r]], b[r, :cnt[r]]), (k, r)
    assert j.store.read_cells() == t.store.read_cells()
    assert int(np.asarray(j.store.state.count)) == int(t.store.state.count)
    rng = np.random.default_rng(probes)
    for d in docs:
        nr, nc = t.dims(d)
        for _ in range(probes if nr and nc else 0):
            r, c = int(rng.integers(0, nr)), int(rng.integers(0, nc))
            assert j.get_cell(d, r, c) == t.get_cell(d, r, c), (d, r, c)


def _concurrent_storm(engines, doc, rng, n_ops, clients=(1, 2, 3, 4),
                      fww_at=None, cs=None, seq=0):
    """Per-op ops from several clients whose ref_seq lags the doc's seq
    by up to 16: inserts, removes and cell writes at positions drawn from
    the latest view (some invalid at the op's perspective: dropped)."""
    cs = cs if cs is not None else {c: 0 for c in clients}
    refs = {c: 0 for c in clients}
    nr = nc = 0

    def go(c, op):
        nonlocal seq
        cs[c] += 1
        refs[c] = max(refs[c], seq - int(rng.integers(0, 17)),
                      engines[1]._min_seq.get(doc, 0))
        s, nack = _submit(engines, doc, c, cs[c], refs[c], op)
        if nack is None:
            seq = s
        else:   # both engines nacked it before sequencing
            assert nack == "CAPACITY", (op, nack)
            cs[c] -= 1

    go(clients[0], {"mx": "insRow", "pos": 0, "count": 6,
                    "opKey": (clients[0], 0)})
    go(clients[0], {"mx": "insCol", "pos": 0, "count": 6,
                    "opKey": (clients[0], 1)})
    for i in range(n_ops):
        if i % 16 == 0:   # a read flushes: both engines read
            (nr, nc), other = (e.dims(doc) for e in engines[::-1])
            assert other == (nr, nc)
        c = clients[int(rng.integers(0, len(clients)))]
        if fww_at is not None and i == fww_at:
            go(c, {"mx": "policy"})
            continue
        roll = rng.random()
        if roll < 0.55 and nr and nc:
            go(c, {"mx": "setCell", "row": int(rng.integers(0, nr + 1)),
                   "col": int(rng.integers(0, nc + 1)),
                   "value": f"v{i}"})
        elif roll < 0.8:
            ax = "insRow" if roll < 0.68 else "insCol"
            go(c, {"mx": ax, "pos": int(rng.integers(
                0, (nr if ax == "insRow" else nc) + 2)),
                "count": int(rng.integers(1, 3)),
                "opKey": (c, 100 + i)})
        else:
            ax = "rmRow" if roll < 0.9 else "rmCol"
            n = nr if ax == "rmRow" else nc
            if n > 2:
                go(c, {"mx": ax, "start": int(rng.integers(0, n - 1)),
                       "count": int(rng.integers(1, 3))})
    return cs, seq


@pytest.mark.parametrize("fww_at", [None, 60])
def test_concurrent_per_op_storm_matches_jax(fww_at):
    """Four clients with stale ref_seqs, 16-op flush windows (the axis
    scan with real windows), a policy flip under FWW."""
    engines = _pair(batch_window=16)
    for e in engines:
        for c in (1, 2, 3, 4):
            e.connect("m", c)
    _concurrent_storm(engines, "m", np.random.default_rng(3), 160,
                      fww_at=fww_at)
    _same_engine(*engines, ["m"])


def test_fww_concurrent_writer_loses_like_jax():
    engines = _pair(batch_window=64)
    for e in engines:
        e.connect("m", 1)
        e.connect("m", 2)
    _submit(engines, "m", 1, 1, 0, {"mx": "insRow", "pos": 0, "count": 1,
                                     "opKey": (1, 1)})
    _submit(engines, "m", 1, 2, 0, {"mx": "insCol", "pos": 0, "count": 1,
                                     "opKey": (1, 2)})
    _submit(engines, "m", 1, 3, 0, {"mx": "policy"})
    s1, _ = _submit(engines, "m", 1, 4, 0, {"mx": "setCell", "row": 0,
                                             "col": 0, "value": "first"})
    _submit(engines, "m", 2, 1, s1 - 1, {"mx": "setCell", "row": 0,
                                         "col": 0, "value": "concurrent"})
    assert [e.get_cell("m", 0, 0) for e in engines] == ["first"] * 2
    _submit(engines, "m", 2, 2, s1 + 1, {"mx": "setCell", "row": 0,
                                         "col": 0, "value": "seen"})
    assert [e.get_cell("m", 0, 0) for e in engines] == ["seen"] * 2
    with pytest.raises(IndexError):
        engines[1].get_cell("m", 1, 0)


def _grid_pair(D=4, grid=6, fww=False):
    engines = _pair(batch_window=10 ** 9, sequencer="native")
    docs = [f"mx-{i}" for i in range(D)]
    cs = {d: 0 for d in docs}
    for d in docs:
        for e in engines:
            e.connect(d, 7)
        for mx in ("insRow", "insCol"):
            cs[d] += 1
            _submit(engines, d, 7, cs[d], 0, {"mx": mx, "pos": 0,
                                              "count": grid,
                                              "opKey": (7, cs[d])})
        if fww:
            cs[d] += 1
            _submit(engines, d, 7, cs[d], 0, {"mx": "policy"})
    for e in engines:
        e.flush()
    return engines, docs, cs


def _cell_storm(rng, docs, cs, grid, n_per_doc):
    ids, cseqs, rp, cp, vals = [], [], [], [], []
    for d in docs:
        for _ in range(n_per_doc):
            cs[d] += 1
            ids.append(d)
            cseqs.append(cs[d])
            rp.append(int(rng.integers(0, grid)))
            cp.append(int(rng.integers(0, grid)))
            vals.append(f"{d}:{cs[d]}")
    return ids, cseqs, rp, cp, vals


def _ingest(engines, batch):
    ids, cseqs, rp, cp, vals = batch
    out = [e.ingest_cells(ids, [7] * len(ids), cseqs, [0] * len(ids), rp,
                          cp, vals) for e in engines]
    assert np.array_equal(out[0]["seq"], out[1]["seq"])
    assert out[0]["nacked"] == out[1]["nacked"]
    return out[1]


@pytest.mark.parametrize("fww", [False, True])
def test_cell_ingest_matches_jax_and_the_per_op_route(fww):
    """Three pipelined batches (each harvested by the next), then the
    per-op route on a third engine: all three agree."""
    rng = np.random.default_rng(11)
    grid = 6
    engines, docs, cs = _grid_pair(fww=fww)
    per_op = TEngine(n_docs=4, cell_capacity=4096, batch_window=10 ** 9,
                     axis_capacity=64, device="cpu")
    pcs = {}
    for d in docs:
        per_op.connect(d, 7)
        pcs[d] = 0
        for mx in ("insRow", "insCol"):
            pcs[d] += 1
            per_op.submit(d, 7, pcs[d], 0, {"mx": mx, "pos": 0,
                                            "count": grid,
                                            "opKey": (7, pcs[d])})
        if fww:
            pcs[d] += 1
            per_op.submit(d, 7, pcs[d], 0, {"mx": "policy"})
    for wave in range(3):
        batch = _cell_storm(rng, docs, cs, grid, 8)
        assert _ingest(engines, batch)["nacked"] == 0
        ids, _, rp, cp, vals = batch
        for i, d in enumerate(ids):
            pcs[d] += 1
            _, nack = per_op.submit(d, 7, pcs[d], 0,
                                    {"mx": "setCell", "row": rp[i],
                                     "col": cp[i], "value": vals[i]})
            assert nack is None
    assert len(engines[1]._pending_cells) == 1   # the newest in flight
    _same_engine(*engines, docs)
    for d in docs:
        assert per_op.to_lists(d) == engines[1].to_lists(d), d


def test_cell_ingest_nack_and_out_of_range_like_jax():
    grid = 4
    engines, docs, cs = _grid_pair(D=2, grid=grid)
    d = docs[0]
    res = _ingest(engines, ([d, d, d], [cs[d] + 1, 99, cs[d] + 2],
                            [0, 1, grid + 5], [0, 1, 0],
                            ["ok", "gap", "oor"]))
    assert res["nacked"] == 1 and res["seq"][1] < 0
    assert [e.get_cell(d, 0, 0) for e in engines] == ["ok"] * 2
    assert [e.dims(d) for e in engines] == [(grid, grid)] * 2
    for e in engines:
        with pytest.raises(ValueError, match="negative"):
            e.ingest_cells([d], [7], [cs[d] + 3], [0], [-1], [0], ["x"])
        with pytest.raises(ValueError, match="unserializable"):
            e.ingest_cells([d], [7], [cs[d] + 3], [0], [0], [0], [object()])


def test_nacks_like_jax():
    """Malformed ops, the cell-table reservation and the axis-slot bound
    nack before sequencing in both engines."""
    engines = _pair(n_docs=1, cell_capacity=8, axis_capacity=8,
                    batch_window=10 ** 9)
    for e in engines:
        e.connect("m", 1)
    bad = [{"mx": "insRow", "pos": 0, "count": 0, "opKey": (1, 1)},
           {"mx": "insRow", "pos": -1, "count": 1, "opKey": (1, 1)},
           {"mx": "insRow", "pos": 0, "count": 1, "opKey": (1,)},
           {"mx": "insRow", "pos": 0, "count": True, "opKey": (1, 1)},
           {"mx": "rmCol", "start": 0, "count": 0},
           {"mx": "setCell", "row": 0, "col": 0, "value": object()},
           {"mx": "setCell", "row": "0", "col": 0, "value": 1},
           {"mx": "frobnicate"}, "setCell"]
    for op in bad:
        assert _submit(engines, "m", 1, 1, 0, op) == (None, "MALFORMED")
    cs = 0
    outcomes = []
    for k in range(6):   # 4 fit an 8-slot axis at 2 slots each
        cs += 1
        outcomes.append(_submit(engines, "m", 1, cs, 0, {
            "mx": "insRow", "pos": 0, "count": 1, "opKey": (1, cs)})[1])
        if outcomes[-1]:
            cs -= 1
    assert outcomes == [None] * 4 + ["CAPACITY"] * 2
    cs += 1
    _submit(engines, "m", 1, cs, 0, {"mx": "insCol", "pos": 0, "count": 4,
                                      "opKey": (1, cs)})
    nacks = []
    for k in range(12):   # the table reserves one identity per setCell
        cs += 1
        nack = _submit(engines, "m", 1, cs, 0, {
            "mx": "setCell", "row": k % 4, "col": k // 4, "value": k})[1]
        nacks.append(nack)
        if nack:
            cs -= 1
    assert nacks.count("CAPACITY") > 0 and nacks[0] is None
    _same_engine(*engines, ["m"], probes=4)


def test_33rd_client_is_capacity_nacked_like_jax():
    engines = _pair(batch_window=10 ** 9)
    for e in engines:
        e.connect("m", 1)
    seq, _ = _submit(engines, "m", 1, 1, 0, {"mx": "insRow", "pos": 0,
                                              "count": 4, "opKey": (1, 1)})
    for c in range(2, mt.MAX_CLIENTS + 1):
        for e in engines:
            e.connect("m", c)
        seq, nack = _submit(engines, "m", c, 1, seq, {
            "mx": "setCell", "row": 0, "col": 0, "value": c})
        assert nack is None
    for e in engines:
        e.connect("m", 999)
    before = [e.deli.doc_seq("m") for e in engines]
    assert _submit(engines, "m", 999, 1, seq, {
        "mx": "setCell", "row": 0, "col": 0, "value": "x"}) == \
        (None, "CAPACITY")
    assert [e.deli.doc_seq("m") for e in engines] == before
    for e in engines:
        e.flush()
    _same_engine(*engines, ["m"], probes=2)


def test_axis_admission_rebased_after_load():
    log = PartitionedLog(4)
    eng = TEngine(n_docs=1, cell_capacity=4096, batch_window=10 ** 9,
                  axis_capacity=16, log=log, device="cpu")
    eng.connect("m", 1)
    cs = 0
    for k in range(6):
        cs += 1
        _, nack = eng.submit("m", 1, cs, 0, {"mx": "insRow", "pos": 0,
                                             "count": 1, "opKey": (1, cs)})
        assert nack is None
    revived = TEngine.load(eng.summarize(), log, device="cpu",
                           axis_capacity=16)
    assert revived._axis_used[0] >= 6
    for k in range(5):
        cs += 1
        _, nack = revived.submit("m", 1, cs, 0, {
            "mx": "insRow", "pos": 0, "count": 1, "opKey": (1, cs)})
        assert nack is None
    cs += 1
    _, nack = revived.submit("m", 1, cs, 0, {"mx": "insRow", "pos": 0,
                                             "count": 1, "opKey": (1, cs)})
    assert nack is not None and nack.reason.name == "CAPACITY"
    assert not revived.overflowed()


def _port_record(rec):
    """A JAX log record rebuilt as the port's, from its plain fields."""
    if isinstance(rec, JColumnarOps):
        return ColumnarOps(
            list(rec.doc_ids), *(np.asarray(getattr(rec, f)).copy() for f in
                                 ("doc", "client", "client_seq", "ref_seq",
                                  "seq", "min_seq", "kind", "a0", "a1")),
            text=rec.text, timestamp=rec.timestamp, family=rec.family,
            values=copy.deepcopy(rec.values))
    assert isinstance(rec, JMessage)
    return SequencedDocumentMessage(
        doc_id=rec.doc_id, client_id=rec.client_id,
        client_seq=rec.client_seq, ref_seq=rec.ref_seq, seq=rec.seq,
        min_seq=rec.min_seq, type=MessageType(int(rec.type)),
        contents=copy.deepcopy(rec.contents), timestamp=rec.timestamp)


def _drive(engines, docs, cs, rng, grid, fww_doc=None):
    """A cell batch through ingest_cells plus per-op axis edits."""
    _ingest(engines, _cell_storm(rng, docs, cs, grid, 6))
    d = docs[0]
    cs[d] += 1
    _submit(engines, d, 7, cs[d], 0, {"mx": "insRow", "pos": 1, "count": 2,
                                      "opKey": (7, 1000 + cs[d])})
    cs[d] += 1
    _submit(engines, d, 7, cs[d], 0, {"mx": "rmCol", "start": 2,
                                      "count": 1})
    if fww_doc is not None:
        cs[fww_doc] += 1
        _submit(engines, fww_doc, 7, cs[fww_doc], 0, {"mx": "policy"})


def test_full_and_incremental_summaries_like_jax():
    """Full then incremental summaries, each loaded by its own package
    (the port's loads on the CPU); the two packages' reloads agree, and
    each reload equals its live engine."""
    rng = np.random.default_rng(5)
    grid = 5
    engines, docs, cs = _grid_pair(D=3, grid=grid)
    _drive(engines, docs, cs, rng, grid, fww_doc=docs[2])
    full = [e.summarize() for e in engines]
    _drive(engines, docs[:2], cs, rng, grid)
    inc = [e.summarize(incremental=True) for e in engines]
    assert inc[1]["kind"] == "delta" and inc[1]["cells_delta"] is not None
    assert len(inc[1]["axis_delta"]["rows"]) == 4   # the two dirty docs
    _drive(engines, docs, cs, rng, grid)   # a log tail past the summary
    for summ in (full, inc):
        lj = JEngine.load(summ[0], engines[0].log, sequencer="native")
        lt = TEngine.load(summ[1], engines[1].log, device="cpu",
                          sequencer="native")
        _same_engine(lj, lt, docs)
        for d in docs:
            assert lt.to_lists(d) == engines[1].to_lists(d), d
        assert lt._fww == engines[1]._fww


def test_jax_summary_and_log_load_into_the_port():
    rng = np.random.default_rng(7)
    grid = 5
    engines, docs, cs = _grid_pair(D=3, grid=grid, fww=True)
    j = engines[0]
    _drive([j, engines[1]], docs, cs, rng, grid)
    summary = j.summarize()
    _drive([j, engines[1]], docs, cs, rng, grid)
    inc = j.summarize(incremental=True)
    _drive([j, engines[1]], docs, cs, rng, grid)
    for summ in (summary, inc):
        log = PartitionedLog(j.log.n_partitions)
        for p in range(j.log.n_partitions):
            for rec in j.log.read(p):
                log.append(p, _port_record(rec))
        lt = TEngine.load(summ, log, device="cpu", sequencer="native")
        for d in docs:
            assert lt.to_lists(d) == j.to_lists(d), d
            assert lt.dims(d) == j.dims(d)
        # sequencing resumes where the JAX engine left off
        d = docs[1]
        msg, nack = lt.submit(d, 7, cs[d] + 1, 0, {
            "mx": "setCell", "row": 0, "col": 0, "value": "next"})
        assert nack is None and msg.seq == j.deli.doc_seq(d) + 1


def test_mesh_is_refused():
    """Anything but a 1-D docs mesh is refused (tests/test_torch_mesh.py
    drives the sharded engine)."""
    with pytest.raises(ValueError, match="docs"):
        TEngine(n_docs=2, device="cpu", mesh=object())


def test_per_op_random_storm_reads_like_jax():
    """The reference engine test's single-writer storm (setCell / insert /
    remove by one client, ref_seq = the last seq) with a FWW flip."""
    rng = random.Random(8)
    engines = _pair(batch_window=64)
    for e in engines:
        e.connect("m", 7)
    cs, last = 0, 0

    def submit(op):
        nonlocal cs, last
        cs += 1
        if op["mx"] in ("insRow", "insCol"):
            op.setdefault("opKey", (7, cs))
        last, nack = _submit(engines, "m", 7, cs, last, op)
        assert nack is None

    submit({"mx": "insRow", "pos": 0, "count": 4})
    submit({"mx": "insCol", "pos": 0, "count": 4})
    for i in range(100):
        if i == 40:
            submit({"mx": "policy"})
        (nr, nc), other = (e.dims("m") for e in engines[::-1])
        assert other == (nr, nc)
        roll = rng.random()
        if roll < 0.6 and nr and nc:
            submit({"mx": "setCell", "row": rng.randrange(nr),
                    "col": rng.randrange(nc), "value": f"v{i}"})
        elif roll < 0.75:
            submit({"mx": "insRow" if roll < 0.68 else "insCol",
                    "pos": rng.randint(0, nr if roll < 0.68 else nc),
                    "count": rng.randint(1, 2)})
        elif nr > 1 and roll < 0.88:
            submit({"mx": "rmRow", "start": rng.randrange(nr - 1),
                    "count": 1})
        elif nc > 1:
            submit({"mx": "rmCol", "start": rng.randrange(nc - 1),
                    "count": 1})
    _same_engine(*engines, ["m"])
