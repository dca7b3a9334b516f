"""The port's doc-sharded and replicated paths (``parallel/``, ``mesh=`` on
the four stores and engines) against the JAX package on the conftest's 8
virtual CPU devices, at small sizes: the replicated step (planes, digests,
``agree``, ``inject_divergence``), the sharded string, map, tree and matrix
engines (planes, digests, reads), summaries crossing the packages with and
without a mesh (the matrix ``"sharded_docs"`` form included), and the
collective-free check. The port runs 8 CPU shards (``device="cpu"``).
Tolerance: exact."""

import random

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops.merge_tree_kernel import (
    StringState as JState, apply_string_batch as japply,
    string_state_digest as jdigest,
)
from fluidframework_tpu.parallel import (
    make_mesh as jmake_mesh, make_replicated_step as jmake_step,
    shard_ops as jshard_ops, shard_state as jshard_state,
)
from fluidframework_tpu.parallel.sharded import make_doc_mesh as jdoc_mesh
from fluidframework_tpu.server.serving import (
    MapServingEngine as JMap, MatrixServingEngine as JMatrix,
    StringServingEngine as JString, TreeServingEngine as JTree,
)
from fluidframework_tpu.testing.synthetic import typing_storm
from fluidframework_tpu_torch.ops.merge_tree import StringState, FIELDS
from fluidframework_tpu_torch.ops.schema import OpKind
from fluidframework_tpu_torch.ops.string_store import TensorStringStore
from fluidframework_tpu_torch.parallel import (
    make_doc_mesh, make_mesh, make_replicated_step, shard_ops, shard_state,
)
from fluidframework_tpu_torch.parallel.sharded import (
    CrossDeviceRecorder, assert_collective_free, doc_shard_count,
    shard_of_rows, shard_scope,
)
from fluidframework_tpu_torch.server.ingest_pipeline import (
    PipelinedIngestExecutor,
)
from fluidframework_tpu_torch.server.serving import (
    MapServingEngine as TMap, MatrixServingEngine as TMatrix,
    StringServingEngine as TString, TreeServingEngine as TTree,
)
from tests.test_tree_kernel import tree_session

ORDER = ("kind", "a0", "a1", "a2", "seq", "client", "ref_seq")
TEXT = "abcd"  # typing_storm INS_LEN
N = 8          # shards (the conftest's virtual devices)


def _tmesh():
    return make_doc_mesh(N, device="cpu")


# ------------------------------------------------------------- replicated

@pytest.mark.parametrize("case", ["one_round", "rounds", "divergence"])
def test_replicated_step_like_jax(case):
    """(2 replicas × 4 doc shards): the step's planes, digests and
    ``agree`` equal the JAX step's and a single-device apply's;
    ``inject_divergence`` makes both disagree."""
    jmesh, tmesh = jmake_mesh(8), make_mesh(8, device="cpu")
    assert tmesh.shape == {"replica": 2, "docs": 4}
    n_docs, n_ops, cap = (16, 8, 64) if case != "rounds" else (8, 8, 128)
    chaos = case == "divergence"
    jstep = jmake_step(jmesh, inject_divergence=chaos)
    tstep = make_replicated_step(tmesh, inject_divergence=chaos)
    js = jshard_state(JState.create(n_docs, cap), jmesh)
    ts = shard_state(StringState.create(n_docs, cap, device="cpu"), tmesh)
    ref = JState.create(n_docs, cap)
    seq = 1
    for r in range(3 if case == "rounds" else 1):
        planes, seq = typing_storm(n_docs, n_ops, seed=r, start_seq=seq)
        ops = tuple(np.asarray(planes[k], np.int32) for k in ORDER)
        js, jdig, jagree = jstep(js, *jshard_ops(jmesh, *ops))
        ts, tdig, tagree = tstep(ts, *shard_ops(tmesh, *ops))
        ref = japply(ref, *ops)
        assert int(tagree) == int(jagree) == (0 if chaos else 1)
        if not chaos:
            assert np.array_equal(tdig.numpy(), np.asarray(jdig))
            assert np.array_equal(tdig.numpy(), np.asarray(jdigest(ref)))
    for k in FIELDS:
        for rep in range(2):
            assert np.array_equal(getattr(ts.full(rep), k).numpy(),
                                  np.asarray(getattr(js, k))), (k, rep)


# ------------------------------------------------- the collective-free check

def test_sharded_merge_is_collective_free_and_the_check_bites():
    """The sharded merge copies nothing between devices; the recorder
    catches a cross-device copy and an op off its shard's device."""
    assert assert_collective_free(_tmesh(), 64, 128, 16) == "collective-free"
    with CrossDeviceRecorder() as rec:
        torch.zeros(4).to("meta")
    assert rec.copies and not rec.misplaced
    with CrossDeviceRecorder() as rec:
        with shard_scope(0, torch.device("meta")):
            torch.ones(2) + 1
    assert rec.misplaced


def test_mesh_shapes_are_checked():
    mesh = _tmesh()
    assert doc_shard_count(mesh) == N and doc_shard_count(None) == 0
    assert shard_of_rows([0, 7, 8, 63], 64, N).tolist() == [0, 0, 1, 7]
    with pytest.raises(RuntimeError, match="no CUDA"):   # no fall-back
        make_doc_mesh(devices=["cuda:0"])
    with pytest.raises(ValueError, match="divisible"):
        TensorStringStore(30, 128, mesh=mesh)
    with pytest.raises(ValueError, match="B9"):
        TString(n_docs=16, capacity=64, mega_docs=2, mesh=mesh)
    with pytest.raises(ValueError, match="docs"):
        TensorStringStore(16, 64, mesh=make_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="not sharded"):
        TString(n_docs=16, capacity=64, mesh=mesh,
                store=TensorStringStore(16, 64, device="cpu"))


# ------------------------------------------------------------------ string

def _string_engines(R=64, cap=256):
    """A JAX engine on the JAX docs mesh, the port's on its CPU mesh and
    the port's unsharded; every doc connected and given its row."""
    kw = dict(n_docs=R, capacity=cap, batch_window=10 ** 9,
              sequencer="native", compact_every=2)
    engines = (JString(mesh=jdoc_mesh(N), **kw),
               TString(mesh=_tmesh(), device="cpu", **kw),
               TString(device="cpu", **kw))
    docs = [f"doc-{i}" for i in range(R)]
    for e in engines:
        for d in docs:
            e.connect(d, 1)
            e.doc_row(d)
    rows = np.array([engines[1].doc_row(d) for d in docs], np.int32)
    return engines, docs, rows


def _same_string(engines, docs):
    j = engines[0]
    snap = j.store.snapshot()
    for t in engines[1:]:
        assert np.array_equal(t.store.digests(), j.store.digests())
        tsnap = t.store.snapshot()
        for k in snap["planes"]:
            assert np.array_equal(tsnap["planes"][k],
                                  np.asarray(snap["planes"][k])), k
        assert np.array_equal(tsnap["count"], np.asarray(snap["count"]))
        for d in docs[::7]:
            assert t.read_text(d) == j.read_text(d), d


def _typing_waves(engines, rows, n_waves, O=16, first=0):
    R = len(rows)
    client = np.ones((R, O), np.int32)
    ref = np.zeros((R, O), np.int32)
    for b in range(first, first + n_waves):
        planes, _ = typing_storm(R, O, seed=b)
        cseq = np.broadcast_to(
            np.arange(b * O + 1, (b + 1) * O + 1, dtype=np.int32), (R, O))
        for e in engines:
            assert e.ingest_planes(rows, client, cseq, ref, planes["kind"],
                                   planes["a0"], planes["a1"],
                                   TEXT)["nacked"] == 0


@pytest.mark.parametrize("route", ["serial", "pipelined"])
def test_sharded_string_engine_like_jax(route):
    """Typing waves through ``ingest_planes`` (the port's sharded engine
    also through the pipelined executor) on the three engines."""
    engines, docs, rows = _string_engines()
    if route == "serial":
        _typing_waves(engines, rows, 3)
    else:
        _typing_waves(engines[::2], rows, 3)
        R, O = len(rows), 16
        ex = PipelinedIngestExecutor(engines[1], depth=2)
        tickets = []
        for b in range(3):
            planes, _ = typing_storm(R, O, seed=b)
            cseq = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                             dtype=np.int32), (R, O))
            tickets.append(ex.submit(
                rows, np.ones((R, O), np.int32), cseq,
                np.zeros((R, O), np.int32), planes["kind"], planes["a0"],
                planes["a1"], TEXT))
        ex.drain()
        assert all(t.result()["nacked"] == 0 for t in tickets)
        ex.close()
    _same_string(engines, docs)
    assert engines[1].store.sharded.n_shards == N


def test_sharded_string_rich_and_summaries_cross_packages():
    """Props through the sharded columnar path; a summary of either
    package's sharded engine loads into the other with and without a
    mesh, digest-exact, and the loaded port engine serves sharded."""
    engines, docs, rows = _string_engines()
    R, O = len(rows), 8
    client = np.ones((R, O), np.int32)
    ref = np.zeros((R, O), np.int32)
    kind = np.zeros((R, O), np.int32)
    kind[:, O // 2:] = int(OpKind.STR_ANNOTATE)
    a0 = np.zeros((R, O), np.int32)
    a1 = np.zeros((R, O), np.int32)
    a1[:, O // 2:] = 2
    tidx = np.zeros((R, O), np.int32)
    tidx[:, :O // 2] = np.arange(O // 2, dtype=np.int32)
    tidx[:, O // 2:] = np.arange(O // 2, dtype=np.int32) % 2
    cseq = np.broadcast_to(np.arange(1, O + 1, dtype=np.int32), (R, O))
    for e in engines:
        assert e.ingest_planes(rows, client, cseq, ref, kind, a0, a1,
                               texts=[f"t{k}" for k in range(O)], tidx=tidx,
                               props=[{"b": 1}, {"c": "x"}])["nacked"] == 0
    _same_string(engines, docs)
    j, t, _ = engines
    assert t.get_properties(docs[0], 0) == j.get_properties(docs[0], 0)
    js, ts = j.summarize(), t.summarize()
    want = j.store.digests()
    for mesh in (None, _tmesh()):
        loaded = TString.load(js, t.log, device="cpu", mesh=mesh,
                              sequencer="native")
        assert np.array_equal(loaded.store.digests(), want)
        assert (loaded.store.sharded is None) == (mesh is None)
    for mesh in (None, jdoc_mesh(N)):
        loaded = JString.load(ts, j.log, mesh=mesh, sequencer="native")
        assert np.array_equal(loaded.store.digests(), want)
    revived = TString.load(ts, t.log, device="cpu", mesh=_tmesh(),
                           sequencer="native")
    msg, nack = revived.submit(docs[0], 1, O + 1, 0, {
        "mt": "insert", "kind": 0, "pos": 0, "text": "Z"})
    assert nack is None
    assert revived.read_text(docs[0]) == "Z" + t.read_text(docs[0])


def test_sharded_incremental_summary_chain_like_jax():
    """Dirty-row gathers and delta scatters over the mesh: a chain of two
    deltas of each package loads into the port sharded, text-exact."""
    engines, docs, rows = _string_engines()
    R, O = len(rows), 8
    client = np.ones((R, O), np.int32)
    z = np.zeros((R, O), np.int32)
    cseq = np.broadcast_to(np.arange(1, O + 1, dtype=np.int32), (R, O))
    for e in engines:
        assert e.ingest_planes(rows, client, cseq, z, z, z, z,
                               TEXT)["nacked"] == 0
        e.summarize()
    chains = {}
    for sub in (rows[:3], rows[10:12]):
        n = len(sub)
        cs2 = np.broadcast_to(np.arange(O + 1, 2 * O + 1, dtype=np.int32),
                              (n, O))
        for e in engines:
            assert e.ingest_planes(sub, client[:n], cs2, z[:n], z[:n],
                                   z[:n], z[:n], TEXT)["nacked"] == 0
            chains[id(e)] = e.summarize(incremental=True)
    j, t, _ = engines
    assert len(chains[id(t)]["store_delta"]["rows"]) == 2
    want = {d: j.read_text(d) for d in docs}
    for summary in (chains[id(j)], chains[id(t)]):
        loaded = TString.load(summary, t.log, device="cpu", mesh=_tmesh(),
                              sequencer="native")
        assert {d: loaded.read_text(d) for d in docs} == want
        assert np.array_equal(loaded.store.digests(), j.store.digests())


# --------------------------------------------------------------------- map

def test_sharded_map_engine_and_summaries_like_jax():
    R, O = 64, 12
    kw = dict(n_docs=R, batch_window=10 ** 9, sequencer="native")
    j = JMap(mesh=jdoc_mesh(N), **kw)
    t = TMap(mesh=_tmesh(), device="cpu", **kw)
    u = TMap(device="cpu", **kw)
    docs = [f"sm-{i}" for i in range(R)]
    for e in (j, t, u):
        for d in docs:
            e.connect(d, 1)
            e.doc_row(d)
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    rng = np.random.default_rng(3)
    keys = [f"k{i}" for i in range(6)]
    values = [f"v{i}" for i in range(5)]
    client = np.ones((R, O), np.int32)
    ref = np.zeros((R, O), np.int32)
    for bi in range(3):
        kind = rng.choice([int(OpKind.MAP_SET), int(OpKind.MAP_DELETE),
                           int(OpKind.MAP_CLEAR)],
                          p=[0.8, 0.15, 0.05], size=(R, O)).astype(np.int32)
        kidx = rng.integers(0, len(keys), size=(R, O)).astype(np.int32)
        vidx = rng.integers(0, len(values), size=(R, O)).astype(np.int32)
        cseq = np.broadcast_to(
            np.arange(bi * O + 1, (bi + 1) * O + 1, dtype=np.int32), (R, O))
        for e in (j, t, u):
            assert e.ingest_planes(rows, client, cseq, ref, kind, kidx,
                                   keys, values, vidx)["nacked"] == 0
    for i, d in enumerate(docs[::9]):   # the per-op route, sharded
        for e in (j, t, u):
            _, nack = e.submit(d, 1, 3 * O + 1, 0,
                               {"op": "set", "key": "x", "value": i})
            assert nack is None
    for e in (j, t, u):
        e.flush()
    for e in (t, u):
        assert np.array_equal(e.store.digests(), np.asarray(
            j.store.digests()))
        for k in ("present", "value", "last_seq"):
            assert np.array_equal(getattr(e.store.state, k).numpy(),
                                  np.asarray(getattr(j.store.state, k))), k
    want = {d: j.read_doc(d) for d in docs}
    js, ts = j.summarize(), t.summarize()
    for mesh in (None, _tmesh()):
        for s in (js, ts):
            loaded = TMap.load(s, t.log, device="cpu", mesh=mesh,
                               sequencer="native")
            assert {d: loaded.read_doc(d) for d in docs} == want
    for mesh in (None, jdoc_mesh(N)):
        loaded = JMap.load(ts, j.log, mesh=mesh, sequencer="native")
        assert {d: loaded.read_doc(d) for d in docs} == want


# -------------------------------------------------------------------- tree

def _tree_engines(n_docs=16):
    kw = dict(n_docs=n_docs, capacity=256, batch_window=10 ** 9,
              sequencer="native")
    engines = (JTree(mesh=jdoc_mesh(N), **kw),
               TTree(mesh=_tmesh(), device="cpu", **kw),
               TTree(device="cpu", **kw))
    docs = [f"t-{i}" for i in range(n_docs)]
    for e in engines:
        for d in docs:
            e.connect(d, 1)
    return engines, docs


def _tree_drive(engines, docs, seeds):
    per_doc = {d: [m.contents for m in tree_session(s, n_rounds=5)[1]]
               for d, s in zip(docs, seeds)}
    w = 0
    while any(per_doc.values()):
        ids, ops = [], []
        for d in docs:
            if per_doc[d]:
                ids.append(d)
                ops.append(per_doc[d].pop(0))
        for e in engines:
            res = e.ingest_batch(ids, [1] * len(ids), [w + 1] * len(ids),
                                 [0] * len(ids), ops)
            assert res["nacked"] == 0
        jax.block_until_ready(engines[0].store.state)
        w += 1


def _same_tree(j, t, docs):
    for d in docs[::3]:
        assert t.to_dict(d) == j.to_dict(d), d
    assert np.array_equal(t.store.digests(), np.asarray(j.store.digests()))
    for k, v in t.store.state.fields().items():
        assert np.array_equal(v.numpy(),
                              np.asarray(getattr(j.store.state, k))), k


def test_sharded_tree_engine_and_summaries_like_jax():
    engines, docs = _tree_engines()
    _tree_drive(engines, docs, range(40, 56))
    j, t, u = engines
    _same_tree(j, t, docs)
    _same_tree(j, u, docs)
    js, ts = j.summarize(), t.summarize()
    tail = [{"op": "insert", "parent": "root", "field": "kids",
             "after": None, "nodes": [{"id": "tail-node"}]}]
    for e in engines:
        assert e.ingest_batch([docs[0]], [1], [e.deli.doc_seq(docs[0])],
                              [0], tail)["nacked"] == 0
    for mesh in (None, _tmesh()):
        for s in (js, ts):
            loaded = TTree.load(s, t.log, device="cpu", mesh=mesh,
                                sequencer="native")
            for d in docs[::5]:
                assert loaded.to_dict(d) == t.to_dict(d), d
            assert (loaded.store.sharded is None) == (mesh is None)
    for mesh in (None, jdoc_mesh(N)):
        loaded = JTree.load(ts, j.log, mesh=mesh, sequencer="native")
        for d in docs[::5]:
            assert loaded.to_dict(d) == j.to_dict(d), d


# ------------------------------------------------------------------ matrix

def _mx_engines(n_docs=16):
    kw = dict(n_docs=n_docs, cell_capacity=4096, batch_window=10 ** 9,
              sequencer="native")
    engines = (JMatrix(mesh=jdoc_mesh(N), **kw),
               TMatrix(mesh=_tmesh(), device="cpu", **kw),
               TMatrix(device="cpu", **kw))
    docs = [f"x-{i}" for i in range(n_docs)]
    for e in engines:
        for d in docs:
            e.connect(d, 1)
    return engines, docs


def _mx_drive(engines, docs, with_fww=False):
    rng = random.Random(7)
    cseq = {d: 0 for d in docs}
    for rnd in range(4):
        for d in docs:
            ops = [{"mx": "insRow", "pos": 0, "count": 2,
                    "opKey": [rnd + 1, 0]},
                   {"mx": "insCol", "pos": 0, "count": 2,
                    "opKey": [100 + rnd, 0]},
                   {"mx": "setCell", "row": rng.randrange(2),
                    "col": rng.randrange(2), "value": f"{d}-{rnd}"}]
            if with_fww and rnd == 2:
                ops.append({"mx": "policy"})
            if rnd == 3:
                ops.append({"mx": "rmRow", "start": 0, "count": 1})
            for op in ops:
                cseq[d] += 1
                for e in engines:
                    _, nack = e.submit(d, 1, cseq[d], 0, op)
                    assert nack is None, (d, op, nack)
        for e in engines:
            e.flush()
    return cseq


def _same_matrix(j, t, docs, planes=True):
    """Reads alike; with ``planes`` the axis counts and flags too (the
    engines must then have compacted alike)."""
    for d in docs:
        assert t.dims(d) == j.dims(d), d
        assert t.to_lists(d) == j.to_lists(d), d
    if planes:
        for k in ("count", "overflow"):
            assert np.array_equal(getattr(t.axis_store.state, k).numpy(),
                                  np.asarray(getattr(j.axis_store.state,
                                                     k))), k


def test_sharded_matrix_engine_like_jax():
    engines, docs = _mx_engines()
    _mx_drive(engines, docs, with_fww=True)
    j, t, u = engines
    _same_matrix(j, t, docs)
    _same_matrix(j, u, docs)
    # each shard's pool holds its own docs' cells, as the JAX pools do
    jkey = np.asarray(j.store.state.key)
    jcount = np.asarray(j.store.state.count)
    for s, st in enumerate(t.store.shards):
        n = int(st.count)
        assert n == int(jcount[s])
        assert np.array_equal(st.key.numpy()[:n], jkey[s, :n]), s
    assert t.store.digest() == u.store.digest()


def test_sharded_matrix_cells_and_summaries_cross_packages():
    """Cell ingest through the sharded resolve (K4 a shard) and pools;
    the JAX ``"sharded_docs"`` summary loads into the port with and
    without a mesh, the port's sharded summary into the JAX engine on its
    mesh, and an unsharded summary into the port on a mesh; deltas too."""
    engines, docs = _mx_engines()
    cseq = _mx_drive(engines, docs)
    n = len(docs)
    for e in engines:
        res = e.ingest_cells(docs, [1] * n, [cseq[d] + 1 for d in docs],
                             [0] * n, [0] * n, [1] * n,
                             [f"v{i}" for i in range(n)])
        assert res["nacked"] == 0
    j, t, u = engines
    _same_matrix(j, t, docs, planes=False)
    _same_matrix(u, t, docs)
    js, ts, us = j.summarize(), t.summarize(), u.summarize()
    assert ts["store"]["sharded_docs"] == n
    want = {d: j.to_lists(d) for d in docs}
    for s, log in ((js, t.log), (ts, t.log), (us, u.log)):
        for mesh in (None, _tmesh()):
            loaded = TMatrix.load(s, log, device="cpu", mesh=mesh,
                                  sequencer="native")
            assert {d: loaded.to_lists(d) for d in docs} == want
    loaded = JMatrix.load(ts, j.log, mesh=jdoc_mesh(N), sequencer="native")
    assert {d: loaded.to_lists(d) for d in docs} == want
    for e in engines:
        _, nack = e.submit(docs[0], 1, cseq[docs[0]] + 2, 0, {
            "mx": "setCell", "row": 0, "col": 0, "value": "late"})
        assert nack is None
        e.flush()
    for delta in (j.summarize(incremental=True),
                  t.summarize(incremental=True)):
        assert delta["kind"] == "delta"
        loaded = TMatrix.load(delta, t.log, device="cpu", mesh=_tmesh(),
                              sequencer="native")
        assert loaded.get_cell(docs[0], 0, 0) == "late"
        for d in docs[::3]:
            assert loaded.to_lists(d) == j.to_lists(d), d
