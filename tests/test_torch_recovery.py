"""Overflow recovery and the graduated tier of the port's
StringServingEngine (``device="cpu"``, plain versions) against the JAX
engine fed the same submits or columnar waves: the same recovery reports,
texts, properties, doc rows and free-row reuse, flat-store and graduated-
store digests, and ``[0, count)`` planes (the compaction contract).
Tolerance: exact. The flat cases mirror ``tests/test_overflow_recovery.py``.
"""

import random

import numpy as np
import pytest

from fluidframework_tpu.server.ingest_pipeline import (
    PipelinedIngestExecutor as JExecutor,
)
from fluidframework_tpu.server.serving import StringServingEngine as JEngine
from fluidframework_tpu.testing.synthetic import typing_storm
from fluidframework_tpu_torch.ops.merge_tree import PLANES
from fluidframework_tpu_torch.ops.string_store import TensorStringStore
from fluidframework_tpu_torch.server.ingest_pipeline import (
    PipelinedIngestExecutor as TExecutor,
)
from fluidframework_tpu_torch.server.serving import (
    StringServingEngine as TEngine,
)
from tests.test_merge_tree_kernel import collab_stream


def _pair(auto_recover=True, **kw):
    j, t = JEngine(**kw), TEngine(**kw, device="cpu")
    for eng in (j, t):
        eng.auto_recover = auto_recover
    return j, t


def _feed(engines, doc, msgs):
    """The oracle stream's op contents through each engine's submit (the
    engines sequence them again; every op saw the whole doc)."""
    for eng in engines:
        for cid in sorted({m.client_id for m in msgs}):
            eng.connect(doc, cid)
        cseq = {}
        for m in msgs:
            cseq[m.client_id] = cseq.get(m.client_id, 0) + 1
            _, nack = eng.submit(doc, m.client_id, cseq[m.client_id],
                                 eng.deli.doc_seq(doc), m.contents)
            assert nack is None, (m, nack)


def _insert(engines, doc, cs, pos, text, client=1):
    for eng in engines:
        _, nack = eng.submit(doc, client, cs, eng.deli.doc_seq(doc),
                             {"mt": "insert", "kind": 0, "pos": pos,
                              "text": text})
        assert nack is None


def same_store(js, ts):
    """A JAX store and a port store hold the same state: counts, flags,
    digests and every plane over ``[0, count)``, and the same interner
    tables."""
    assert (js.n_docs, js.capacity, js.n_props) == \
        (ts.n_docs, ts.capacity, ts.n_props)
    count = np.asarray(js.state.count)
    assert np.array_equal(count, ts.state.count.numpy())
    assert np.array_equal(np.asarray(js.state.overflow),
                          ts.state.overflow.numpy())
    assert np.array_equal(js.digests(), ts.digests())
    for k in PLANES + ("prop_val",):
        a = np.asarray(getattr(js.state, k))
        b = getattr(ts.state, k).numpy()
        for d in range(len(count)):
            assert np.array_equal(a[d, :count[d]], b[d, :count[d]]), (k, d)
    assert js._payloads == ts._payloads
    assert js._client_idx == ts._client_idx
    assert js._prop_planes == ts._prop_planes
    assert js._prop_values.export() == ts._prop_values.export()


def same_engine(j, t):
    assert j._doc_rows == t._doc_rows
    assert j._free_rows == t._free_rows
    assert sorted(j._graduated) == sorted(t._graduated)
    assert j._min_seq == t._min_seq
    for d in sorted(set(j._doc_rows) | set(j._graduated)):
        assert j.read_text(d) == t.read_text(d), d
        assert j.deli.doc_seq(d) == t.deli.doc_seq(d), d
    same_store(j.store, t.store)
    for d in j._graduated:
        same_store(j._graduated[d], t._graduated[d])


def test_reupload_matches_jax():
    """Overflow mid-stream, then the rebuild compacts below capacity and
    the doc re-uploads into its row."""
    _, _, msgs = collab_stream(3, n_rounds=20)
    j, t = _pair(auto_recover=False, n_docs=2, capacity=64, batch_window=8,
                 compact_every=10 ** 9)
    _feed((j, t), "d", msgs)
    for eng in (j, t):
        eng.flush()
        assert eng.overflowed_docs() == ["d"]
    reports = [j.recover_overflowed(), t.recover_overflowed()]
    assert reports[0] == reports[1] == {"d": "reuploaded"}
    assert t.overflowed_docs() == []
    assert t.last_recovery["docs"] == 1
    same_engine(j, t)
    row = t.doc_row("d")
    assert t.store.visible_length(row) == j.store.visible_length(row)


def test_graduation_then_row_recycling_matches_jax():
    j, t = _pair(auto_recover=False, n_docs=2, capacity=32, batch_window=4,
                 compact_every=10 ** 9)
    for eng in (j, t):
        eng.connect("d", 1)
    rng = random.Random(0)
    shadow = ""
    for i in range(80):
        pos = rng.randint(0, len(shadow))
        _insert((j, t), "d", i + 1, pos, f"w{i}")
        shadow = shadow[:pos] + f"w{i}" + shadow[pos:]
    for eng in (j, t):
        eng.flush()
    assert j.recover_overflowed() == t.recover_overflowed() == \
        {"d": "graduated"}
    assert t.read_text("d") == shadow
    same_engine(j, t)
    _insert((j, t), "d", 81, 0, "HEAD:")   # the graduated tier serves ops
    for eng in (j, t):
        eng.connect("e", 9)
        eng.submit("e", 9, 1, 0,
                   {"mt": "insert", "kind": 0, "pos": 0, "text": "ok"})
        assert eng.doc_row("e") == 0   # d's old row, recycled
    assert t.read_text("e") == "ok"
    assert t.read_text("d") == "HEAD:" + shadow
    same_engine(j, t)


def test_auto_recovery_on_cadence_matches_jax():
    _, _, msgs = collab_stream(5, n_rounds=20)
    j, t = _pair(n_docs=2, capacity=64, batch_window=8, compact_every=2)
    _feed((j, t), "d", msgs)
    for eng in (j, t):
        eng.flush()
        eng.compact()
        assert eng.overflowed_docs() == []
    same_engine(j, t)


def test_annotations_survive_recovery_like_jax():
    """Props survive the rebuild and the handle/plane remap."""
    _, _, msgs = collab_stream(9, n_rounds=16, with_annotates=True)
    j, t = _pair(auto_recover=False, n_docs=1, capacity=64, batch_window=8,
                 compact_every=10 ** 9)
    _feed((j, t), "d", msgs)
    for eng in (j, t):
        eng.flush()
        assert eng.overflowed_docs() == ["d"]
    assert j.recover_overflowed() == t.recover_overflowed()
    same_engine(j, t)
    text = t.read_text("d")
    for pos in range(0, len(text), max(1, len(text) // 16)):
        assert t.get_properties("d", pos) == j.get_properties("d", pos), pos
        assert t.store.seq_at(0, pos) == j.store.seq_at(0, pos), pos
    assert any(t.get_properties("d", p) for p in range(len(text)))


def test_graduated_store_regrows_like_jax():
    j, t = _pair(auto_recover=False, n_docs=2, capacity=32, batch_window=4,
                 compact_every=10 ** 9)
    for eng in (j, t):
        eng.connect("d", 1)
    cs = 0
    for i in range(60):
        cs += 1
        _insert((j, t), "d", cs, 0, f"w{i}")
    for eng in (j, t):
        eng.flush()
    assert j.recover_overflowed() == t.recover_overflowed() == \
        {"d": "graduated"}
    cap0 = t._graduated["d"].capacity
    while not t._graduated["d"].overflowed().any():
        cs += 1
        _insert((j, t), "d", cs, 0, f"g{cs}")
        for eng in (j, t):
            eng.flush()
    assert j._graduated["d"].overflowed().any()
    assert j.recover_overflowed() == t.recover_overflowed() == \
        {"d": "regrown"}
    assert t._graduated["d"].capacity > cap0
    same_engine(j, t)


def test_mass_overflow_batch_matches_jax():
    """32 docs overflow together; the batched rebuild re-uploads the
    compactable half and graduates the rest."""
    R = 32
    j, t = _pair(auto_recover=False, n_docs=R, capacity=128,
                 batch_window=10 ** 9)
    docs = [f"mass-{i}" for i in range(R)]
    for eng in (j, t):
        for i, d in enumerate(docs):
            eng.connect(d, 1)
            for k in range(150):
                _, nack = eng.submit(d, 1, k + 1, 0, {
                    "mt": "insert", "kind": 0, "pos": 0, "text": "M"})
                assert nack is None
            if i % 2:
                for k in range(130):
                    _, nack = eng.submit(d, 1, 151 + k, 150, {
                        "mt": "remove", "start": 0, "end": 1})
                    assert nack is None
        eng.flush()
        for i, d in enumerate(docs):
            if i % 2:
                eng.heartbeat(d, 1, eng.deli.doc_seq(d))
        assert eng.store.overflowed().sum() == R
    rj, rt = j.recover_overflowed(), t.recover_overflowed()
    assert rj == rt
    assert [rt[d] for d in docs] == ["graduated", "reuploaded"] * (R // 2)
    assert t.last_recovery["rebuilds"] == [
        {"D": R, "S": 256, "op_windows": [512]}]
    same_engine(j, t)


# ------------------------------------------------------- columnar overflow

TEXT = "abcd"


def _wave(R, O, b):
    planes, _ = typing_storm(R, O, seed=b)
    cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                   dtype=np.int32), (R, O))
    return dict(client=np.ones((R, O), np.int32), client_seq=cs,
                ref_seq=cs, kind=planes["kind"], a0=planes["a0"],
                a1=planes["a1"], text=TEXT)


def _columnar_pair(R, S):
    kw = dict(n_docs=R, capacity=S, batch_window=10 ** 9, compact_every=1,
              sequencer="native")
    j, t = JEngine(**kw), TEngine(**kw, device="cpu")
    docs = [f"doc-{i}" for i in range(R)]
    for eng in (j, t):
        for d in docs:
            eng.connect(d, 1)
        for d in docs:
            eng.doc_row(d)
    return j, t, docs


def test_columnar_overflow_serial_recovers_like_jax():
    """Serial ``ingest_planes`` waves at a capacity the storm outgrows: the
    log stage's deferred harvest recovers inline (no OverflowError). It
    reads the previous compaction's flags, so the rebuild already holds
    the next wave and these docs graduate; they then take per-op ops."""
    R, O, S = 12, 16, 96
    j, t, docs = _columnar_pair(R, S)
    outcomes = set()
    for b in range(6):
        live = [i for i, d in enumerate(docs) if d in t._doc_rows]
        assert live == [i for i, d in enumerate(docs) if d in j._doc_rows]
        w = {k: (v[live] if isinstance(v, np.ndarray) else v)
             for k, v in _wave(R, O, b).items()}
        rows = np.array([t.doc_row(docs[i]) for i in live], np.int32)
        rj = j.ingest_planes(rows, **w)
        rt = t.ingest_planes(rows, **w)
        assert np.array_equal(rj["seq"], rt["seq"])
        assert rt["nacked"] == 0
        assert j._doc_rows == t._doc_rows
        outcomes |= set(t._graduated)
    assert outcomes == set(docs)
    assert j.recover_overflowed() == t.recover_overflowed() == {}
    _insert((j, t), docs[3], 6 * O + 1, 5, "tail")
    same_engine(j, t)


def test_columnar_overflow_pipelined_drain_recovers_like_jax():
    """The same storm through the pipelined executor: the log stage only
    marks recovery due; ``drain`` recovers once nothing is in flight, and
    one more ``recover_overflowed`` heals what the last compaction saw."""
    R, O, S = 12, 16, 96
    j, t, docs = _columnar_pair(R, S)
    rows = np.array([t.doc_row(d) for d in docs], np.int32)
    waves = [_wave(R, O, b) for b in range(6)]
    reports = []
    for eng, Ex in ((j, JExecutor), (t, TExecutor)):
        with Ex(eng, depth=3) as ex:
            tickets = [ex.submit(rows, **w) for w in waves]
            ex.drain()
            assert all(tk.result()["nacked"] == 0 for tk in tickets)
        drained = getattr(eng, "last_recovery", None)
        reports.append(eng.recover_overflowed())
    assert drained and drained["docs"] > 0    # the drain recovered
    assert reports[0] == reports[1]
    assert t.overflowed_docs() == []
    assert not t._ov_recover_due
    same_engine(j, t)


def test_engine_stores_sit_on_its_device():
    """Rebuild and graduated stores are built on the engine's device: a
    store built without one is on the card (and raises without it)."""
    j, t = _pair(auto_recover=False, n_docs=2, capacity=32, batch_window=4,
                 compact_every=10 ** 9)
    for eng in (j, t):
        eng.connect("d", 1)
    for i in range(60):
        _insert((j, t), "d", i + 1, 0, f"w{i}")
    t.recover_overflowed()
    assert t._graduated["d"].device.type == "cpu"
    with pytest.raises(MemoryError, match="grow limit"):
        TEngine._rebuild_doc(t, "d", t._graduated["d"], grow_limit=64)


# ------------------------------------------------------- windowed apply

def test_windowed_apply_equals_one_shot(monkeypatch):
    """``apply_messages`` split into op windows (the card's shared-memory
    bound, forced small here) leaves every plane bit-identical to the
    one-shot plain apply, slots past ``count`` and overflow included."""
    _, _, msgs = collab_stream(9, n_rounds=16, with_annotates=True)
    recv = [(d, m) for d in range(3) for m in msgs[d * 7:]]
    one = TensorStringStore(4, 48, 4, device="cpu")
    one.apply_messages(recv)
    assert len(one.last_op_windows) == 1
    win = TensorStringStore(4, 48, 4, device="cpu")
    monkeypatch.setattr(TensorStringStore, "_op_window", lambda self: 24)
    win.apply_messages(recv)
    assert win.last_op_windows[:-1] == [24] * (len(win.last_op_windows) - 1)
    assert len(win.last_op_windows) > 2
    for k, v in one.state.fields().items():
        assert np.array_equal(v.numpy(), getattr(win.state, k).numpy()), k
    assert one.overflowed().any()      # the sticky flag crossed windows
    assert one._payloads == win._payloads
