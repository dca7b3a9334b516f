"""The port's ``MegaDocStringStore`` against the JAX package's on the
virtual 8-device CPU mesh, driven with multi-client oracle streams.

Mirrors ``tests/test_megadoc_store.py``'s cases: both stores take the same
sequenced messages; reads (text, visible length, properties, insert seqs)
are equal, and so are the planes, counts, overflow flags and digests.
Snapshots load across the packages in both directions. Tolerance: exact."""

import random

import numpy as np
import pytest

from fluidframework_tpu.ops.megadoc_store import (
    MegaDocStringStore as JMegaStore,
)
from fluidframework_tpu.ops.string_store import (
    TensorStringStore as JFlatStore,
)
from fluidframework_tpu_torch.ops.megadoc_store import (
    MegaDocStringStore, live_slots,
)
from fluidframework_tpu_torch.ops.string_store import TensorStringStore
from tests.test_merge_tree_kernel import collab_stream


def _stores(n_docs, cap, **kw):
    return (JMegaStore(n_docs=n_docs, capacity_per_shard=cap, **kw),
            MegaDocStringStore(n_docs=n_docs, capacity_per_shard=cap,
                               device="cpu", **kw))


def _assert_same(j, t):
    js, ts = j.snapshot(), t.snapshot()
    for k in js["planes"]:
        assert np.array_equal(js["planes"][k], ts["planes"][k]), k
    for k in ("count", "overflow"):
        assert np.array_equal(js[k], ts[k]), k
    for k in ("payloads", "client_idx", "prop_planes", "has_props",
              "capacity_per_shard", "n_shards"):
        assert js[k] == ts[k], k
    assert np.array_equal(j.digests(), t.digests())


def _assert_reads(j, t, doc):
    assert t.read_text(doc) == j.read_text(doc)
    n = t.visible_length(doc)
    assert n == j.visible_length(doc)
    for pos in range(n):
        assert t.get_properties(doc, pos) == j.get_properties(doc, pos)
        assert t.seq_at(doc, pos) == j.seq_at(doc, pos)


@pytest.mark.parametrize("seed", range(2))
def test_megadoc_store_matches_jax_oracle_and_flat_store(seed):
    text, length, msgs, clients = collab_stream(
        seed, with_annotates=True, return_clients=True)
    j, t = _stores(1, 64)
    flat = TensorStringStore(n_docs=1, capacity=512, device="cpu")
    for s in (j, t, flat):
        s.apply_messages((0, m) for m in msgs)
    assert not t.overflowed().any()
    assert t.read_text(0) == flat.read_text(0) == text
    assert t.visible_length(0) == length
    oracle = clients[0]
    for pos in range(length):
        seg, _ = oracle.tree.get_containing_segment(pos)
        want = {k: v for k, v in seg.props.items() if v is not None}
        assert t.get_properties(0, pos) == want, pos
    _assert_same(j, t)
    _assert_reads(j, t, 0)


def test_megadoc_store_preemptive_rebalance_survives_long_stream():
    text, _, msgs = collab_stream(8, n_rounds=14)
    j, t = _stores(1, 24, rebalance_headroom=0.4)
    for i in range(0, len(msgs), 8):
        for s in (j, t):
            s.apply_messages((0, m) for m in msgs[i:i + 8])
        _assert_same(j, t)
    assert not t.overflowed().any()
    assert t.read_text(0) == text
    assert (t.slot_usage() <= 24).all()


def test_megadoc_store_compaction_frees_slots_preserves_text():
    text, _, msgs = collab_stream(5, n_rounds=15)
    j, t = _stores(1, 128)
    for s in (j, t):
        s.apply_messages((0, m) for m in msgs)
    used = t.slot_usage().sum()
    for s in (j, t):
        s.compact(max(m.seq for m in msgs))
    _assert_same(j, t)
    assert t.slot_usage().sum() <= used
    assert t.read_text(0) == text


def test_megadoc_store_many_docs():
    streams = [collab_stream(seed, n_rounds=4) for seed in range(3)]
    interleaved = []
    idx = [0] * 3
    rng = random.Random(0)
    while any(idx[d] < len(streams[d][2]) for d in range(3)):
        d = rng.randrange(3)
        if idx[d] < len(streams[d][2]):
            interleaved.append((d, streams[d][2][idx[d]]))
            idx[d] += 1
    j, t = _stores(3, 64)
    for s in (j, t):
        s.apply_messages(interleaved)
    _assert_same(j, t)
    for d in range(3):
        assert t.read_text(d) == streams[d][0], d
        _assert_reads(j, t, d)


def test_megadoc_store_snapshots_cross_packages():
    """A JAX snapshot restores into the port and a port snapshot into the
    JAX store; both continue the same stream to the same state."""
    text, _, msgs, clients = collab_stream(
        3, with_annotates=True, return_clients=True)
    half = len(msgs) // 2
    j, t = _stores(1, 64)
    for s in (j, t):
        s.apply_messages((0, m) for m in msgs[:half])
    t2 = MegaDocStringStore.restore(j.snapshot(), device="cpu")
    j2 = JMegaStore.restore(t.snapshot())
    for s in (j, t, j2, t2):
        s.apply_messages((0, m) for m in msgs[half:])
    _assert_same(j, t2)
    _assert_same(j2, t)
    assert t2.read_text(0) == t.read_text(0) == text


def test_megadoc_store_adopt_doc_matches():
    """The re-upload step: a rebuilt flat doc dealt over the shards."""
    text, _, msgs = collab_stream(4, n_rounds=8, with_annotates=True)
    jflat, tflat = JFlatStore(1, 512), TensorStringStore(1, 512,
                                                         device="cpu")
    for s in (jflat, tflat):
        s.apply_messages((0, m) for m in msgs)
    j, t = _stores(2, 32)
    j = j.adopt_doc(1, jflat)
    t = t.adopt_doc(1, tflat)
    _assert_same(j, t)
    assert t.read_text(1) == text
    _assert_reads(j, t, 1)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_megadoc_store_adopts_a_one_doc_mega_rebuild_like_jax(n_shards):
    """The re-upload step from a one-doc mega rebuild (the port's
    recovery path): its compacted live slots in document order (shard by
    shard, [0, count) of each) equal a flat rebuild's [0, count), and
    dealt over the shards they leave the row exactly as the JAX store's
    ``adopt_doc`` of its flat rebuild does."""
    text, _, msgs = collab_stream(5, n_rounds=10, with_annotates=True)
    floor = msgs[len(msgs) // 2].seq
    jflat = JFlatStore(1, 512)
    tmega = MegaDocStringStore(1, 64, n_shards=n_shards, device="cpu")
    for s in (jflat, tmega):
        s.apply_messages((0, m) for m in msgs)
        s.compact(floor)
    assert not tmega.overflowed().any()
    n = int(np.asarray(jflat.state.count[0]))
    live = live_slots(tmega.state)
    for k, v in live.items():
        assert np.array_equal(v, np.asarray(getattr(jflat.state, k)[0][:n])), k
    j, t = _stores(2, 32)
    j = j.adopt_doc(1, jflat)
    t = t.adopt_doc(1, tmega)
    _assert_same(j, t)
    assert t.read_text(1) == text
    _assert_reads(j, t, 1)
