"""Card-only tests of the hand-written Hopper kernels: every string_apply
specialisation ({no props, props} × {apply, apply+compact}), the map apply
(dense and packed) and the cell merge (prefix and full, LWW and FWW)
against their plain PyTorch versions on the same CUDA inputs, and the
stores and engines on the card against the same on the CPU, and config
#4 on the durable op log (a sync a batch, a SIGKILLed child recovered
from disk, the native build refusing to fall back). Tolerance: exact
(int32).

Run on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Without a card every test skips (the decision
is taken inside the fixture, so every worker collects the same tests)."""

import os

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import cell_merge as cmk
from fluidframework_tpu_torch.ops import map_apply as mak
from fluidframework_tpu_torch.ops import map_kernel as mk
from fluidframework_tpu_torch.ops import matrix_kernel as mx
from fluidframework_tpu_torch.ops import merge_tree as mt
from fluidframework_tpu_torch.ops import string_kernel as sk
from fluidframework_tpu_torch.ops.schema import OpKind
from fluidframework_tpu_torch.testing.synthetic import (
    conflict_storm, edge_storm, typing_storm,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clone(st):
    return mt.StringState(**{k: v.clone() for k, v in st.fields().items()})


@pytest.mark.parametrize("props", [False, True])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("S,corpus", [(128, "storm"), (384, "storm"),
                                      (256, "edge")])
def test_kernel_matches_plain(cuda, props, compact, S, corpus):
    D, O = 64, 32
    gen = edge_storm if corpus == "edge" else \
        conflict_storm if props else typing_storm
    st = mt.StringState.create(D, S, 4, device=cuda)
    ref = _clone(st)
    seq = 1
    for b in range(3):
        planes, seq = gen(D, O, seed=b, start_seq=seq)
        ops = [torch.as_tensor(planes[k]).to(cuda) for k in mt.OP_FIELDS]
        ms = torch.full((D,), max(seq - D * 16, 0), dtype=torch.int32,
                        device=cuda) if compact else None
        before = sk.launches
        sk.apply_string_batch_fused(st, *ops, min_seq=ms, with_props=props)
        assert sk.launches == before + 1
        ref = mt.apply_string_batch(ref, *ops, with_props=props)
        if compact:
            ref = mt.compact_string_state(ref, ms, props)
        torch.cuda.synchronize()
        keys = mt.PLANES + (("prop_val",) if props else ())
        if not compact:   # full planes, slots past count included
            for k in keys + ("count", "overflow"):
                assert torch.equal(getattr(st, k), getattr(ref, k)), (b, k)
            continue
        assert torch.equal(st.count, ref.count)
        cnt = st.count.cpu().numpy()
        for k in keys:
            a, c = getattr(st, k).cpu().numpy(), getattr(ref, k).cpu().numpy()
            for d in range(D):
                assert np.array_equal(a[d, :cnt[d]], c[d, :cnt[d]]), (b, k, d)
        assert torch.equal(mt.string_state_digest(st),
                           mt.string_state_digest(ref))


def test_engine_on_card_matches_cpu(cuda):
    from fluidframework_tpu_torch.server.ingest_pipeline import (
        PipelinedIngestExecutor,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    R, O = 16, 16
    engines = [StringServingEngine(n_docs=R, capacity=256,
                                   batch_window=10 ** 9, compact_every=2,
                                   sequencer="native", device=dev)
               for dev in (cuda, "cpu")]
    docs = [f"d{i}" for i in range(R)]
    for eng in engines:
        for d in docs:
            eng.connect(d, 1)
        rows = np.array([eng.doc_row(d) for d in docs], np.int32)
        with PipelinedIngestExecutor(eng, depth=3) as ex:
            for b in range(4):
                planes, _ = typing_storm(R, O, seed=b)
                cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                               dtype=np.int32), (R, O))
                ex.submit(rows, np.ones((R, O), np.int32), cs, cs,
                          planes["kind"], planes["a0"], planes["a1"],
                          text="abcd")
            ex.drain()
    for d in docs:
        assert engines[0].read_text(d) == engines[1].read_text(d), d
    assert np.array_equal(engines[0].store.digests(),
                          engines[1].store.digests())


# ------------------------------------------------ edges of the kernel design
# Shapes that cross every slots-per-thread and warp boundary (ragged S), the
# shared-memory tier above S = 2048, input tails past ``count`` that are not
# fill, docs at the overflow edge, and the property-plane counts.

def _ops(planes, dev):
    return [torch.as_tensor(np.ascontiguousarray(planes[k])).to(dev)
            for k in mt.OP_FIELDS]


def _assert_same(st, ref, props, compact, tag):
    keys = mt.PLANES + (("prop_val",) if props else ())
    if not compact:   # full planes, slots past count included
        for k in keys + ("count", "overflow"):
            assert torch.equal(getattr(st, k), getattr(ref, k)), (tag, k)
        return
    assert torch.equal(st.count, ref.count), tag
    assert torch.equal(st.overflow, ref.overflow), tag
    act = torch.arange(st.seq.shape[1], device=st.seq.device)[None, :] < \
        st.count[:, None]
    for k in keys:
        a, b = getattr(st, k), getattr(ref, k)
        m = act if a.dim() == 2 else act[:, :, None].expand_as(a)
        assert torch.equal(a[m], b[m]), (tag, k)
    assert torch.equal(mt.string_state_digest(st),
                       mt.string_state_digest(ref)), tag


def _chain(dev, st, gen, O, props, compact, n_batches=2, seed=0, **kw):
    """Kernel and plain version over chained batches from ``st``; after a
    compaction both continue from the kernel's state."""
    D = st.seq.shape[0]
    ref = _clone(st)
    seq = 1
    for b in range(n_batches):
        planes, seq = gen(D, O, seed=seed * 10 + b, start_seq=seq, **kw)
        ops = _ops(planes, dev)
        ms = torch.full((D,), max(seq - D * 16, 0), dtype=torch.int32,
                        device=dev) if compact else None
        sk.apply_string_batch_fused(st, *ops, min_seq=ms, with_props=props)
        ref = mt.apply_string_batch(ref, *ops, with_props=props)
        if compact:
            ref = mt.compact_string_state(ref, ms, props)
        torch.cuda.synchronize()
        _assert_same(st, ref, props, compact, (b, props, compact))
        if compact:
            ref = _clone(st)
    return st


SPECS = [("no-props", False, False), ("no-props+compact", False, True),
         ("props", True, False), ("props+compact", True, True)]


@pytest.mark.parametrize("spec", [s[0] for s in SPECS])
@pytest.mark.parametrize("S", [32, 33, 100, 255, 257, 512, 1000, 2048, 3000])
def test_kernel_capacity_edges(cuda, S, spec):
    _, props, compact = next(s for s in SPECS if s[0] == spec)
    st = mt.StringState.create(37, S, 4, device=cuda)
    gen = conflict_storm if props else typing_storm
    _chain(cuda, st, gen, 64, props, compact)


@pytest.mark.parametrize("compact", [False, True])
def test_kernel_shared_tier_largest_capacity(cuda, compact):
    """S = 8192: the largest capacity the kernel takes (planes in shared
    memory, 32 slots per thread)."""
    st = mt.StringState.create(5, 8192, 4, device=cuda)
    _chain(cuda, st, typing_storm, 64, False, compact)
    assert sk.launch_shape(8192) == {"threads": 256, "docs_per_cta": 1,
                                     "slots_per_lane": 32}
    assert sk.launch_shape(512) == {"threads": 256, "docs_per_cta": 1,
                                    "slots_per_lane": 2}


@pytest.mark.parametrize("O", [0, 1, 64])
@pytest.mark.parametrize("props", [False, True])
def test_kernel_op_counts(cuda, O, props):
    st = mt.StringState.create(37, 256, 4, device=cuda)
    _chain(cuda, st, conflict_storm, O, props, compact=props)


@pytest.mark.parametrize("spec", [s[0] for s in SPECS])
def test_kernel_input_tail_not_fill(cuda, spec):
    """The plain compaction sorts the dropped slots to the tail, so its
    output's slots past ``count`` are not fill: the kernel must take such a
    state (it then bounds its work by S, not by the live extent)."""
    _, props, compact = next(s for s in SPECS if s[0] == spec)
    D, S = 37, 257
    st = mt.StringState.create(D, S, 4, device=cuda)
    ref = _clone(st)
    seq = 1
    for b in range(2):
        planes, seq = conflict_storm(D, 64, seed=b, start_seq=seq)
        ref = mt.apply_string_batch(ref, *_ops(planes, cuda),
                                    with_props=props)
    ref = mt.compact_string_state(
        ref, torch.full((D,), seq - D * 40, dtype=torch.int32, device=cuda),
        props)
    act = torch.arange(S, device=cuda)[None, :] < ref.count[:, None]
    assert (~act & (ref.removed_seq != mt.NOT_REMOVED)).any()  # not fill
    _chain(cuda, _clone(ref), conflict_storm, 64, props, compact, seed=5)


def _packed_state(dev, counts, S, K=4):
    """Docs whose first ``counts[d]`` slots are live 4-char segments."""
    D = len(counts)
    st = mt.StringState.create(D, S, K, device=dev)
    i = torch.arange(S, device=dev, dtype=torch.int32)[None, :]
    live = i < torch.as_tensor(counts, device=dev)[:, None]
    st.seq.copy_(torch.where(live, i + 1, 0))
    st.length.copy_(torch.where(live, 4, 0))
    st.handle_op.copy_(torch.where(live, i + 1, 0))
    st.count.copy_(torch.as_tensor(counts, dtype=torch.int32, device=dev))
    return st


def _op_planes(rows, start_seq):
    """Dense op planes from per-doc lists of (kind, a0, a1, a2)."""
    D, O = len(rows), max(len(r) for r in rows)
    p = {k: np.zeros((D, O), np.int32) for k in mt.OP_FIELDS}
    p["kind"][:] = 12   # NOOP pads
    for d, r in enumerate(rows):
        for o, (kind, a0, a1, a2) in enumerate(r):
            p["kind"][d, o], p["a0"][d, o] = kind, a0
            p["a1"][d, o], p["a2"][d, o] = a1, a2
    p["seq"][:] = start_seq + np.arange(D * O, dtype=np.int32).reshape(D, O)
    p["ref_seq"][:] = p["seq"] - 1
    return p


@pytest.mark.parametrize("props", [False, True])
@pytest.mark.parametrize("S", [32, 100, 512])
def test_kernel_overflow_and_roll_edges(cuda, S, props):
    """Docs at count S-1 and S: the sticky overflow fires mid-batch,
    including a range op whose first split fits and whose second
    overflows; inserts at position 0 (the roll's wrapped slot) and at the
    end; a doc with room for everything beside them."""
    counts = [S - 1, S, S - 1, S - 3, 0, 1]
    st = _packed_state(cuda, counts, S)
    total = [4 * c for c in counts]
    ann = (1 << 20) | 7    # key 1, value 7
    rows = []
    for d, n in enumerate(total):
        rows.append([
            (0, 0, 4, 900 + d),        # insert at 0 (boundary, roll wrap)
            (1, 1, max(n - 2, 2), 0),  # remove: two splits
            (0, 2, 4, 901),            # insert strictly inside a segment
            (2, 1, 3, ann),            # annotate inside one segment
            (0, n + 4, 4, 902),        # insert at the end
            (0, 0, 4, 903),
        ][1 if d == 2 else 0:])   # doc 2: the remove's 2nd split overflows
    planes = _op_planes(rows, start_seq=S + 1)
    ops = _ops(planes, cuda)
    for compact in (False, True):
        k_st, ref = _clone(st), _clone(st)
        ms = torch.full((len(counts),), S + 3, dtype=torch.int32,
                        device=cuda) if compact else None
        sk.apply_string_batch_fused(k_st, *ops, min_seq=ms, with_props=props)
        ref = mt.apply_string_batch(ref, *ops, with_props=props)
        if compact:
            ref = mt.compact_string_state(ref, ms, props)
        torch.cuda.synchronize()
        _assert_same(k_st, ref, props, compact, (S, props, compact))
        ovf = k_st.overflow.tolist()
        assert ovf[:3] == [1, 1, 1] and ovf[4] == 0, ovf


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("compact", [False, True])
def test_kernel_prop_planes(cuda, K, compact):
    """edge_storm (clients -1 and 31, keys past K, invalid kinds) with K
    property planes."""
    st = mt.StringState.create(37, 384, K, device=cuda)
    _chain(cuda, st, edge_storm, 64, True, compact, n_batches=3)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("S,K", [(33, 9), (384, 12), (1000, 16), (3000, 12)])
def test_kernel_many_prop_planes(cuda, S, K, compact):
    """More than 8 property planes: a doc takes at least 4 slots per lane
    and keeps the property planes in shared memory; annotate keys span all
    K planes and two past them."""
    assert sk.launch_shape(S, K)["slots_per_lane"] >= 4
    st = mt.StringState.create(37, S, K, device=cuda)
    _chain(cuda, st, conflict_storm, 64, True, compact, n_keys=K + 2)


@pytest.mark.parametrize("S,K,O", [(2048, 4, 512), (2048, 4, 519),
                                   (1024, 8, 512), (2048, 0, 1707),
                                   (2048, 0, 1708)])
def test_kernel_shared_memory_opt_in(cuda, S, K, O):
    """Shapes on both sides of the 48 KB line, where the launch must opt in
    to more shared memory for every byte the CTA uses (scratch included)."""
    props = K > 0
    st = mt.StringState.create(5, S, max(K, 1), device=cuda)
    gen = conflict_storm if props else typing_storm
    _chain(cuda, st, gen, O, props, compact=True, n_batches=1)


# ------------------------------------------------ recovery on the card
# Rebuild stores, graduated stores and windowed applies launch the kernel
# at shapes the flat tier never gives it; each is held against the same
# feed on the CPU (plain versions).

def _doc_ops(rng, n_ops, n_keys=4, start_len=0):
    """Valid op contents for one fully caught-up writer: inserts, removes
    and annotates at random positions of a doc of known length."""
    out, n = [], start_len
    for _ in range(n_ops):
        r = rng.random()
        if n < 4 or r < 0.55:
            pos = int(rng.integers(0, n + 1))
            k = int(rng.integers(1, 4))
            out.append({"mt": "insert", "kind": 0, "pos": pos,
                        "text": "abcdefgh"[:k]})
            n += k
        elif r < 0.8:
            a = int(rng.integers(0, n - 1))
            b = min(n, a + int(rng.integers(1, 3)))
            out.append({"mt": "remove", "start": a, "end": b})
            n -= b - a
        else:
            a = int(rng.integers(0, n - 1))
            b = min(n, a + int(rng.integers(1, 6)))
            out.append({"mt": "annotate", "start": a, "end": b, "props": {
                f"k{int(rng.integers(0, n_keys))}":
                    int(rng.integers(0, 3)) or None}})
    return out


def _recovering_engines(dev, **kw):
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    engines = [StringServingEngine(device=d, **kw) for d in (dev, "cpu")]
    for eng in engines:
        eng.auto_recover = False
    return engines


def _same_engines(a, b):
    assert a._doc_rows == b._doc_rows
    assert sorted(a._graduated) == sorted(b._graduated)
    for d in sorted(set(a._doc_rows) | set(a._graduated)):
        text = a.read_text(d)
        assert text == b.read_text(d), d
        for p in range(0, len(text), 7):
            assert a.get_properties(d, p) == b.get_properties(d, p), (d, p)
    assert np.array_equal(a.store.digests(), b.store.digests())
    for d, st in a._graduated.items():
        assert st.device == a.store.device
        assert np.array_equal(st.digests(), b._graduated[d].digests()), d


def test_recovery_on_card_matches_cpu(cuda):
    """Docs that overflow a small flat tier re-upload or graduate on the
    card exactly as on the CPU; the graduated tier then serves ops, and a
    summary with a delta loads back on the card like on the CPU."""
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    engines = _recovering_engines(cuda, n_docs=8, capacity=96,
                                  batch_window=32, compact_every=4)
    rng = np.random.default_rng(7)
    plan = {f"d{i}": _doc_ops(rng, 150 if i % 2 else 260) for i in range(8)}
    for eng in engines:
        for d, ops in plan.items():
            eng.connect(d, 1)
            for cs, op in enumerate(ops, 1):
                _, nack = eng.submit(d, 1, cs, eng.deli.doc_seq(d), op)
                assert nack is None
        eng.flush()
    reports = [eng.recover_overflowed() for eng in engines]
    assert reports[0] == reports[1]
    assert set(reports[0].values()) == {"reuploaded", "graduated"}
    _same_engines(*engines)
    summaries = []
    for eng in engines:
        eng.auto_recover = True
        summaries.append([eng.summarize()])
    for d, ops in plan.items():   # the tail, both tiers
        more = _doc_ops(rng, 12, start_len=len(engines[1].read_text(d)))
        for eng, s in zip(engines, summaries):
            for cs, op in enumerate(more, len(ops) + 1):
                _, nack = eng.submit(d, 1, cs, eng.deli.doc_seq(d), op)
                assert nack is None
        plan[d] = ops + more
    for eng, s in zip(engines, summaries):
        s.append(eng.summarize(incremental=True))
    _same_engines(*engines)
    loaded = [StringServingEngine.load(s[-1], eng.log, device=dev)
              for eng, s, dev in zip(engines, summaries, (cuda, "cpu"))]
    _same_engines(*loaded)
    with pytest.raises(MemoryError, match="string_apply kernel"):
        engines[0]._check_rebuild_capacity("d0", 2 * sk.MAX_S, 1 << 20,
                                           engines[0].store)


@pytest.mark.parametrize("S,K", [(768, 4), (2048, 16)])
def test_rebuild_store_props_match_plain(cuda, S, K):
    """A rebuild-shaped store (many docs' whole histories at once, with
    property planes; at S=768/K=4 the planes live in shared memory) on the
    card equals the same messages applied on the CPU, full planes."""
    from fluidframework_tpu_torch.core.protocol import (
        MessageType, SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.ops.string_store import TensorStringStore
    assert sk.launch_shape(S, K)["slots_per_lane"] >= 4
    rng = np.random.default_rng(S)
    msgs = []
    for d in range(6):
        for i, op in enumerate(_doc_ops(rng, 200, n_keys=K), 1):
            msgs.append((d, SequencedDocumentMessage(
                f"r{d}", 1 + i % 3, i, i - 1, i, 0, MessageType.OP, op)))
    stores = [TensorStringStore(6, S, K, device=dev) for dev in (cuda, "cpu")]
    for st in stores:
        st.apply_messages(msgs)
    assert stores[0].last_op_windows == stores[1].last_op_windows
    for k, v in stores[1].state.fields().items():
        assert torch.equal(getattr(stores[0].state, k).cpu(), v), k


def test_windowed_rebuild_matches_one_shot_plain(cuda):
    """A doc history longer than one launch can stage (the register tier
    keeps 28 bytes of op fields per op in shared memory) applies in op
    windows on the card and equals the one-shot plain apply on the CPU,
    full planes."""
    from fluidframework_tpu_torch.core.protocol import (
        MessageType, SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.ops.string_store import TensorStringStore
    S, K = 2048, 16
    limit = sk.max_ops(S, K)
    assert limit is not None
    # one insert, then annotates of 16 keys each (16 records a message)
    n_msgs = limit // K + 8
    msgs = []
    for d in range(2):
        ops = [{"mt": "insert", "kind": 0, "pos": 0, "text": "x" * 40}]
        ops += [{"mt": "annotate", "start": (i + d) % 7, "end": 40 - i % 5,
                 "props": {f"k{j}": (i + j + d) % 4 or None
                           for j in range(K)}}
                for i in range(n_msgs)]
        msgs += [(d, SequencedDocumentMessage(f"w{d}", 1, i, i - 1, i, 0,
                                              MessageType.OP, op))
                 for i, op in enumerate(ops, 1)]
    card = TensorStringStore(2, S, K, device=cuda)
    before = sk.launches
    card.apply_messages(msgs)
    assert len(card.last_op_windows) > 1
    assert sk.launches - before == len(card.last_op_windows)
    assert max(card.last_op_windows) <= limit
    cpu = TensorStringStore(2, S, K, device="cpu")
    cpu.apply_messages(msgs)
    assert len(cpu.last_op_windows) == 1 and cpu.last_op_windows[0] > limit
    for k, v in cpu.state.fields().items():
        assert torch.equal(getattr(card.state, k).cpu(), v), k


# ------------------------------------------- map apply kernel (map_apply.cu)
# Each case: the same inputs through the kernel (in place, on the card) and
# the plain version (on the card); all three planes bit-identical.

SET, DEL, CLR, NOOP = (int(OpKind.MAP_SET), int(OpKind.MAP_DELETE),
                       int(OpKind.MAP_CLEAR), int(OpKind.NOOP))


def _map_state(dev, D, K, seed):
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 1 << 20, size=(D, K), dtype=np.int32)
              for _ in range(3)]
    planes[0] &= 1
    return mk.MapState(*(torch.as_tensor(p).to(dev) for p in planes))


def _map_clone(st):
    return mk.MapState(*(v.clone() for v in st.fields().values()))


def _map_same(st, ref, tag):
    for k in mk.PLANES:
        assert torch.equal(getattr(st, k), getattr(ref, k)), (tag, k)


def _map_planes(rng, D, O, K, kinds):
    kind = rng.choice(kinds, size=(D, O)).astype(np.int32)
    a0 = rng.integers(-1, K + 1, size=(D, O), dtype=np.int32)
    a1 = rng.integers(0, 1 << 30, size=(D, O), dtype=np.int32)
    seq = rng.integers(-2**31, 2**31 - 1, size=(D, O), dtype=np.int64) \
        .astype(np.int32)
    return kind, a0, a1, seq


@pytest.mark.parametrize("K,O", [(37, 64), (256, 64), (64, 1), (8, 300),
                                 (200, 1000)])
@pytest.mark.parametrize("kinds", ["mixed", "clears", "noop", "last_clear"])
def test_map_kernel_dense_matches_plain(cuda, K, O, kinds):
    D = 53
    rng = np.random.default_rng(K + O)
    mix = {"mixed": [SET, SET, DEL, CLR, NOOP, 0, 99],
           "clears": [CLR], "noop": [NOOP],
           "last_clear": [SET, SET, DEL]}[kinds]
    st = _map_state(cuda, D, K, O)
    ref = _map_clone(st)
    for b in range(3):
        planes = _map_planes(rng, D, O, K, mix)
        if kinds == "last_clear":
            planes[0][:, -1] = CLR
        ops = [torch.as_tensor(p).to(cuda) for p in planes]
        before = mak.launches
        mk.apply_map_batch_fused(st, *ops)
        assert mak.launches == before + 1
        ref = mk.apply_map_batch(ref, *ops)
        torch.cuda.synchronize()
        _map_same(st, ref, (kinds, b))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("R,O", [(1, 1), (37, 13), (200, 64), (5, 700)])
def test_map_kernel_packed_scatter_matches_plain(cuda, wide, R, O):
    D, K = 256, 64
    rng = np.random.default_rng(R * O + wide)
    kind = rng.choice([SET, SET, DEL, CLR, NOOP], size=(R, O)).astype(
        np.int32)
    a0 = rng.integers(0, K, size=(R, O), dtype=np.int32)
    a1 = rng.integers(0, (1 << 24) if wide else (1 << 16), size=(R, O),
                      dtype=np.int32)
    base = rng.integers(0, 1 << 30, size=R, dtype=np.int32)
    rows = rng.permutation(D)[:R].astype(np.int32)   # permuted order
    buf, wide_vals = mk.pack_map_batch(kind, a0, a1, base, rows)
    assert wide_vals == wide
    st = _map_state(cuda, D, K, 1)
    before = _map_clone(st)
    b = torch.as_tensor(buf).to(cuda)
    mk.map_columnar_apply_fused(st, b, R, O, wide)
    ref = mk.map_columnar_apply(before, b, R, O, wide)
    torch.cuda.synchronize()
    _map_same(st, ref, "scatter")
    untouched = torch.ones(D, dtype=torch.bool, device=cuda)
    untouched[torch.as_tensor(rows).long().to(cuda)] = False
    for k in mk.PLANES:   # rows outside the batch are byte-identical
        assert torch.equal(getattr(st, k)[untouched],
                           getattr(before, k)[untouched])


def test_map_kernel_packed_all_rows_matches_plain(cuda):
    D, K, O = 1024, 64, 64
    st = mk.MapState.create(D, K, cuda)
    ref = _map_clone(st)
    rows = np.arange(D, dtype=np.int32)
    rng = np.random.default_rng(2)
    for b in range(3):
        kind = rng.choice([SET, SET, DEL, CLR, NOOP], size=(D, O)).astype(
            np.int32)
        a0 = rng.integers(0, K, size=(D, O), dtype=np.int32)
        a1 = rng.integers(0, 1 << 16, size=(D, O), dtype=np.int32)
        base = np.full(D, 1 + b * O, np.int32)
        buf = torch.as_tensor(mk.pack_map_batch(kind, a0, a1, base,
                                                rows)[0]).to(cuda)
        mk.map_columnar_apply_fused(st, buf, D, O, False)
        ref = mk.map_columnar_apply(ref, buf, D, O, False)
        torch.cuda.synchronize()
        _map_same(st, ref, b)


def test_map_kernel_refused_launch_raises(cuda):
    """30,000 key slots need 240,000 B of shared memory, past the 227 KB a
    block may use: the launch is refused and the wrapper raises."""
    st = mk.MapState.create(1, 30_000, cuda)
    ops = [torch.full((1, 8), v, dtype=torch.int32, device=cuda)
           for v in (SET, 0, 5, 1)]
    before = mak.launches
    with pytest.raises(RuntimeError, match="map_apply launch failed"):
        mk.apply_map_batch_fused(st, *ops)
    assert mak.launches == before


def test_map_kernel_warp_block_boundary(cuda):
    """K = 256 is the widest state a row runs on one warp, 257 the
    narrowest that takes the block path; both equal the plain version."""
    assert mak.warp_keys() == 256
    for K in (256, 257):
        D, O = 40, 96
        rng = np.random.default_rng(K)
        st = _map_state(cuda, D, K, 3)
        ref = _map_clone(st)
        for b in range(2):
            ops = [torch.as_tensor(p).to(cuda) for p in _map_planes(
                rng, D, O, K, [SET, SET, DEL, CLR, NOOP])]
            mk.apply_map_batch_fused(st, *ops)
            ref = mk.apply_map_batch(ref, *ops)
            torch.cuda.synchronize()
            _map_same(st, ref, (K, b))


def _map_edge(case, rng, R, O, K):
    """(kind, key, value) (R, O) int32 planes for one edge of the warp
    path; keys stay in the u8 range of the packed wire."""
    kind = rng.choice([SET, DEL], size=(R, O)).astype(np.int32)
    key = rng.integers(0, K, size=(R, O), dtype=np.int32)
    value = rng.integers(0, 1 << 16, size=(R, O), dtype=np.int32)
    j = np.arange(O)
    if case == "repeats":   # a few keys, repeated in and across chunks
        key = rng.integers(0, 3, size=(R, O), dtype=np.int32)
    elif case in ("set_then_delete", "delete_then_set"):
        first, second = (SET, DEL) if case == "set_then_delete" \
            else (DEL, SET)
        kind[:, 0::2], kind[:, 1::2] = first, second
        key[:, 1::2] = key[:, 0:O - O % 2:2]   # each pair shares a key
    elif case == "clear_last":
        kind[:, -1] = CLR
    elif case == "clear_then_set":
        kind[:, (j % 32) == 5] = CLR   # the chunk's clear, then its sets
        kind[:, (j % 32) == 6] = SET
        key[:, (j % 32) == 6] = key[:, (j % 32) == 4] if O > 6 else 0
    elif case == "out_of_range":   # keys past K, kinds outside the three
        key = rng.integers(0, 256, size=(R, O), dtype=np.int32)
        kind = rng.choice([SET, DEL, CLR, NOOP, 0, 7, 99, 200],
                          size=(R, O)).astype(np.int32)
    return kind, key, value


MAP_EDGES = ("repeats", "set_then_delete", "delete_then_set", "clear_last",
             "clear_then_set", "out_of_range")


@pytest.mark.parametrize("case", MAP_EDGES)
@pytest.mark.parametrize("O", [1, 33, 700])
@pytest.mark.parametrize("wire", ["dense", "packed u16", "packed i32"])
def test_map_kernel_warp_path_edges(cuda, case, O, wire):
    """Each edge of the warp path's reduction (the last op on a key in and
    across 32-op chunks, a set and a delete of one key in one chunk, a
    clear as the last op and a clear followed by sets, ignored keys and
    kinds) at O = 1, 33 and 700, dense and packed (u16 and i32 values, rows
    permuted): equal to the plain version, and the rows a scatter batch
    does not carry byte-identical."""
    D, K = 96, 64
    R = D if wire == "dense" else 40
    rng = np.random.default_rng(MAP_EDGES.index(case) * 1000 + O)
    kind, key, value = _map_edge(case, rng, R, O, K)
    st = _map_state(cuda, D, K, O)
    before = _map_clone(st)
    launches = mak.launches
    if wire == "dense":
        seq = rng.integers(-2**31, 2**31 - 1, size=(R, O),
                           dtype=np.int64).astype(np.int32)
        ops = [torch.as_tensor(p).to(cuda) for p in (kind, key, value, seq)]
        mk.apply_map_batch_fused(st, *ops)
        ref = mk.apply_map_batch(before, *ops)
        rows = np.arange(D)
    else:
        wide = wire == "packed i32"
        if wide:
            value = value + (1 << 20)
        rows = rng.permutation(D)[:R].astype(np.int32)
        base = rng.integers(-2**31, 2**31 - 1, size=R,
                            dtype=np.int64).astype(np.int32)
        buf, wide_vals = mk.pack_map_batch(kind, key, value, base, rows)
        assert wide_vals == wide
        b = torch.as_tensor(buf).to(cuda)
        mk.map_columnar_apply_fused(st, b, R, O, wide)
        ref = mk.map_columnar_apply(before, b, R, O, wide)
    assert mak.launches == launches + 1
    torch.cuda.synchronize()
    _map_same(st, ref, (case, O, wire))
    untouched = torch.ones(D, dtype=torch.bool, device=cuda)
    untouched[torch.as_tensor(rows).long().to(cuda)] = False
    for k in mk.PLANES:
        assert torch.equal(getattr(st, k)[untouched],
                           getattr(before, k)[untouched])


def test_map_kernel_captured_in_a_cuda_graph(cuda):
    """A dense and a packed launch captured in one CUDA graph and replayed
    on a fresh state: the planes equal the plain version's."""
    D, K, O = 256, 64, 64
    rng = np.random.default_rng(4)
    dense = [torch.as_tensor(p).to(cuda) for p in _map_planes(
        rng, D, O, K, [SET, SET, DEL, CLR, NOOP])]
    kind, key, value = _map_edge("repeats", rng, D, O, K)
    rows = rng.permutation(D).astype(np.int32)
    buf = torch.as_tensor(mk.pack_map_batch(
        kind, key, value, np.arange(D, dtype=np.int32) * O, rows)[0]).to(
            cuda)
    st = _map_state(cuda, D, K, 9)
    start = _map_clone(st)
    mk.apply_map_batch_fused(st, *dense)   # warm-up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        mk.apply_map_batch_fused(st, *dense)
        mk.map_columnar_apply_fused(st, buf, D, O, False)
    for k, v in st.fields().items():
        v.copy_(getattr(start, k))
    g.replay()
    ref = mk.map_columnar_apply(mk.apply_map_batch(start, *dense), buf, D,
                                O, False)
    torch.cuda.synchronize()
    _map_same(st, ref, "graph")


def test_map_engine_on_card_matches_cpu(cuda):
    from fluidframework_tpu_torch.server.serving import MapServingEngine
    from fluidframework_tpu_torch.testing.synthetic import map_serving_batch
    R, O = 32, 16
    engines = [MapServingEngine(n_docs=R, n_keys=16, batch_window=40,
                                sequencer="native", device=dev)
               for dev in (cuda, "cpu")]
    docs = [f"m{i}" for i in range(R)]
    for e in engines:
        for d in docs:
            e.connect(d, 1)
        rows = np.array([e.doc_row(d) for d in docs], np.int32)
        for b in range(3):
            kind, kidx, keys, vidx, values = map_serving_batch(
                R, O, b, n_keys=16)
            cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                           dtype=np.int32), (R, O))
            res = e.ingest_planes(rows, np.ones((R, O), np.int32), cs,
                                  np.zeros((R, O), np.int32), kind, kidx,
                                  keys, values, vidx)
            assert res["nacked"] == 0
        for i in range(100):   # the per-op route, with clears
            d = docs[i % 7]
            c = {"op": "clear"} if i % 13 == 0 else \
                {"op": "set", "key": f"k{i % 5}", "value": [i]}
            _, nack = e.submit(d, 1, 3 * O + 1 + i // 7, 0, c)
            assert nack is None
    for d in docs:
        assert engines[0].read_doc(d) == engines[1].read_doc(d), d
    assert np.array_equal(engines[0].store.digests(),
                          engines[1].store.digests())


# ------------------------------------------ cell merge kernel (cell_merge.cu)

def _cells_sorted_invariant(st):
    """Live keys strictly ascending, EMPTY after ``count``, zero tail."""
    n = int(st.count)
    k = st.key.cpu().numpy()
    assert (np.diff(k[:n].astype(np.int64)) > 0).all()
    assert (k[n:] == int(mx.EMPTY_KEY)).all()


def _cells_same(st, ref, L):
    for k in mx.PLANES + ("count", "overflow"):
        assert torch.equal(getattr(st, k), getattr(ref, k)), (L, k)


def _cell_batch(rng, O, n_keys, seq0, pad=0.0):
    key = rng.integers(0, n_keys, O).astype(np.int32)
    key[rng.random(O) < pad] = int(mx.EMPTY_KEY)
    seq = np.arange(seq0, seq0 + O, dtype=np.int32)
    val = rng.integers(1, 1 << 30, O, dtype=np.int32)
    return key, seq, val


def _cell_chain(dev, T, L, O, n_keys, fww, batches=3, pad=0.1, seed=0):
    rng = np.random.default_rng(seed)
    st = mx.MatrixCellState.create(T, dev)
    ref = mx.MatrixCellState.create(T, dev)
    seq0 = 1
    for _ in range(batches):
        b = [torch.as_tensor(x).to(dev)
             for x in _cell_batch(rng, O, n_keys, seq0, pad)]
        seq0 += O
        before = cmk.launches
        mx.merge_cells_fused(st, *b, L=L, fww=fww)
        assert cmk.launches == before + 1
        ref = mx.merge_cells(ref, *b, L, fww)
        torch.cuda.synchronize()
        _cells_same(st, ref, L)
        if not int(st.overflow):
            _cells_sorted_invariant(st)
    return st


@pytest.mark.parametrize("O", [1, 4096, 4097, 65536])
@pytest.mark.parametrize("L", [None, 1 << 17])
@pytest.mark.parametrize("fww", [False, True])
def test_cell_kernel_matches_plain(cuda, O, L, fww):
    _cell_chain(cuda, 1 << 18, L, O, n_keys=100_000, fww=fww,
                seed=O + bool(L))


@pytest.mark.parametrize("L", [None, 64])
def test_cell_kernel_duplicates_and_pads(cuda, L):
    """Many writes per key inside one batch, and a batch of pads only."""
    st = _cell_chain(cuda, 256, L, 1000, n_keys=40, fww=False, pad=0.3)
    ref = mx.MatrixCellState(**{k: v.clone() for k, v in
                                st.fields().items()})
    pads = [torch.full((513,), int(mx.EMPTY_KEY), dtype=torch.int32,
                       device=cuda)] + \
        [torch.zeros(513, dtype=torch.int32, device=cuda)] * 2
    mx.merge_cells_fused(st, *pads, L=L)
    torch.cuda.synchronize()
    _cells_same(st, ref, L)


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("L", [None, 256])
def test_cell_kernel_live_at_the_edge(cuda, extra, L):
    """Live exactly Lt, then Lt + 1 (the sticky overflow), in both modes."""
    T = 256 if L is None else 1024
    Lt = T if L is None else L
    n = Lt + extra
    st = mx.MatrixCellState.create(T, cuda)
    ref = mx.MatrixCellState.create(T, cuda)
    for part in (slice(0, n // 2), slice(n // 2, n), slice(0, 0)):
        keys = np.arange(n, dtype=np.int32)[::-1][part].copy()
        b = [torch.as_tensor(x).to(cuda) for x in
             (keys, np.arange(1, len(keys) + 1, dtype=np.int32) + n,
              keys * 3)]
        mx.merge_cells_fused(st, *b, L=L)
        ref = mx.merge_cells(ref, *b, L, False)
        torch.cuda.synchronize()
        _cells_same(st, ref, L)
    assert int(st.overflow) == extra
    assert int(st.count) == Lt   # after the empty batch: the kept cells


@pytest.mark.parametrize("L", [None, 1 << 19])
def test_cell_kernel_replayed_in_a_cuda_graph(cuda, L):
    """Merges captured in one CUDA graph (each restoring its input state
    first, as the smoke run's timing does), replayed, and eager merges
    queued back to back without a sync, at config #3 widths: every result
    equals the plain merge of the same input."""
    T, O = (1 << 20) + (1 << 16), 65536 if L is None else 4096
    rng = np.random.default_rng(5)
    st0 = mx.MatrixCellState.create(T, cuda)
    for seq0 in (1, 1 + O):   # a table with live cells to merge into
        b = [torch.as_tensor(x).to(cuda)
             for x in _cell_batch(rng, O, 1 << 18, seq0, pad=0.05)]
        mx.merge_cells_fused(st0, *b, L=L)
    b = [torch.as_tensor(x).to(cuda)
         for x in _cell_batch(rng, O, 1 << 18, 1 + 2 * O, pad=0.05)]
    want = mx.merge_cells(st0, *b, L, False)
    work = mx.MatrixCellState(**{k: v.clone() for k, v in
                                 st0.fields().items()})

    def run():
        for name, t in work.fields().items():
            t.copy_(getattr(st0, name))
        mx.merge_cells_fused(work, *b, L=L)

    run()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(10):
            run()
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        _cells_same(work, want, L)
    outs = []
    for _ in range(8):   # eager, scratch blocks reused on one stream
        run()
        outs.append(mx.MatrixCellState(**{k: v.clone() for k, v in
                                          work.fields().items()}))
    torch.cuda.synchronize()
    for out in outs:
        _cells_same(out, want, L)
    _cells_sorted_invariant(work)


def test_cell_store_on_card_matches_cpu(cuda):
    from fluidframework_tpu_torch.testing.synthetic import cell_records
    stores = [mx.TensorMatrixStore(capacity=4096, batch_size=256,
                                   device=dev) for dev in (cuda, "cpu")]
    recs = cell_records(3, 6000, n_rows=64, n_cols=40)
    for s in stores:
        s.apply_batch_columnar([r for r, _, _, _ in recs],
                               [c for _, c, _, _ in recs],
                               [int(v[1:]) for _, _, v, _ in recs],
                               [q for _, _, _, q in recs])
        s.switch_set_cell_policy()
        s.apply_batch(cell_records(4, 500, n_rows=80, n_cols=40,
                                   seq0=7000))
    snaps = [s.snapshot() for s in stores]
    for k in ("key", "seq", "value"):
        assert np.array_equal(snaps[0][k], snaps[1][k]), k
    assert stores[0].read_cells() == stores[1].read_cells()
    assert stores[0].digest() == stores[1].digest()
    for cell in list(stores[1]._cell_ids)[:50:7]:
        assert stores[0].read_cell(cell) == stores[1].read_cell(cell)


def test_cell_kernel_chained_stress(cuda):
    """Chained full and prefix merges fed as the store feeds them, and
    merges repeated eagerly and in a CUDA graph without restoring the
    input: every one equals the plain merge of the same input
    (``testing/cell_merge_stress.py`` at a reduced grid)."""
    from fluidframework_tpu_torch.testing import cell_merge_stress as cs
    res = cs.run("cuda", seeds=2, grid=256, ops=8192, batches=4,
                 store_batch=1024, repeats=3)
    assert res["mismatches"] == 0, res["first_mismatches"]
    assert res["kernel_launches"] > 0


def _cell_case(dev, T, L, table, batch, fww, count=None):
    """One merge of ``batch`` (key, seq, value numpy arrays) into a table
    holding the sorted (key, seq, value) rows ``table`` at its head: the
    kernel against the plain version on the same input, all planes."""
    st = mx.MatrixCellState.create(T, dev)
    k, q, v = (np.asarray(x, np.int32) for x in table)
    n = len(k)
    st.key[:n] = torch.as_tensor(k).to(dev)
    st.seq[:n] = torch.as_tensor(q).to(dev)
    st.value[:n] = torch.as_tensor(v).to(dev)
    st.count.fill_(n if count is None else count)
    b = [torch.as_tensor(np.ascontiguousarray(x, np.int32)).to(dev)
         for x in batch]
    want = mx.merge_cells(st, *b, L, fww)
    mx.merge_cells_fused(st, *b, L=L, fww=fww)
    torch.cuda.synchronize()
    _cells_same(st, want, L)
    if not int(st.overflow):
        _cells_sorted_invariant(st)
    return st


def _table(keys, seq0=1):
    keys = np.asarray(keys, np.int32)
    return keys, np.arange(seq0, seq0 + len(keys), dtype=np.int32), keys * 7


@pytest.mark.parametrize("fww", [False, True])
@pytest.mark.parametrize("L", [None, 1 << 14])
def test_cell_kernel_runs_straddle_slice_boundaries(cuda, fww, L):
    """Key runs (a table cell and many batch writes to it) that cross the
    2,048-position merge-path tiles, new keys between them, and one key
    written 5,000 times (a run across three tiles), LWW and FWW."""
    rng = np.random.default_rng(3)
    table = _table(np.arange(0, 8000, 2))           # 4,000 live cells
    hot = np.repeat(np.array([1000, 1001, 2046, 3000], np.int32), 700)
    many = np.full(5000, 4002, np.int32)
    fresh = rng.integers(0, 8000, 2000).astype(np.int32)
    key = np.concatenate([hot, many, fresh])
    key = key[rng.permutation(len(key))]
    seq = np.arange(10_000, 10_000 + len(key), dtype=np.int32)
    val = rng.integers(1, 1 << 30, len(key), dtype=np.int32)
    _cell_case(cuda, 1 << 15, L, table, (key, seq, val), fww)
    # a table cell newer than every write to its key (full mode keeps it)
    old = table[0], table[1] + 100_000, table[2]
    _cell_case(cuda, 1 << 15, L, old, (key, seq, val), fww)


@pytest.mark.parametrize("L", [None, 4096])
@pytest.mark.parametrize("O", [1, 10_000])
def test_cell_kernel_batch_sizes_against_the_live_extent(cuda, L, O):
    """O = 1, and O far past the live extent (10 cells), LWW and FWW."""
    rng = np.random.default_rng(O)
    table = _table(np.arange(5, 55, 5))
    key = rng.integers(0, 4000, O).astype(np.int32)
    seq = np.arange(100, 100 + O, dtype=np.int32)
    for fww in (False, True):
        _cell_case(cuda, 8192, L, table, (key, seq, key + 1), fww)


@pytest.mark.parametrize("fww", [False, True])
@pytest.mark.parametrize("L", [None, 2048])
def test_cell_kernel_all_empty_batch_and_empty_table(cuda, fww, L):
    """An all-EMPTY batch into a live table and into an empty one
    (count 0), and an empty batch (O = 0)."""
    pads = (np.full(3000, int(mx.EMPTY_KEY), np.int32),
            np.arange(3000, dtype=np.int32), np.ones(3000, np.int32))
    table = _table(np.arange(0, 3000, 3))
    _cell_case(cuda, 4096, L, table, pads, fww)
    _cell_case(cuda, 4096, L, ([], [], []), pads, fww)
    st = _cell_case(cuda, 4096, L, ([], [], []),
                    _table(np.arange(7, 700, 7), 50), fww)
    assert int(st.count) == 99
    none = [np.zeros(0, np.int32)] * 3
    _cell_case(cuda, 4096, L, table, none, fww)


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("L", [None, 4096])
def test_cell_kernel_live_at_the_edge_across_tiles(cuda, extra, L):
    """Live exactly Lt and Lt + 1 with Lt spanning several merge tiles:
    half the cells in the table, the other half new in one batch."""
    T = 4096 if L is None else 8192
    Lt = T if L is None else L
    n = Lt + extra
    keys = np.arange(n, dtype=np.int32) * 3
    table = _table(keys[0::2])
    new = keys[1::2][::-1].copy()
    st = _cell_case(cuda, T, L, table,
                    (new, np.arange(1, len(new) + 1, dtype=np.int32) + n,
                     new + 5), False)
    assert int(st.overflow) == extra and int(st.count) == min(n, T)


def test_cell_kernel_live_extent_shrinks(cuda):
    """An overflowed prefix merge leaves count past the cells the prefix
    holds; the next merge at a larger L reads that extent (EMPTY past the
    stored cells) and leaves fewer live cells than the count it read."""
    T, L = 8192, 1024
    keys = np.arange(1200, dtype=np.int32)
    st = mx.MatrixCellState.create(T, cuda)
    ref = mx.MatrixCellState.create(T, cuda)
    for key, Lm in ((keys, L), (keys[:10], 2048)):
        b = [torch.as_tensor(x).to(cuda) for x in
             (key, np.arange(1, len(key) + 1, dtype=np.int32), key * 2)]
        count_in = int(st.count)
        mx.merge_cells_fused(st, *b, L=Lm)
        ref = mx.merge_cells(ref, *b, Lm, False)
        torch.cuda.synchronize()
        _cells_same(st, ref, Lm)
    assert count_in == 1200 and int(st.count) == L and int(st.overflow)


def test_cell_scratch_sizing_matches_the_library(cuda):
    lib = cmk._load()
    for Lt, O in ((1, 0), (8, 1), (2047, 1), (2048, 1), (1 << 19, 4096),
                  (1 << 19, 4097), ((1 << 20) + (1 << 16), 1 << 16),
                  (100, 70_000)):
        assert cmk.scratch_words(Lt, O) == \
            lib.cell_merge_scratch_words(Lt, O), (Lt, O)
        assert cmk.tiles(Lt, O) == lib.cell_merge_tiles(Lt, O), (Lt, O)


# ------------------------------------------- permutation axes (K3 and K4)

def _axis_same(st, ref, tag):
    for k in mt.FIELDS:   # every plane, slots past count included
        assert torch.equal(getattr(st, k), getattr(ref, k)), (tag, k)


def _axis_step(st, ref, ops):
    """One window through K3 (in place) and the plain version."""
    from fluidframework_tpu_torch.ops import axis_apply as axk
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    before = axk.apply_launches
    run, off = ak.apply_axis_batch_fused(st, *ops)
    assert axk.apply_launches == before + 1
    ref, rr, ro = ak.apply_axis_batch(ref, *ops)
    torch.cuda.synchronize()
    assert torch.equal(run, rr) and torch.equal(off, ro)
    return ref


def _axis_chain(dev, D, S, O, seed, n_batches=3, noop_tail=0,
                mix=(0.4, 0.2, 0.3, 0.1)):
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    from fluidframework_tpu_torch.testing.synthetic import axis_window
    rng = np.random.default_rng(seed)
    st = mt.StringState.create(D, S, n_props=1, device=dev)
    ref = _clone(st)
    seq = 1
    for b in range(n_batches):
        lengths = ak.axis_visible_lengths(ref).cpu().numpy()
        planes, seq = axis_window(rng, lengths, O, seq, mix=mix)
        if noop_tail:
            planes["kind"][:, -noop_tail:] = int(OpKind.NOOP)
        ref = _axis_step(st, ref, [torch.as_tensor(planes[k]).to(dev)
                                   for k in mt.OP_FIELDS])
        _axis_same(st, ref, b)
    return st


@pytest.mark.parametrize("S", [32, 33, 128, 1024, 8192])
def test_axis_apply_matches_plain(cuda, S):
    """Random windows from 4 clients with stale ref_seqs and client -1
    reads, a NOOP tail; S=32 / 33 overflow (sticky)."""
    st = _axis_chain(cuda, 16, S, 96, seed=S, noop_tail=7)
    if S <= 33:
        assert int(st.overflow.sum()) > 0


def test_axis_apply_deep_rows_at_the_limit(cuda):
    """Rows of thousands of live slots at S = 8,192, the kernel's limit:
    every pass runs many slots per thread and the roll many tiles."""
    st = _axis_chain(cuda, 4, 8192, 512, seed=5, n_batches=6,
                     mix=(0.7, 0.1, 0.15, 0.05))
    assert int(st.count.min()) > 1000


def _axis_planes(rows, O):
    planes = {k: np.zeros((len(rows), O), np.int32) for k in mt.OP_FIELDS}
    planes["kind"][:] = int(OpKind.NOOP)
    for d, ops in enumerate(rows):
        for o, op in enumerate(ops):
            for k, v in zip(mt.OP_FIELDS, op):
                planes[k][d, o] = v
    return planes


@pytest.mark.parametrize("S", [32, 33])
def test_axis_apply_count_reaches_s_and_one_past(cuda, S):
    """Row 0: boundary inserts until count == S, then one more (overflow).
    Row 1: count == S - 1, then an insert inside a run (needs 2 slots:
    overflow). Row 2: count == S - 1 and a remove whose second split
    overflows (the first split and the marking stay). Row 3: a remove
    spanning splits with room."""
    ins = int(OpKind.STR_INSERT)
    rem = int(OpKind.STR_REMOVE)
    rows = [[(ins, 0, 1, 100 + i, 1 + i, 0, i) for i in range(S + 1)],
            [(ins, 0, 2, 100 + i, 1 + i, 0, i) for i in range(S - 1)]
            + [(ins, 1, 1, 999, S, 0, S - 1)],
            [(ins, 0, 3, 100 + i, 1 + i, 0, i) for i in range(S - 1)]
            + [(rem, 1, 5, 0, S, 1, S - 1)],
            [(ins, 0, 4, 100 + i, 1 + i, 0, i) for i in range(4)]
            + [(rem, 2, 13, 0, 5, 1, 4),
               (int(OpKind.AXIS_RESOLVE), 2, 0, 0, 6, -1, 1 << 30)]]
    planes = _axis_planes(rows, S + 1)
    st = mt.StringState.create(4, S, n_props=1, device=cuda)
    ref = _axis_step(st, _clone(st), [torch.as_tensor(planes[k]).to(cuda)
                                      for k in mt.OP_FIELDS])
    _axis_same(st, ref, "edges")
    assert st.count.tolist()[:2] == [S, S - 1]
    assert st.overflow.tolist() == [1, 1, 1, 0]


def test_axis_apply_input_tail_not_fill(cuda):
    """After the plain compaction the tail past count holds the dropped
    slots (not fill): the kernel's live extent must cover them."""
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    from fluidframework_tpu_torch.testing.synthetic import axis_window
    st = _axis_chain(cuda, 16, 128, 64, seed=3, n_batches=2,
                     mix=(0.4, 0.4, 0.1, 0.1))
    st = mt.compact_string_state(st, torch.full((16,), 100, dtype=torch.int32,
                                                device=cuda), False)
    past = torch.arange(128, device=cuda)[None, :] >= st.count[:, None]
    assert bool(((st.removed_seq != mt.NOT_REMOVED) & past).any())
    ref = _clone(st)
    rng = np.random.default_rng(4)
    planes, _ = axis_window(rng, ak.axis_visible_lengths(st).cpu().numpy(),
                            64, 200)
    ref = _axis_step(st, ref, [torch.as_tensor(planes[k]).to(cuda)
                               for k in mt.OP_FIELDS])
    _axis_same(st, ref, "tail")


@pytest.mark.parametrize("D,O", [(16, 1), (16, 77), (2, 65536)])
def test_axis_resolve_matches_plain(cuda, D, O):
    """K4 at O = 1, a non-multiple of its 64-op tile, and config #3's
    65,536 resolves on 2 rows; NOOP slots give -1."""
    from fluidframework_tpu_torch.ops import axis_apply as axk
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    st = _axis_chain(cuda, D, 1024, 128, seed=O, n_batches=2,
                     mix=(0.6, 0.15, 0.2, 0.05))
    rng = np.random.default_rng(O)
    lengths = ak.axis_visible_lengths(st).cpu().numpy()
    pos = (rng.random((D, O)) * (lengths[:, None] + 3)).astype(np.int32)
    client = rng.integers(-1, 4, size=(D, O)).astype(np.int32)
    ref = rng.integers(0, 300, size=(D, O)).astype(np.int32)
    ref[client < 0] = 1 << 30
    kind = np.where(rng.random((D, O)) < 0.9, int(OpKind.AXIS_RESOLVE),
                    int(OpKind.NOOP)).astype(np.int32)
    t = [torch.as_tensor(x).to(cuda) for x in (kind, pos, client, ref)]
    before = axk.resolve_launches
    run, off = ak.resolve_axis_fused(st, *t)
    assert axk.resolve_launches == before + 1
    rr, ro = ak.resolve_axis_positions(st, *t[1:])
    res = t[0] == int(OpKind.AXIS_RESOLVE)
    torch.cuda.synchronize()
    assert torch.equal(run, torch.where(res, rr, -1))
    assert torch.equal(off, torch.where(res, ro, -1))
    assert bool((run >= 0).any())


def test_axis_kernels_refuse_past_the_limit(cuda):
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    st = mt.StringState.create(2, 8193, n_props=1, device=cuda)
    ops = [torch.zeros((2, 4), dtype=torch.int32, device=cuda)
           for _ in range(7)]
    with pytest.raises(ValueError, match="8192"):
        ak.apply_axis_batch_fused(st, *ops)
    with pytest.raises(ValueError, match="8192"):
        ak.resolve_axis_fused(st, ops[0], ops[1], ops[5], ops[6])


def test_axis_capacity_refused_at_construction(cuda):
    """A capacity past the kernels' limit is refused when the store or
    the engine is built, before any op can be acked and logged."""
    from fluidframework_tpu_torch.ops import axis_apply
    from fluidframework_tpu_torch.ops.axis_kernel import TensorAxisStore
    from fluidframework_tpu_torch.server.serving import MatrixServingEngine
    assert axis_apply.max_slots() == 8192
    with pytest.raises(ValueError, match="8192"):
        TensorAxisStore(2, 8193, device=cuda)
    with pytest.raises(ValueError, match="8192"):
        MatrixServingEngine(n_docs=2, axis_capacity=8193, device=cuda)
    snap = TensorAxisStore(2, 8193, device="cpu").snapshot()
    with pytest.raises(ValueError, match="8192"):
        TensorAxisStore.restore(snap, device=cuda)
    TensorAxisStore(2, 8192, device=cuda)


# K3's warp path and K4's settled search: the edges of both designs. The
# limits mirror kWarpSlots and kUnsettledMax of csrc/axis_apply.cu.
AXIS_WARP_SLOTS, AXIS_UNSETTLED_MAX = 256, 128
_INT_MAX = 2 ** 31 - 1


def test_axis_path_limits_match_the_library(cuda):
    from fluidframework_tpu_torch.ops import axis_apply as axk
    lib = axk._load()
    assert lib.axis_warp_slots() == AXIS_WARP_SLOTS
    assert lib.axis_unsettled_max() == AXIS_UNSETTLED_MAX


def _k4_check(st, kind, pos, client, ref):
    """One K4 launch against the plain resolve (every output exact)."""
    from fluidframework_tpu_torch.ops import axis_apply as axk
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    t = [torch.as_tensor(np.asarray(x, np.int32)).to(st.seq.device)
         for x in (kind, pos, client, ref)]
    before = axk.resolve_launches
    run, off = ak.resolve_axis_fused(st, *t)
    assert axk.resolve_launches == before + 1
    rr, ro = ak.resolve_axis_positions(st, *t[1:])
    res = t[0] == int(OpKind.AXIS_RESOLVE)
    torch.cuda.synchronize()
    assert torch.equal(run, torch.where(res, rr, -1))
    assert torch.equal(off, torch.where(res, ro, -1))
    return run


def _span_row(rng, n, unsettled, lo=100, hi=200, zero_frac=0.2):
    """n slots of which ``unsettled`` have a visibility that differs
    across ref_seqs in [lo, hi] (inserted or removed inside the span, or
    a remover bit); the rest are visible to all (seq 1) or removed before
    lo (invisible to all). A ``zero_frac`` share has length 0."""
    seq = np.ones(n, np.int64)
    rem = np.full(n, mt.NOT_REMOVED, np.int64)
    rmv = np.zeros(n, np.int64)
    gone = rng.random(n) < 0.2
    rem[gone] = rng.integers(0, lo + 1, gone.sum())
    rmv[gone] = rng.integers(0, 16, gone.sum())
    for i in rng.permutation(n)[:unsettled]:
        rem[i], rmv[i], seq[i] = mt.NOT_REMOVED, 0, 1
        k = rng.integers(0, 4)
        if k in (0, 3):
            seq[i] = rng.integers(lo + 1, hi + 1)
        if k in (1, 3):   # removed after lo, at or before hi
            rem[i] = rng.integers(max(seq[i], lo + 1), hi + 1)
        if k == 2:
            rmv[i] = 1 << int(rng.integers(0, 4))
    length = rng.integers(1, 6, n)
    length[rng.random(n) < zero_frac] = 0
    return {"seq": seq, "client": rng.integers(0, 4, n),
            "removed_seq": rem, "removers": rmv, "length": length,
            "handle_op": rng.integers(1, 1000, n),
            "handle_off": rng.integers(0, 50, n)}


def _rows_state(rows, S, dev):
    st = mt.StringState.create(len(rows), S, n_props=1, device=dev)
    for d, r in enumerate(rows):
        n = len(r["seq"])
        for k in mt.PLANES:
            getattr(st, k)[d, :n] = torch.as_tensor(
                np.asarray(r[k], np.int32))
        st.count[d] = n
    return st


def _span_ops(rng, st, O, lo=100, hi=200):
    """(kind, pos, client, ref) of O resolves a row at ref_seqs spanning
    [lo, hi]; positions from -1 to past the visible length."""
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    D = st.seq.shape[0]
    lengths = ak.axis_visible_lengths(st).cpu().numpy()
    ref = rng.integers(lo, hi + 1, (D, O))
    ref[:, 0], ref[:, min(1, O - 1)] = lo, hi   # both in the first tile
    pos = (rng.random((D, O)) * (lengths[:, None] + 3)).astype(np.int64) - 1
    return (np.full((D, O), int(OpKind.AXIS_RESOLVE)), pos,
            rng.integers(0, 4, (D, O)), ref)


@pytest.mark.parametrize("zero_frac", [0.0, 0.5])
def test_axis_resolve_every_slot_settled(cuda, zero_frac):
    """Every slot visible or invisible to all of a tile's perspectives:
    the search is one binary search of the settled prefix; zero-length
    slots hold no position."""
    rng = np.random.default_rng(1)
    st = _rows_state([_span_row(rng, n, 0, zero_frac=zero_frac)
                      for n in (1, 7, 120, 1000)], 1024, cuda)
    run = _k4_check(st, *_span_ops(rng, st, 2500))
    assert bool((run >= 0).any())


def test_axis_resolve_every_slot_unsettled(cuda):
    """Every slot inserted or removed inside the span (the list holds the
    whole row; at 200 slots the CTA walks)."""
    rng = np.random.default_rng(2)
    st = _rows_state([_span_row(rng, n, n) for n in (30, 128, 200)], 256,
                     cuda)
    _k4_check(st, *_span_ops(rng, st, 700))


@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_axis_resolve_unsettled_at_the_threshold(cuda, extra):
    """kUnsettledMax - 1, kUnsettledMax (the search) and one past it (the
    walk), among settled rows of several lengths; the second op tile of
    each row sees one ref_seq past every seq while the first
    walks or searches: only its remover-bit slots stay unsettled."""
    rng = np.random.default_rng(3 + extra)
    u = AXIS_UNSETTLED_MAX + extra
    st = _rows_state([_span_row(rng, n, u) for n in (u, u + 50, 1000)],
                     1024, cuda)
    kind, pos, client, ref = _span_ops(rng, st, 1500)
    ref[:, 1024:] = 500   # the second tile: past every seq, one ref_seq
    _k4_check(st, kind, pos, client, ref)


def test_axis_resolve_mixed_perspectives_and_edges(cuda):
    """Latest-view reads (client -1, ref_seq 1 << 30), ref_seq = INT_MAX,
    NOOP slots, positions 0, total - 1, total, negative and INT_MAX, and a
    row with count 0; then every op at INT_MAX (a never-removed slot is
    removed_seq <= ref_seq there: invisible to all) and at one ref_seq."""
    rng = np.random.default_rng(4)
    st = _rows_state([_span_row(rng, 150, 20), _span_row(rng, 150, 0),
                      _span_row(rng, 0, 0), _span_row(rng, 60, 60)], 256,
                     cuda)
    kind, pos, client, ref = _span_ops(rng, st, 1500)
    ref[:, ::5], client[:, ::5] = 1 << 30, -1
    ref[:, 1::7] = _INT_MAX
    client[:, 2::11] = -1
    kind[:, 3::13] = int(OpKind.NOOP)
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    tot = ak.axis_visible_lengths(st).cpu().numpy()
    for d in range(4):
        pos[d, :8] = [0, tot[d] - 1, tot[d], -1, -5, _INT_MAX, tot[d] + 1,
                      1]
    _k4_check(st, kind, pos, client, ref)
    assert int(st.count[2]) == 0
    ref[:], client[:] = _INT_MAX, -1
    _k4_check(st, kind, pos, client, ref)
    ref[:], client[:] = 250, 0
    _k4_check(st, kind, pos, client, ref)


def _axis_window_rows(rng, st, m, n_res, seq0):
    """Per row: m mutations (inserts of 2 and removes of 2 alternating)
    and n_res resolves at random places, as op tuples."""
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    rows = []
    for total in ak.axis_visible_lengths(st).cpu().tolist():
        ops = []
        for i in range(m):
            if i % 2 == 0:
                ops.append((int(OpKind.STR_INSERT),
                            int(rng.integers(0, total + 1)), 2, 500 + i,
                            seq0 + i, i % 4, seq0 + i - 1))
            else:
                s0 = int(rng.integers(0, max(total - 3, 1)))
                ops.append((int(OpKind.STR_REMOVE), s0, s0 + 2, 0,
                            seq0 + i, i % 4, seq0 + i - 1))
        for j in range(n_res):
            ops.insert(int(rng.integers(0, len(ops) + 1)),
                       (int(OpKind.AXIS_RESOLVE),
                        int(rng.integers(-1, total + 3)), 0, 0, 0, j % 4,
                        seq0 + m))
        rows.append(ops)
    return rows


@pytest.mark.parametrize("S", [512, 300])
def test_axis_apply_at_the_warp_path_limit(cuda, S):
    """hi + 2 per mutation at the warp region's limit (256: the warp path)
    and one past it (the block path), one past through a slot past count
    that is not fill, and a row wider than the region."""
    m = 10
    edge = AXIS_WARP_SLOTS - 2 * m
    counts = [edge, edge + 1, 200, edge - 1, 290]
    st = mt.StringState.create(len(counts), S, n_props=1, device=cuda)
    for d, n in enumerate(counts):
        st.length[d, :n] = 1 + torch.arange(n, dtype=torch.int32) % 3
        st.handle_op[d, :n] = torch.arange(1, n + 1, dtype=torch.int32)
        st.seq[d, :n] = 1
        st.count[d] = n
    for d, i in ((2, edge), (3, edge + 4)):   # dropped slots past count
        st.removed_seq[d, i], st.length[d, i] = 5, 2
    rows = _axis_window_rows(np.random.default_rng(S), st, m, 30, 10)
    planes = _axis_planes(rows, max(map(len, rows)))
    _axis_step(st, _clone(st), [torch.as_tensor(planes[k]).to(cuda)
                                for k in mt.OP_FIELDS])
    assert int(st.overflow[:4].sum()) == 0


def test_axis_apply_warp_path_overflows(cuda):
    """S = 64 (every row on the warp path): rows at and near S overflow
    (sticky, the row left as the plain version leaves it)."""
    st = mt.StringState.create(4, 64, n_props=1, device=cuda)
    for d, n in enumerate((60, 63, 64, 10)):
        st.length[d, :n] = 2
        st.handle_op[d, :n] = torch.arange(1, n + 1, dtype=torch.int32)
        st.seq[d, :n] = 1
        st.count[d] = n
    rows = _axis_window_rows(np.random.default_rng(5), st, 12, 10, 10)
    planes = _axis_planes(rows, max(map(len, rows)))
    ref = _axis_step(st, _clone(st), [torch.as_tensor(planes[k]).to(cuda)
                                      for k in mt.OP_FIELDS])
    _axis_same(st, ref, "overflow")
    assert st.overflow.tolist() == [1, 1, 1, 0]


@pytest.mark.parametrize("S", [128, 1024])
def test_axis_apply_resolve_heavy_windows(cuda, S):
    """The per-op waves' mix (82 % resolves, 4.5 % inserts, 4.5 %
    removes, 9 % NOOPs): runs of resolves answered lane by lane between
    mutations, chained over three windows."""
    st = _axis_chain(cuda, 64, S, 128, seed=S, n_batches=3,
                     mix=(0.045, 0.045, 0.82, 0.09))
    assert int(st.count.max()) > 4


@pytest.mark.parametrize("S", [64, 600])
def test_axis_apply_removes_ending_at_or_before_start(cuda, S):
    """Removes whose end lies before, at or just after their start (both
    ends often inside one slot): the kernel finds both split slots in one
    scan and must leave what the plain version's two splits leave; S = 64
    overflows mid-remove, S = 600 runs both paths."""
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    from fluidframework_tpu_torch.testing.synthetic import axis_window
    rng = np.random.default_rng(S)
    st = mt.StringState.create(12, S, n_props=1, device=cuda)
    ref = _clone(st)
    seq = 1
    for b in range(3):
        planes, seq = axis_window(
            rng, ak.axis_visible_lengths(ref).cpu().numpy(), 80, seq,
            mix=(0.45, 0.35, 0.15, 0.05))
        near = (planes["kind"] == int(OpKind.STR_REMOVE)) & \
            (rng.random(planes["a0"].shape) < 0.5)
        planes["a1"] = np.where(
            near, planes["a0"] + rng.integers(-3, 4, planes["a0"].shape),
            planes["a1"]).astype(np.int32)
        ref = _axis_step(st, ref, [torch.as_tensor(planes[k]).to(cuda)
                                   for k in mt.OP_FIELDS])
        _axis_same(st, ref, b)


def _matrix_engines(dev, **kw):
    from fluidframework_tpu_torch.server.serving import MatrixServingEngine
    return [MatrixServingEngine(device=d, sequencer="native",
                                batch_window=10 ** 9, **kw)
            for d in (dev, "cpu")]


def _matrix_same(card, cpu, docs):
    for d in docs:
        assert card.dims(d) == cpu.dims(d)
        assert card.to_lists(d) == cpu.to_lists(d), d
    for k in mt.FIELDS:
        assert torch.equal(getattr(card.axis_store.state, k).cpu(),
                           getattr(cpu.axis_store.state, k)), k
    assert card.store.read_cells() == cpu.store.read_cells()
    assert card.store.digest() == cpu.store.digest()


def test_matrix_engine_on_card_matches_cpu(cuda):
    """Per-op concurrent waves (K3) and ingest_cells storms (K4) on the
    card against the same on the CPU, under LWW and FWW docs."""
    engines = _matrix_engines(cuda, n_docs=4, cell_capacity=1 << 14,
                              axis_capacity=128)
    docs = [f"m{i}" for i in range(4)]
    rng = np.random.default_rng(1)
    cs = {}
    seq = {}
    for d in docs:
        for c in (1, 2, 3, 4):
            for e in engines:
                seq[d] = e.connect(d, c).seq
            cs[d, c] = 0
        for c, mx in ((1, "insRow"), (2, "insCol")):
            cs[d, c] += 1
            for e in engines:
                msg, nack = e.submit(d, c, cs[d, c], seq[d], {
                    "mx": mx, "pos": 0, "count": 12, "opKey": (c, 0)})
                assert nack is None
            seq[d] = msg.seq
        if d == "m1":
            cs[d, 3] += 1
            for e in engines:
                msg, _ = e.submit(d, 3, cs[d, 3], seq[d], {"mx": "policy"})
            seq[d] = msg.seq
    refs = {k: seq[k[0]] for k in cs}
    for wave in range(2):
        for i in range(96):
            for d in docs:
                c = int(rng.integers(1, 5))
                cs[d, c] += 1
                refs[d, c] = max(refs[d, c], seq[d] - int(rng.integers(0, 9)))
                roll = rng.random()
                if roll < 0.7:
                    op = {"mx": "setCell", "row": int(rng.integers(0, 12)),
                          "col": int(rng.integers(0, 12)), "value": i}
                elif roll < 0.85:
                    op = {"mx": "insRow" if roll < 0.78 else "insCol",
                          "pos": int(rng.integers(0, 12)), "count": 1,
                          "opKey": (c, 100 * wave + i)}
                else:
                    op = {"mx": "rmRow" if roll < 0.93 else "rmCol",
                          "start": int(rng.integers(0, 10)), "count": 1}
                for e in engines:
                    msg, nack = e.submit(d, c, cs[d, c], refs[d, c], op)
                    assert nack is None, (op, nack)
                seq[d] = msg.seq
        for e in engines:
            e.flush()
        ids = [docs[i % 4] for i in range(2048)]
        cls = [1] * 2048
        cseq = []
        for d in ids:
            cs[d, 1] += 1
            cseq.append(cs[d, 1])
        rf = [seq[d] for d in ids]
        rp, cp = rng.integers(0, 10, 2048).tolist(), \
            rng.integers(0, 10, 2048).tolist()
        vals = rng.integers(0, 1 << 20, 2048).tolist()
        for e in engines:
            assert e.ingest_cells(ids, cls, cseq, rf, rp, cp,
                                  vals)["nacked"] == 0
        for d in docs:
            refs[d, 1] = seq[d]   # the native sequencer keeps the max
            seq[d] += ids.count(d)
    _matrix_same(*engines, docs)


def test_pipelined_harvest_reads_the_first_batch(cuda):
    """Two 65,536-cell batches back to back: the second call harvests the
    first while its own resolve is in flight. The first batch's cells must
    be those a CPU engine resolves, never run 0 from a host buffer read
    before its copy landed."""
    engines = _matrix_engines(cuda, n_docs=1, cell_capacity=1 << 18,
                              axis_capacity=512)
    for e in engines:
        e.connect("g", 1)
        for mx in ("insRow", "insCol"):
            e.submit("g", 1, 1 if mx == "insRow" else 2, 0,
                     {"mx": mx, "pos": 0, "count": 256,
                      "opKey": (1, 1 if mx == "insRow" else 2)})
        e.flush()
    rng = np.random.default_rng(2)
    n = 1 << 16
    batches = []
    for b in range(2):
        batches.append((["g"] * n, [1] * n,
                        list(range(3 + b * n, 3 + (b + 1) * n)), [2] * n,
                        rng.integers(0, 256, n).tolist(),
                        rng.integers(0, 256, n).tolist(),
                        rng.integers(1, 1 << 20, n).tolist()))
    for e in engines:
        for b in batches:
            assert e.ingest_cells(*b)["nacked"] == 0
        assert len(e._pending_cells) == 1   # the second is in flight
    card, cpu = engines
    cells = card.store.read_cells()   # no flush: the first batch only
    assert len(cells) > 0 and cells == cpu.store.read_cells()
    assert all(rk[1][0] != 0 and ck[0] != 0 for rk, ck in cells)
    _matrix_same(card, cpu, ["g"])


# ------------------------------------------------------------- SharedTree

def _tree_same(st, ref, tag):
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    for k in tk.TREE_PLANES + ("overflow",):
        assert torch.equal(getattr(st, k).cpu(), getattr(ref, k).cpu()), \
            (tag, k)


@pytest.mark.parametrize("N", [32, 33, 128, 1000])
def test_tree_apply_matches_plain(cuda, N):
    """K5 planes mode on every record kind (tree_record_storm), chained,
    with docs that overflow."""
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing.synthetic import tree_record_storm
    D, O = 64, 64
    st = tk.TreeState.create(D, N, device=cuda)
    ref = st.clone()
    for b in range(3):
        p = torch.from_numpy(tree_record_storm(
            D, O, seed=b, capacity=N, start_seq=1 + 1000 * b)).to(cuda)
        before = ta.apply_launches
        tk.apply_tree_planes_fused(st, p)
        assert ta.apply_launches == before + 1
        ref = tk.apply_tree_planes(ref, p)
        torch.cuda.synchronize()
        _tree_same(st, ref, b)
    assert int(st.overflow.sum()) > 0 if N <= 128 else True


def test_tree_apply_at_max_slots(cuda):
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing.synthetic import tree_record_storm
    N = ta.max_slots()
    st = tk.TreeState.create(4, N, device=cuda)
    ref = st.clone()
    for b in range(2):
        p = torch.from_numpy(tree_record_storm(
            4, 256, seed=b, capacity=64, start_seq=1 + 1000 * b)).to(cuda)
        tk.apply_tree_planes_fused(st, p)
        ref = tk.apply_tree_planes(ref, p)
        torch.cuda.synchronize()
        _tree_same(st, ref, b)


@pytest.mark.parametrize("width", ["u16", "u32"])
@pytest.mark.parametrize("O", [64, 160])
def test_tree_wire_matches_plain(cuda, width, O):
    """K6 + K5 wire mode against the plain wire apply, at both id / value
    widths and both pos widths (u8 up to o = 128, u16 past it)."""
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops.tree_store import pack_wire_records
    from fluidframework_tpu_torch.testing.synthetic import (
        tree_record_storm, tree_storm_flat,
    )
    idt = np.uint16 if width == "u16" else np.uint32
    D, N = 48, 96
    st = tk.TreeState.create(D, N, device=cuda)
    ref = st.clone()
    for b in range(2):
        p = tree_record_storm(D, O, seed=5 + b, capacity=N,
                              start_seq=1 + 1000 * b)
        recs, rec_op, rows = tree_storm_flat(p)
        cols, ids, vals, row, pos, o = pack_wire_records(
            recs, rec_op, rows, id_t=idt, val_t=idt)
        assert pos.dtype == (np.uint8 if O <= 128 else np.uint16)
        m = np.arange(int(recs.max()) + 2, dtype=np.int32)
        base = np.full(D, 1 + 1000 * b, np.int32)
        dev = [torch.from_numpy(x).to(cuda) for x in (
            cols, ids, vals, row, pos, base, m, m, m, m)]
        want = tk.expand_tree_wire(*dev[:5], *dev[6:], n_docs=D, o=o)
        e0 = ta.expand_launches
        got = tk.expand_tree_wire_fused(*dev[:5], *dev[6:], n_docs=D, o=o)
        assert ta.expand_launches == e0 + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        tk.apply_tree_wire_fused(st, *dev, o=o)
        ref = tk.apply_tree_wire(ref, *dev, o=o)
        torch.cuda.synchronize()
        _tree_same(st, ref, b)


def _expand_wire(dev, R, D, o, widths, seed, pad=0.1):
    """A random wire of R records on unique (row, pos) cells (a share
    ``pad`` of them padding: pos >= o or row >= D) with ids and values past
    their maps' ends; ``widths`` = (ids, values, pos) numpy dtypes."""
    idt, valt, post = widths
    rng = np.random.default_rng(seed)
    cells = rng.permutation(D * o)[:R]
    row = (cells // o).astype(np.uint16)
    pos = (cells % o).astype(post)
    drop = rng.random(R) < pad
    pos[drop & (rng.random(R) < 0.5)] = o + rng.integers(0, 2)
    row[drop & (pos < o)] = D + 5
    maps = [torch.as_tensor(rng.integers(-9, 1 << 30, size=n)
                            .astype(np.int32)).to(dev)
            for n in (300, 20, 12, 200)]
    wire = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        rng.integers(0, 256, size=(R, 3)).astype(np.uint8),
        rng.integers(0, 330, size=(R, 3)).astype(idt),
        rng.integers(0, 230, size=R).astype(valt), row, pos)]
    return wire, maps


def _expand_dirty(dev, D, o):
    """Leave a freed block of the (9, D, o) buffer's size full of -1 in the
    caching allocator, where the next allocation of that size lands."""
    junk = torch.full((9, D, o), -1, dtype=torch.int32, device=dev)
    del junk


_W16, _W32 = np.uint16, np.uint32


@pytest.mark.parametrize("R,D,o,widths", [
    (1000, 300, 4, (_W16, _W16, np.uint8)),
    (1000, 300, 4, (_W16, _W32, np.uint8)),
    (1000, 300, 4, (_W32, _W16, np.uint8)),
    (1000, 300, 4, (_W32, _W32, np.uint8)),
    (1000, 40, 160, (_W16, _W16, np.uint16)),
    (1000, 40, 160, (_W16, _W32, np.uint16)),
    (1000, 40, 160, (_W32, _W16, np.uint16)),
    (1000, 40, 160, (_W32, _W32, np.uint16)),
    (0, 64, 4, (_W16, _W16, np.uint8)),        # R = 0: all zeros
    (257, 8192, 4, (_W16, _W16, np.uint8)),    # most docs get no record
    (24576, 8192, 4, (_W16, _W16, np.uint8)),  # the serving wave's R
    (200_000, 8192, 64, (_W32, _W32, np.uint8)),  # grid-stride records
])
def test_tree_expand_matches_plain(cuda, R, D, o, widths):
    """K6 through ``expand_tree_wire_fused`` on a dirty block from the
    caching allocator: every cell equals the plain version (records at
    every width instantiation, padding dropped, map indices clamped,
    zeros where no record lands), one launch a call."""
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    wire, maps = _expand_wire(cuda, R, D, o, widths, seed=R + o)
    want = tk.expand_tree_wire(*wire, *maps, n_docs=D, o=o)
    _expand_dirty(cuda, D, o)
    e0 = ta.expand_launches
    got = tk.expand_tree_wire_fused(*wire, *maps, n_docs=D, o=o)
    assert ta.expand_launches == e0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if R:
        assert bool((want[0] != 0).any())


def test_tree_expand_captured_in_a_cuda_graph(cuda):
    """K6's cooperative launch captured in a CUDA graph (with the
    allocation of its output) and replayed after the buffer was dirtied:
    equal to the plain version."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    D, o = 8192, 4
    wire, maps = _expand_wire(cuda, 24576, D, o, (_W16, _W16, np.uint8), 3)
    want = tk.expand_tree_wire(*wire, *maps, n_docs=D, o=o)
    tk.expand_tree_wire_fused(*wire, *maps, n_docs=D, o=o)  # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tk.expand_tree_wire_fused(*wire, *maps, n_docs=D, o=o)
    out.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("N", [32, 128, 404, 1024, 1025])
def test_tree_apply_sparse_and_full_paths_side_by_side(cuda, N):
    """Docs with a remove or move or more than 4 inserts (the staged
    path) next to docs with a few inserts and setValues, setValue-only
    docs and NOOP-only docs (the sparse path, or none), chained after a
    storm that fills them; from N = 404 a CTA holds fewer than 8 docs, at
    1,025 every doc takes the staged path."""
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing.synthetic import (
        tree_path_mix, tree_record_storm,
    )
    D, O = 96, 64
    cap = min(N, 128)
    st = tk.TreeState.create(D, N, device=cuda)
    ref = st.clone()
    batches = [tree_record_storm(D, O, seed=11, capacity=cap),
               tree_path_mix(D, O, seed=12, capacity=cap, start_seq=1001),
               tree_path_mix(D, O, seed=13, capacity=cap, start_seq=2001)]
    for b, p in enumerate(batches):
        p = torch.from_numpy(p).to(cuda)
        before = ta.apply_launches
        tk.apply_tree_planes_fused(st, p)
        assert ta.apply_launches == before + 1
        ref = tk.apply_tree_planes(ref, p)
        torch.cuda.synchronize()
        _tree_same(st, ref, b)


def test_tree_apply_insert_into_a_full_doc(cuda):
    """A doc filled to its last slot (staged path: many inserts), then on
    the sparse path an insert that would apply (sticky overflow, nothing
    changes) and a setValue; beside it a doc with one slot left."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    K = tk.TreeOpKind
    N = 32
    fill = [(K.INSERT_SOLO, 10 + i, 1, 0, 1, i, 0, 0, 1 + i)
            for i in range(N - 1)]
    more = [(K.INSERT_SOLO, 99, 1, 10, 1, 5, 0, 0, 40),
            (K.SET_SOLO, 12, 0, 0, 0, 77, 0, 0, 41)]
    first = np.zeros((9, 2, len(fill)), np.int32)
    first[:, 0, :] = np.array(fill, np.int32).T
    first[:, 1, :N - 2] = np.array(fill[:N - 2], np.int32).T
    second = np.zeros((9, 2, len(more)), np.int32)
    second[:, :, :] = np.array(more, np.int32).T[:, None, :]
    st = tk.TreeState.create(2, N, device=cuda)
    ref = st.clone()
    for p in (first, second):
        p = torch.from_numpy(p).to(cuda)
        tk.apply_tree_planes_fused(st, p)
        ref = tk.apply_tree_planes(ref, p)
        torch.cuda.synchronize()
        _tree_same(st, ref, "full doc")
    assert st.overflow.tolist() == [1, 0]
    assert int((st.node_id[0] != 0).sum()) == N
    assert int((st.node_id[1] != 0).sum()) == N


def test_tree_apply_mix_at_max_slots(cuda):
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing.synthetic import tree_path_mix
    N = ta.max_slots()
    assert N >= 6456
    st = tk.TreeState.create(8, N, device=cuda)
    ref = st.clone()
    for b in range(2):
        p = torch.from_numpy(tree_path_mix(8, 128, seed=20 + b, capacity=64,
                                           start_seq=1 + 1000 * b)).to(cuda)
        tk.apply_tree_planes_fused(st, p)
        ref = tk.apply_tree_planes(ref, p)
        torch.cuda.synchronize()
        _tree_same(st, ref, b)


def test_tree_launch_shape_matches_the_library(cuda):
    import ctypes
    from fluidframework_tpu_torch.ops import tree_apply as ta
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N in (1, 32, 33, 128, 403, 404, 1000, 1024, 1025, 4000,
              ta.max_slots()):
        for D in (1, 256, 8192):
            out = (ctypes.c_int * 3)()
            ta._load().tree_apply_shape(N, D, sms,
                                        ctypes.cast(out, ctypes.c_void_p))
            assert list(ta.launch_shape(N, D, sms).values()) == list(out), \
                (N, D)


def test_tree_apply_replayed_in_a_cuda_graph(cuda):
    """K5 captured in a CUDA graph (each call restoring its input first),
    replayed: equal to the plain apply of the same input."""
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing.synthetic import (
        tree_path_mix, tree_record_storm,
    )
    D, N = 512, 128
    st0 = tk.TreeState.create(D, N, device=cuda)
    tk.apply_tree_planes_fused(st0, torch.from_numpy(
        tree_record_storm(D, 64, seed=1, capacity=N)).to(cuda))
    p = torch.from_numpy(tree_path_mix(D, 64, seed=2, capacity=N,
                                       start_seq=1001)).to(cuda)
    want = tk.apply_tree_planes(st0, p)
    work = st0.clone()

    def run():
        for k, v in work.fields().items():
            v.copy_(getattr(st0, k))
        ta.launch_apply(work, p)

    run()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(5):
            run()
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        _tree_same(work, want, "graph")


def test_tree_kernels_check_inputs(cuda):
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    st = tk.TreeState.create(4, 32, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        ta.launch_apply(st, torch.zeros((9, 3, 8), dtype=torch.int32,
                                        device=cuda))
    with pytest.raises(TypeError, match="int32"):
        ta.launch_apply(st, torch.zeros((9, 4, 8), dtype=torch.int64,
                                        device=cuda))
    out = torch.zeros((9, 4, 8), dtype=torch.int32, device=cuda)
    z = lambda *s, dt=torch.uint8: torch.zeros(s, dtype=dt,  # noqa: E731
                                               device=cuda)
    m = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="uint16"):
        ta.launch_expand(z(4, 3), z(4, 3, dt=torch.int32),
                         z(4, dt=torch.uint16), z(4, dt=torch.uint16),
                         z(4), m, m, m, m, out)


def test_tree_capacity_refused_at_construction(cuda):
    """A capacity past max_slots() is refused when the store, the engine
    or a restore is built; a recovery rebuild past it raises
    MemoryError."""
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops.tree_store import TensorTreeStore
    from fluidframework_tpu_torch.server.serving import TreeServingEngine
    N = ta.max_slots()
    with pytest.raises(ValueError, match=str(N)):
        TensorTreeStore(2, N + 1, device=cuda)
    with pytest.raises(ValueError, match=str(N)):
        TreeServingEngine(n_docs=2, capacity=N + 1, device=cuda)
    snap = TensorTreeStore(2, N + 1, device="cpu").snapshot()
    with pytest.raises(ValueError, match=str(N)):
        TensorTreeStore.restore(snap, device=cuda)
    eng = TreeServingEngine(n_docs=1, capacity=4096, batch_window=10 ** 9,
                            sequencer="native", device=cuda)
    eng.connect("big", 1)
    n = 4100
    eng.ingest_leaves(["big"] * n, [1] * n, list(range(1, n + 1)), [0] * n,
                      ["root"] * n, ["kids"] * n,
                      [f"n{i}" for i in range(n)], [0] * n)
    assert eng.overflowed_docs() == ["big"]
    with pytest.raises(MemoryError, match="tree_apply"):
        eng.recover_overflowed()


def test_tree_released_wire_buffer_overwritten_after_dispatch(cuda):
    """Right after a prepacked dispatch, the next pack takes buffers from
    the pool and overwrites them while the card is still busy: the result
    equals the plain version (a buffer is reused only after its upload)."""
    from fluidframework_tpu_torch.ops.tree_store import TensorTreeStore
    from fluidframework_tpu_torch.server.tree_wire import encode_tree_batch
    from fluidframework_tpu_torch.testing.synthetic import tree_op_storm
    docs = [f"d{i}" for i in range(64)]
    card = TensorTreeStore(64, 128, device=cuda)
    cpu = TensorTreeStore(64, 128, device="cpu")
    busy = torch.randn(4096, 4096, device=cuda)
    pools = {}
    for w in range(3):
        wave = tree_op_storm(docs, 2, seed=w, pools=pools)
        batch = encode_tree_batch([op for _d, op in wave])
        rows = np.array([docs.index(d) for d, _ in wave],
                        np.int64)[batch["rec_op"]]
        seqs = np.arange(1, len(wave) + 1) + 1000 * w
        base = np.zeros(64, np.int32)
        for i, (d, _) in enumerate(wave):
            if base[docs.index(d)] == 0:
                base[docs.index(d)] = seqs[i]
        for _ in range(4):
            busy = busy @ busy   # keep the card busy behind the copies
            busy /= busy.norm()
        for st in (card, cpu):
            pp = st.prepack_wire(batch["recs"], batch["rec_op"], rows,
                                 batch)
            key = pp.wire.key
            st.apply_wire_prepacked(pp, base)
            again = st._wire_buffers(*_key_types(key))
            for v in again.views:
                v[...] = 0x5A   # the next pack writes straight away
    torch.cuda.synchronize()
    _tree_same(card.state, cpu.state, "wire")


def _key_types(key):
    rb, posb, idb, valb = key
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32}
    return rb, width[posb], width[idb], width[valb]


def test_tree_engine_on_card_matches_cpu(cuda):
    """Per-op submits, two pipelined wire waves back to back, recovery,
    and full / incremental summaries loaded on the card, against the same
    on the CPU."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.server.ingest_pipeline import (
        PipelinedIngestExecutor,
    )
    from fluidframework_tpu_torch.server.serving import TreeServingEngine
    from fluidframework_tpu_torch.server.tree_wire import encode_tree_batch
    from fluidframework_tpu_torch.testing.synthetic import tree_op_storm
    docs = [f"t{i}" for i in range(32)]
    engines = [TreeServingEngine(n_docs=32, capacity=32, device=d,
                                 batch_window=10 ** 9, sequencer="native")
               for d in (cuda, "cpu")]
    for e in engines:
        for d in docs:
            e.connect(d, 1)
            e.doc_row(d)
        for d in docs[:8]:
            e.connect(d, 2)   # the per-op client
    pools, cs = {}, {}
    waves = []
    for w in range(4):
        wave = tree_op_storm(docs, 3, seed=w, pools=pools)
        ids = [d for d, _ in wave]
        cseq = []
        for d in ids:
            cs[d] = cs.get(d, 0) + 1
            cseq.append(cs[d])
        waves.append((ids, [1] * len(ids), cseq, [0] * len(ids),
                      encode_tree_batch([op for _d, op in wave])))
    per_op_ops = tree_op_storm(docs[:8], 4, seed=9, pools=pools)
    for e in engines:
        e.ingest_records(*waves[0])
        ex = PipelinedIngestExecutor(e, depth=3)
        tickets = [ex.submit(*w) for w in waves[1:3]]
        ex.drain()
        assert all(t.result()["nacked"] == 0 for t in tickets)
        ex.close()
        per_op = {}
        for d, op in per_op_ops:
            per_op[d] = per_op.get(d, 0) + 1
            e.submit(d, 2, per_op[d], 0, op)
        e.ingest_records(*waves[3])
    card, cpu = engines
    for k in tk.TREE_PLANES + ("overflow",):
        assert torch.equal(getattr(card.store.state, k).cpu(),
                           getattr(cpu.store.state, k)), k
    assert card.overflowed_docs() == cpu.overflowed_docs()
    assert card.recover_overflowed() == cpu.recover_overflowed()
    for d in docs:
        assert card.to_dict(d) == cpu.to_dict(d), d
    full = card.summarize()
    inc = card.summarize(incremental=True)
    for s in (full, inc):
        ld = TreeServingEngine.load(s, card.log, device=cuda,
                                    sequencer="native")
        for d in docs:
            assert ld.to_dict(d) == card.to_dict(d), d


# ------------------------------------------------------------ the mega tier
# K7 (``csrc/megadoc_apply.cu``): one thread-block cluster a document, one
# CTA a shard. Shapes cross the slots-per-thread tiers (S <= 512, then 2, 4,
# 8 and 16 slots a thread), shard counts 1, 3 and 8, docs whose slots sit on
# every shard (rebalanced) or on the last one, and shards at the overflow
# edge.

def _mega_chain(dev, D, n, S, K, gen, batches, O, rebalance, seed=0):
    """K7 and the plain version over chained batches from the same input
    state; every launch equal in every plane (slots past count too)."""
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
    st = mgk.create_megadoc_state(D, S, n, K, device=dev)
    seq = 1
    for b in range(batches):
        planes, seq2 = gen(D, O, seed=seed * 10 + b, start_seq=seq)
        ops = _ops(planes, dev)
        ref = mgk.apply_megadoc_plain(st, *ops)
        before = ma.launches
        mgk.apply_megadoc_batch(st, *ops)
        assert ma.launches == before + 1
        torch.cuda.synchronize()
        for k in mt.FIELDS:
            assert torch.equal(getattr(st, k), getattr(ref, k)), (b, k)
        if b % 2:
            st = mgk.compact_megadoc(st, torch.full(
                (D,), seq, dtype=torch.int32, device=dev))
        if rebalance and not bool(st.overflow.any()):
            st = mgk.rebalance_megadoc(st)
        seq = seq2
    return st


@pytest.mark.parametrize("n,S,O,K,corpus", [
    (8, 64, 64, 4, "typing"), (8, 16, 24, 4, "conflict"),
    (3, 128, 64, 2, "conflict"), (1, 600, 128, 4, "conflict"),
    (2, 2000, 256, 4, "typing"), (8, 4096, 128, 4, "conflict"),
    (2, 5000, 128, 0, "typing"), (8, 4, 64, 4, "typing"),
    (16, 256, 64, 4, "conflict")])
@pytest.mark.parametrize("rebalance", [False, True])
def test_megadoc_kernel_matches_plain(cuda, n, S, O, K, corpus, rebalance):
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    if n > ma.max_shards(S, K):
        pytest.skip(f"this card places no cluster of {n} CTAs at S={S}")
    gen = typing_storm if corpus == "typing" else conflict_storm
    st = _mega_chain(cuda, 3, n, S, K, gen, 4, O, rebalance)
    if S == 4:
        assert bool(st.overflow.any())


def test_megadoc_kernel_boundary_insert(cuda):
    """A later-sequenced insert at a shard boundary lands LEFT of an
    earlier concurrent insert held by the earlier shard, whose
    perspective-visible length is zero."""
    from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
    I, R = int(OpKind.STR_INSERT), int(OpKind.STR_REMOVE)
    recs = [(I, 0, 2, 10, 1, 0, 0), (R, 0, 2, 0, 2, 1, 1),
            (I, 0, 3, 11, 3, 2, 1), (I, 0, 4, 12, 4, 3, 2)]
    planes = np.zeros((7, 1, 4), np.int32)
    for j, r in enumerate(recs):
        planes[:, 0, j] = r
    ops = torch.from_numpy(planes).to(cuda)
    st = mgk.create_megadoc_state(1, 8, device=cuda)
    mgk.apply_megadoc_batch(st, *(p[:, :1].contiguous() for p in ops))
    st = mgk.rebalance_megadoc(st)
    assert int(st.count[0, 0]) == 1
    tail = [p[:, 1:].contiguous() for p in ops]
    ref = mgk.apply_megadoc_plain(st, *tail)
    mgk.apply_megadoc_batch(st, *tail)
    for k in mt.FIELDS:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    assert [r[0] for r in mgk.visible_runs(st)[0]] == [12, 11]


def test_megadoc_kernel_captured_in_a_cuda_graph(cuda):
    """A K7 launch captured in a CUDA graph and replayed on its restored
    input state: equal to the plain version."""
    from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
    st0 = _mega_chain(cuda, 4, 8, 256, 4, conflict_storm, 2, 64, True)
    planes, _ = conflict_storm(4, 64, seed=7, start_seq=10 ** 5)
    ops = _ops(planes, cuda)
    ref = mgk.apply_megadoc_plain(st0, *ops)
    st = _clone(st0)
    mgk.apply_megadoc_batch(st, *ops)   # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        mgk.apply_megadoc_batch(st, *ops)
    for _ in range(2):
        for k, v in st.fields().items():
            v.copy_(getattr(st0, k))
        g.replay()
        torch.cuda.synchronize()
        for k in mt.FIELDS:
            assert torch.equal(getattr(st, k), getattr(ref, k)), k


def test_megadoc_layout_refused_at_construction(cuda):
    """A capacity a shard or a shard count that K7 does not take is
    refused when the store, a restore or the engine is built; a mega doc
    whose graduation needs a flat rebuild past the string kernel's
    capacity raises MemoryError."""
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    from fluidframework_tpu_torch.ops.megadoc_store import (
        MegaDocStringStore,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    S = ma.max_slots_per_shard(4)
    assert 4096 <= S < 8192
    assert ma.max_shards(4096, 4) >= 8
    assert ma.active_clusters(8, 4096, 4) >= 1
    with pytest.raises(ValueError, match=str(S)):
        MegaDocStringStore(2, S + 1, device=cuda)
    with pytest.raises(ValueError, match="shards"):
        MegaDocStringStore(2, 64, n_shards=ma.max_shards(64, 4) + 1,
                           device=cuda)
    with pytest.raises(ValueError, match=str(S)):
        StringServingEngine(n_docs=2, capacity=64, mega_docs=1,
                            mega_capacity_per_shard=S + 1, device=cuda)
    snap = MegaDocStringStore(1, S + 1, device="cpu").snapshot()
    with pytest.raises(ValueError, match=str(S)):
        MegaDocStringStore.restore(snap, device=cuda)
    # one shard of 4,096 slots overflows with 8,200 live slots: the K7
    # rebuild holds them on a wider layout, but they outgrow the tier, and
    # the graduation's flat rebuild outgrows the string kernel (kMaxS =
    # 8,192) before it fits
    mega = MegaDocStringStore(1, 4096, n_shards=1, device=cuda)
    eng = StringServingEngine(n_docs=1, capacity=64, batch_window=10 ** 9,
                              compact_every=10 ** 9, mega_store=mega,
                              device=cuda)
    eng.auto_recover = False
    eng.mark_mega("big")
    eng.connect("big", 1)
    for i in range(8200):
        eng.submit("big", 1, i + 1, i + 1, {"mt": "insert", "kind": 0,
                                            "pos": 0, "text": "x"})
    eng.flush()
    assert eng.overflowed_docs() == ["big"]
    with pytest.raises(MemoryError, match="string_apply"):
        eng.recover_overflowed()


def test_mega_engine_on_card_matches_cpu(cuda):
    """Per-op submits from 3 clients a doc with lagging refs (inserts,
    removes, annotates) into the mega tier, compaction, recovery of an
    overflowed doc, a summary with a markMega in the tail loaded on the
    card: the card engine reads what the CPU engine reads."""
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    engines = [StringServingEngine(n_docs=2, capacity=64, batch_window=32,
                                   compact_every=4, mega_docs=3,
                                   mega_capacity_per_shard=32, device=d)
               for d in (cuda, "cpu")]
    rng = np.random.default_rng(0)
    docs = ["m0", "m1", "flat"]
    length = {d: 0 for d in docs}
    refs = {}
    plan = []
    for i in range(600):
        d = docs[int(rng.integers(0, 3))]
        c = int(rng.integers(1, 4))
        r = rng.random()
        if length[d] < 4 or r < 0.6:
            op = {"mt": "insert", "kind": 0,
                  "pos": int(rng.integers(0, max(length[d] - 8, 0) + 1)),
                  "text": "ab"}
            length[d] += 2
        elif r < 0.8:
            s = int(rng.integers(0, length[d] - 3))
            op = {"mt": "remove", "start": s, "end": s + 2}
            length[d] -= 2
        else:
            s = int(rng.integers(0, length[d] - 3))
            op = {"mt": "annotate", "start": s, "end": s + 3,
                  "props": {"k": int(rng.integers(0, 3))}}
        plan.append((d, c, op, int(rng.integers(0, 6))))
    before = ma.launches
    summaries = []
    for eng in engines:
        eng.mark_mega("m0")
        for d in docs:
            for c in (1, 2, 3):
                eng.connect(d, c)
        cs = {}
        for i, (d, c, op, lag) in enumerate(plan):
            if i == 300:
                summaries.append(eng.summarize())
                eng.mark_mega("m1")  # a markMega in the log tail
            key = (d, c)
            cs[key] = cs.get(key, 0) + 1
            ref = max(refs.get((id(eng),) + key, 0),
                      eng.deli.doc_seq(d) - lag)
            refs[(id(eng),) + key] = ref
            _, nack = eng.submit(d, c, cs[key], ref, op)
            assert nack is None
        eng.flush()
    assert ma.launches > before
    card, cpu = engines
    assert card.recover_overflowed() == cpu.recover_overflowed()
    for d in docs:
        text = cpu.read_text(d)
        assert card.read_text(d) == text, d
        for pos in range(len(text)):
            assert card.get_properties(d, pos) == cpu.get_properties(d, pos)
    for k in mt.FIELDS:
        assert torch.equal(getattr(card.mega_store.state, k).cpu(),
                           getattr(cpu.mega_store.state, k)), k
    loaded = StringServingEngine.load(summaries[0], card.log, device=cuda)
    assert loaded._mega_rows == card._mega_rows
    for d in docs:
        assert loaded.read_text(d) == card.read_text(d), d


# K7's edges (its Hopper design: warp-chunked lane-strided slots, a move
# pass that carries two slots across warps, work bounded by the live
# extent and a tail written back once, from the launch's input). States
# are built directly: runs of 5-char segments on every shard (one shard
# empty), every slot past count random non-default values in every plane.
# Ops come from distinct clients at the state's last seq, so every op
# sees the built text and its positions are known: ranges with both ends
# in one slot, in adjacent slots and across shard boundaries, inserts at
# every shard boundary, inside a slot and at both ends.

def _edge_state(D, n, S, K, seed):
    rng = np.random.default_rng(seed)
    W = n * S
    junk = lambda *shape: rng.integers(-2 ** 31, 2 ** 31, shape,
                                       dtype=np.int64).astype(np.int32)
    planes = {k: junk(D, W) for k in mt.PLANES}
    prop = junk(D, W, K)
    count = rng.integers(1, max(S // 2, 1) + 1, (D, n)).astype(np.int32)
    count[np.arange(D), rng.integers(0, n, D)] = 0
    for d in range(D):
        g = 0
        for s in range(n):
            c = int(count[d, s])
            at = slice(s * S, s * S + c)
            ids = np.arange(g + 1, g + c + 1, dtype=np.int32)
            planes["seq"][d, at] = ids
            planes["client"][d, at] = 0
            planes["removed_seq"][d, at] = 0x7FFFFFFF
            planes["removers"][d, at] = 0
            planes["length"][d, at] = 5
            planes["handle_op"][d, at] = ids
            planes["handle_off"][d, at] = 0
            prop[d, at] = rng.integers(0, 3, (c, K))
            g += c
    return dict(planes, prop_val=prop, count=count,
                overflow=np.zeros((D, n), np.int32))


def _edge_ops(state, K, O, seed, noop_share=0.0):
    """(7, D, O) op planes over the edges of ``_edge_state``'s docs."""
    rng = np.random.default_rng(seed)
    I, R, A = (int(OpKind.STR_INSERT), int(OpKind.STR_REMOVE),
               int(OpKind.STR_ANNOTATE))
    count = state["count"]
    D = count.shape[0]
    planes = np.zeros((7, D, O), np.int32)
    planes[0] = int(OpKind.NOOP)
    for d in range(D):
        G = int(count[d].sum())
        L = 5 * G
        cands = [(I, 0, 3, 7), (I, L, 2, 8)]
        for B in (5 * np.cumsum(count[d])[:-1]).tolist():
            cands.append((I, B, 3, 9))
            if 2 <= B <= L - 2:
                cands.append((A, B - 2, B + 2, (int(K) << 20) | 4
                              if rng.random() < 0.1 else (1 % max(K, 1)) << 20
                              | 5))
            if B + 5 <= L:
                cands.append((R, B, B + 5, 0))
        for k in rng.integers(0, max(G, 1), 24).tolist():
            if k + 1 < G:
                cands += [(R, 5 * k + 1, 5 * k + 3, 0),
                          (R, 5 * k + 2, 5 * k + 7, 0),
                          (A, 5 * k, 5 * k + 5, (k % max(K, 1)) << 20 | 6),
                          (A, 5 * k + 1, 5 * k + 2, 0 << 20 | 3),
                          (I, 5 * k + 2, 1, 10)]
        order = rng.permutation(len(cands))
        cols = [o for o in range(O) if rng.random() >= noop_share] or [0]
        for j, o in enumerate(cols[:min(len(cols), 31)]):
            kind, a0, a1, a2 = cands[order[j % len(order)]]
            planes[:, d, o] = (kind, a0, a1, a2, G + 1 + j, 1 + j, G)
    return planes


def _edge_launch(dev, n, S, K, O, seed, noop_share=0.0, D=2):
    """K7 against the plain version on one edge batch, every plane."""
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
    arrays = _edge_state(D, n, S, K, seed)
    st = mt.StringState(**{k: torch.from_numpy(v).to(dev)
                           for k, v in arrays.items()})
    ops = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
           for p in _edge_ops(arrays, K, O, seed + 1, noop_share)]
    ref = mgk.apply_megadoc_plain(st, *ops)
    before = ma.launches
    mgk.apply_megadoc_batch(st, *ops)
    torch.cuda.synchronize()
    assert ma.launches == before + 1
    for k in mt.FIELDS:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    return arrays, st


@pytest.mark.parametrize("S", [20, 100, 512, 700, 1500, 3000, 4096, 5000])
@pytest.mark.parametrize("K", [0, 4])
def test_megadoc_kernel_edges(cuda, S, K):
    """Every slots-a-lane tier (S <= 512: 1; then 2, 4, 8, 16), S not a
    multiple of a warp's chunk, K = 0 and 4: the edge ops and a random
    non-default tail equal the plain version in every plane."""
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    if S > ma.max_slots_per_shard(K):
        pytest.skip(f"S={S} is past K7's {ma.max_slots_per_shard(K)}")
    arrays, st = _edge_launch(cuda, 8, S, K, 31, seed=S + K)
    assert (st.count.cpu().numpy() > arrays["count"]).any()


@pytest.mark.parametrize("huge", [1 << 18, (1 << 31) - 64])
def test_megadoc_kernel_long_segments_exchange_flags(cuda, huge):
    """A visible segment of 2^18 chars or more (or a doc whose length
    passes int32) makes K7 exchange the owner flags, as the plain version
    resolves them, instead of deriving the owner from the shards' totals:
    inserts around it and at every shard boundary equal the plain
    version."""
    from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
    arrays = _edge_state(2, 8, 64, 4, seed=11)
    s = int(np.flatnonzero(arrays["count"][0])[0])
    arrays["length"][0, s * 64] = huge   # doc 0's first segment
    st = mt.StringState(**{k: torch.from_numpy(v).to(cuda)
                           for k, v in arrays.items()})
    planes = _edge_ops(arrays, 4, 31, seed=12)
    planes[1, 0] = np.where(planes[0, 0] == int(OpKind.STR_INSERT),
                            planes[1, 0] + np.where(planes[1, 0] > 0,
                                                    huge - 5, 0),
                            planes[1, 0])
    ops = [torch.from_numpy(np.ascontiguousarray(p)).to(cuda) for p in planes]
    ref = mgk.apply_megadoc_plain(st, *ops)
    mgk.apply_megadoc_batch(st, *ops)
    torch.cuda.synchronize()
    for k in mt.FIELDS:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k


@pytest.mark.parametrize("noop_share", [0.9, 0.99])
def test_megadoc_kernel_mostly_noop_columns(cuda, noop_share):
    """O columns mostly NOOP (skipped by every CTA alike)."""
    _edge_launch(cuda, 8, 1500, 4, 512, seed=3, noop_share=noop_share)


def test_megadoc_kernel_edges_in_a_cluster_of_16(cuda):
    """The non-portable 16-CTA cluster, where the card places one."""
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    if ma.max_shards(640, 4) < 16:
        pytest.skip("this card places no cluster of 16 CTAs at S=640")
    _edge_launch(cuda, 16, 640, 4, 31, seed=16)


def test_megadoc_kernel_full_shards_overflow_like_plain(cuda):
    """Shards at the overflow edge: splits and inserts that pass S set
    the sticky flag exactly where the plain version does."""
    from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
    arrays = _edge_state(2, 8, 40, 4, seed=9)
    arrays["count"][:] = np.minimum(arrays["count"] + 19, 40)
    for d in range(2):   # make the grown runs valid segments again
        g = 0
        for s in range(8):
            c = int(arrays["count"][d, s])
            at = slice(s * 40, s * 40 + c)
            ids = np.arange(g + 1, g + c + 1, dtype=np.int32)
            for k, v in (("seq", ids), ("client", 0),
                         ("removed_seq", 0x7FFFFFFF), ("removers", 0),
                         ("length", 5), ("handle_op", ids),
                         ("handle_off", 0)):
                arrays[k][d, at] = v
            g += c
    st = mt.StringState(**{k: torch.from_numpy(v).to(cuda)
                           for k, v in arrays.items()})
    ops = [torch.from_numpy(np.ascontiguousarray(p)).to(cuda)
           for p in _edge_ops(arrays, 4, 31, seed=10)]
    ref = mgk.apply_megadoc_plain(st, *ops)
    mgk.apply_megadoc_batch(st, *ops)
    torch.cuda.synchronize()
    for k in mt.FIELDS:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    assert bool(st.overflow.any())


def test_mega_recovery_through_k7_on_card(cuda):
    """A one-shard mega tier of 4,096 slots whose history (tombstone
    churn) passes the tier, with live text inside it — before K7 rebuilt
    mega docs, this raised MemoryError (the flat rebuild's first doubling,
    8,192 slots with K = 4, is past the string kernel): recovered through
    K7 (a one-doc mega rebuild on a wider layout) as ``reuploaded``, with
    K7 launches on the recovery path; the mega row, text and properties
    equal a CPU twin's."""
    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    from fluidframework_tpu_torch.ops.megadoc_store import (
        MegaDocStringStore,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    rng = np.random.default_rng(8)
    text, ops = "", []
    for _ in range(2700):   # ~1.7 slots an op: 16-char edits that cut
        r = rng.random()
        if len(text) < 400 or r < 0.45:
            pos = int(rng.integers(0, len(text) + 1))
            ops.append({"mt": "insert", "kind": 0, "pos": pos,
                        "text": "abcdefghijklmnop"})
            text = text[:pos] + "abcdefghijklmnop" + text[pos:]
        else:
            at = int(rng.integers(0, len(text) - 16))
            if r < 0.9:
                ops.append({"mt": "remove", "start": at, "end": at + 16})
                text = text[:at] + text[at + 16:]
            else:
                ops.append({"mt": "annotate", "start": at, "end": at + 5,
                            "props": {"b": int(rng.integers(0, 3))}})
    engines = []
    for dev in (cuda, "cpu"):
        e = StringServingEngine(
            n_docs=1, capacity=64, batch_window=1024, compact_every=10 ** 9,
            mega_store=MegaDocStringStore(1, 4096, n_shards=1, device=dev),
            device=dev)
        e.auto_recover = False
        e.mark_mega("m")
        e.connect("m", 1)
        for cs, op in enumerate(ops, 1):
            assert e.submit("m", 1, cs, e.deli.doc_seq("m"), op)[1] is None
        e.flush()
        assert e.overflowed_docs() == ["m"]
        before = ma.launches
        assert e.recover_overflowed() == {"m": "reuploaded"}
        if dev is cuda:
            assert ma.launches > before
            assert e.last_mega_rebuild["history_slots"] > 4096
        engines.append(e)
    card, cpu = engines
    assert card.read_text("m") == cpu.read_text("m") == text
    for pos in range(0, len(text), 7):
        assert card.get_properties("m", pos) == cpu.get_properties("m", pos)
    for k in mt.FIELDS:
        assert torch.equal(getattr(card.mega_store.state, k).cpu(),
                           getattr(cpu.mega_store.state, k)), k


# -------------------------------------------------------------- intervals

def _interval_engines(dev, D, capacity, iv_every, **kw):
    """A card engine and its CPU twin, each doc holding the interval base
    text and every ``iv_every``-th row 4 intervals with props."""
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import synthetic
    engines = [StringServingEngine(n_docs=D, capacity=capacity,
                                   batch_window=10 ** 9, sequencer="native",
                                   device=d, **kw) for d in (dev, "cpu")]
    rows = np.arange(D, dtype=np.int32)
    spans = {int(r): [(2 + k, 6 + 3 * k, {"note": k}) for k in range(4)]
             for r in rows[::iv_every]}
    one = np.ones((D, 1), np.int32)
    for eng in engines:
        for i in range(D):
            eng.connect(f"d{i}", 1)
            assert eng.doc_row(f"d{i}") == i
        eng.ingest_planes(rows, one, one, 0 * one, 0 * one, 0 * one,
                          0 * one, text=synthetic.IV_BASE_TEXT)
        eng.store.add_intervals_bulk(spans)
    return engines, rows


def _same_intervals(a, b):
    """Two engines' stores (flat and graduated) hold the same anchors,
    ids, props, floors and endpoints."""
    stores = [(a.store, b.store)] + [(s, b._graduated[d])
                                     for d, s in a._graduated.items()]
    for x, y in stores:
        assert x._interval_counter == y._interval_counter
        assert x._intervals == y._intervals
        assert np.array_equal(x._iv_min_seq, y._iv_min_seq)
        for r in range(x.n_docs):
            if x._intervals[r]:
                assert x.intervals(r) == y.intervals(r), r


def test_segmented_interval_wave_launches_match_plain(cuda):
    """Waves whose floors cross tombstones on interval rows are cut into
    segments, one string_apply launch each; every launch equals the plain
    version on its own input (all planes), and the engine equals its CPU
    twin (texts, digests, anchors)."""
    from fluidframework_tpu_torch.ops import string_store
    from fluidframework_tpu_torch.testing import synthetic
    D, O = 64, 32
    (card, cpu), rows = _interval_engines(cuda, D, 256, 4, compact_every=1)
    kept = []
    fused = string_store.apply_string_batch_fused

    def keep(state, *ops, min_seq=None, with_props=False):
        if state.seq.device.type == "cuda":
            kept.append((_clone(state), ops, with_props))
        return fused(state, *ops, min_seq=min_seq, with_props=with_props)

    rng = np.random.default_rng(5)
    lengths = np.full(D, len(synthetic.IV_BASE_TEXT), np.int64)
    segments = []
    string_store.apply_string_batch_fused = keep
    try:
        for w in range(4):
            wave = synthetic.interval_wave(rng, lengths, O, w)
            before = sk.launches
            kept.clear()
            for eng in (card, cpu):
                assert eng.ingest_planes(rows, **wave)["nacked"] == 0
            stats = card.store.last_apply_stats
            assert stats == cpu.store.last_apply_stats
            assert sk.launches - before == stats["segments"] == len(kept)
            segments.append(stats["segments"])
            for st0, ops, props in kept:
                work = _clone(st0)
                sk.apply_string_batch_fused(work, *ops, with_props=props)
                ref = mt.apply_string_batch(st0, *ops, with_props=props)
                torch.cuda.synchronize()
                _assert_same(work, ref, props, False, w)
    finally:
        string_store.apply_string_batch_fused = fused
    assert segments[0] == 1 and max(segments) > 1, segments
    for i in range(D):
        assert card.read_text(f"d{i}") == cpu.read_text(f"d{i}")
    assert np.array_equal(card.store.digests(), cpu.store.digests())
    _same_intervals(card, cpu)


def test_interval_recovery_and_load_on_card_match_cpu(cuda):
    """Interval docs that overflow a small flat tier re-upload or graduate
    on the card as on the CPU, a graduated one regrows, and a full and an
    incremental summary load on the card like on the CPU: the same
    reports, texts, digests and intervals, and the id counter goes on."""
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import synthetic
    D, O = 16, 32
    engines, rows = _interval_engines(cuda, D, 64, 1, compact_every=1)
    grow = np.zeros(D, bool)
    grow[::4] = True   # inserts only: these outgrow the tier for good
    rng = np.random.default_rng(9)
    lengths = np.full(D, len(synthetic.IV_BASE_TEXT), np.int64)
    for eng in engines:
        eng.auto_recover = False
    for w in range(3):
        wave = synthetic.interval_wave(rng, lengths, O, w, inserts_only=grow)
        for eng in engines:
            assert eng.ingest_planes(rows, **wave)["nacked"] == 0
    for eng in engines:   # the churned docs' tombstones become reclaimable
        for i in np.flatnonzero(~grow):
            eng.heartbeat(f"d{i}", 1, 2 + 3 * O)
    reports = [eng.recover_overflowed() for eng in engines]
    assert reports[0] == reports[1]
    assert set(reports[0].values()) == {"reuploaded", "graduated"}, reports
    _same_engines(*engines)
    _same_intervals(*engines)
    doc = sorted(engines[0]._graduated)[0]
    cs = 2 + 3 * O
    while not engines[0]._graduated[doc].overflowed().any():
        for eng in engines:
            _, nack = eng.submit(doc, 1, cs, eng.deli.doc_seq(doc), {
                "mt": "insert", "kind": 0, "pos": 1, "text": "Q"})
            assert nack is None
            eng.flush()
        cs += 1
    assert [eng.recover_overflowed() for eng in engines] == \
        [{doc: "regrown"}] * 2
    _same_intervals(*engines)
    summaries = [[eng.summarize()] for eng in engines]
    for eng in engines:
        eng.store.add_interval(1, 0, 3, {"late": True})
        eng.submit("d1", 1, 2 + 3 * O, eng.deli.doc_seq("d1"),
                   {"mt": "remove", "start": 0, "end": 2})
    for eng, s in zip(engines, summaries):
        s.append(eng.summarize(incremental=True))
    for k in range(2):
        loaded = [StringServingEngine.load(s[k], eng.log, device=dev,
                                           sequencer="native")
                  for eng, s, dev in zip(engines, summaries, (cuda, "cpu"))]
        _same_engines(*loaded)
        _same_intervals(*loaded)
        # the full summary predates the late interval, the delta holds it
        n = engines[0].store._interval_counter - 1 + k
        assert loaded[0].store.add_interval(0, 0, 1) == \
            loaded[1].store.add_interval(0, 0, 1) == f"iv{n + 1}"


# ------------------------------------------------------- doc-sharded state

def _sharded_string_pair(devices, D=64, O=16, S=256, waves=3):
    """A string engine sharded over ``devices`` and an unsharded one on
    the first, fed the same typing waves (compaction fused each wave)."""
    from fluidframework_tpu_torch.parallel import make_doc_mesh
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    out = []
    for mesh in (make_doc_mesh(devices=devices), None):
        e = StringServingEngine(n_docs=D, capacity=S, batch_window=10 ** 9,
                                compact_every=1, sequencer="native",
                                device=devices[0], mesh=mesh)
        docs = [f"d{i}" for i in range(D)]
        for d in docs:
            e.connect(d, 1)
        out.append((e, np.array([e.doc_row(d) for d in docs], np.int32)))
    launches = []
    for b in range(waves):
        planes, _ = typing_storm(D, O, seed=b)
        cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                       dtype=np.int32), (D, O))
        for i, (e, rows) in enumerate(out):
            before = sk.launches
            assert e.ingest_planes(rows, np.ones((D, O), np.int32), cs, cs,
                                   planes["kind"], planes["a0"],
                                   planes["a1"], "abcd")["nacked"] == 0
            if i == 0:
                launches.append(sk.launches - before)
    return out[0][0], out[1][0], launches


def test_four_shards_on_one_card_equal_unsharded(cuda):
    """4 doc shards on cuda:0: digests and texts equal the unsharded
    engine's, B1 launches once a shard a wave, and the sharded merge moves
    no tensor between devices."""
    from fluidframework_tpu_torch.parallel import sharded
    sharded.reset_shard_launches()
    e, u, launches = _sharded_string_pair([cuda] * 4)
    assert launches == [4, 4, 4]
    assert sharded.shard_launches()["string_apply"] == {s: 3
                                                        for s in range(4)}
    assert np.array_equal(e.store.digests(), u.store.digests())
    for d in ("d0", "d17", "d63"):
        assert e.read_text(d) == u.read_text(d)
    assert sharded.assert_collective_free(e.store.mesh, 64, 256, 16) == \
        "collective-free"


def test_two_cards_equal_unsharded(cuda):
    """Doc shards on two cards: each shard launches on its own card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    devs = [torch.device("cuda", i) for i in (0, 1)]
    e, u, launches = _sharded_string_pair(devs)
    assert launches == [2, 2, 2]
    assert [st.seq.device for st in e.store.sharded.shards] == devs
    assert np.array_equal(e.store.digests(), u.store.digests())


# ------------------------------------------------ the durable op log

def test_durable_serving_on_the_card(cuda, tmp_path):
    """Config #4's shape at 1,024 docs on ``NativePartitionedLog`` with a
    sync a batch, beside the in-memory log: string_apply launched every
    batch, the two engines digest-equal, the log reopened and a summary
    loaded on the card equal to the live engine."""
    from fluidframework_tpu_torch.server.native_oplog import (
        NativePartitionedLog,
    )
    from fluidframework_tpu_torch.server.oplog import PartitionedLog
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import durable_drill as dd
    D, S, O = 1024, 512, 64
    docs = dd.doc_ids(D)
    dlog = NativePartitionedLog(str(tmp_path), 8)
    dur, rows = dd.make_engine(docs, S, dlog, cuda)
    mem, _ = dd.make_engine(docs, S, PartitionedLog(8), cuda)
    summary = None
    for b in range(4):
        w = dd.config4_wave(D, O, b)
        sk.launches = 0
        assert dur.ingest_planes(rows, **w)["nacked"] == 0
        dlog.sync()
        assert sk.launches >= 1
        mem.ingest_planes(rows, **w)
        if b == 1:
            summary = dur.summarize()
    assert np.array_equal(dd.ranked_digests(dur, rows),
                          dd.ranked_digests(mem, rows))
    dlog.close()
    sk.launches = 0
    loaded = StringServingEngine.load(
        summary, NativePartitionedLog(str(tmp_path), 8), device=cuda,
        sequencer="native")
    assert sk.launches >= 1
    assert np.array_equal(dd.ranked_digests(loaded, rows),
                          dd.ranked_digests(mem, rows))
    assert all(loaded.read_text(d) == mem.read_text(d) for d in docs[::64])


def test_sigkill_drill_on_the_card(cuda, tmp_path):
    """A child process serves on the card with a sync a batch, is killed
    inside a batch's log append after its summary; the reopened
    directory loads on the card (the tail through string_apply) to
    exactly the batches on disk, and a subset equals the CPU path."""
    from fluidframework_tpu_torch.ops import cuda_build
    from fluidframework_tpu_torch.server.oplog import PartitionedLog
    from fluidframework_tpu_torch.testing import durable_drill as dd
    D, S, O = 1024, 512, 64
    cuda_build.build_all()
    ev = dd.kill_drill(str(tmp_path), D, S, O, summary_after=1, kill_batch=3,
                       device="cuda", kernel_libs=cuda_build.libraries())
    assert ev["killed_mid_batch"] and ev["rc"] == -9, ev
    sk.launches = 0
    rec, log, torn = dd.recover(str(tmp_path), ev["summary"], device=cuda)
    assert sk.launches >= 1
    m = dd.batches_on_disk(log, D)
    assert m in (ev["last_acked"] + 1, ev["last_acked"] + 2), (m, ev)
    # the kill landed inside the killed batch's append: its frame was
    # torn (the reopen cut it) or already whole
    assert torn > 0 or m == ev["last_acked"] + 2, (torn, m, ev)
    docs = dd.doc_ids(D)
    ref, rows = dd.make_engine(docs, S, PartitionedLog(8), cuda)
    sub = list(range(0, D, 16))
    twin, trows = dd.make_engine([docs[i] for i in sub], S,
                                 PartitionedLog(8), "cpu")
    for b in range(m):
        w = dd.config4_wave(D, O, b)
        ref.ingest_planes(rows, **w)
        twin.ingest_planes(trows, **dd.subset_wave(w, sub))
    assert np.array_equal(dd.ranked_digests(rec, rows),
                          dd.ranked_digests(ref, rows))
    assert np.array_equal(dd.ranked_digests(rec, rows[sub]),
                          dd.ranked_digests(twin, trows))
    assert all(rec.read_text(docs[i]) == twin.read_text(docs[i])
               for i in sub)
    log.close()


def test_native_log_build_refuses_to_fall_back(cuda, tmp_path,
                                               monkeypatch):
    """On the card's machine the durable log builds from the checkout's
    source, and without a compiler the build raises: no log serves in
    its place."""
    from fluidframework_tpu_torch.native import build
    from fluidframework_tpu_torch.server import native_oplog
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "fresh"))
    assert os.path.exists(build.ensure_built("liboplog.so"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setattr(native_oplog, "_lib", None)
    with pytest.raises(RuntimeError, match="liboplog.so"):
        native_oplog.NativePartitionedLog(str(tmp_path / "log"), 8)


def test_door_on_card_equals_direct_engine(cuda):
    """A two-client columnar door (a ``B`` client and an ``R`` client of
    128 docs each) over a 256-doc engine on the card: every op acked once
    with seq > 0, each doc's text its client's, B1 launched at least once
    a window, and the planes, payload table and digests equal to a second
    engine on the card fed the door's windows through ``ingest_planes``."""
    from fluidframework_tpu_torch.server.columnar_ingress import (
        ColumnarAlfred,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import door_storm as ds

    def engine():
        return StringServingEngine(n_docs=256, capacity=256,
                                   batch_window=10 ** 9, compact_every=2,
                                   sequencer="native", device=cuda)

    eng = engine()
    seen = ds.record_windows(eng)
    door = ColumnarAlfred(eng, window_min_rows=64, window_ms=1.0,
                          pipeline_depth=3).start_in_thread()
    plan = ds.RichPlan(128, seed=3)
    waves = 6
    clients = [ds.StormClient(door.port, [f"b{i}" for i in range(128)],
                              waves, ds.b_wave, timeout=120.0),
               ds.StormClient(door.port, [f"r{i}" for i in range(128)],
                              waves, plan.wave, timeout=120.0)]
    sk.launches = 0
    try:
        ds.run_clients(clients, timeout=120.0)
    finally:
        door.stop()
    launches = sk.launches
    assert door.drain_stats()["tier"] == "native"
    assert sum(len(c.acks) for c in clients) == 256 * waves
    assert launches >= door.windows_flushed == len(seen) > 0
    assert all(eng.read_text(f"b{i}") == ds.b_text(waves)
               for i in range(128))
    assert [eng.read_text(f"r{i}") for i in range(128)] == plan.shadow
    direct = engine()
    ds.seat_like(direct, eng)
    assert ds.replay(direct, seen) == 0
    assert ds.state_diff(eng, direct) == []
    # the census charges the store's tensors and reads the card's allocator
    from fluidframework_tpu_torch.utils.capacity import CapacityLedger
    led = CapacityLedger()
    led.register_store("door engine", eng.store)
    c = led.census()
    alloc = c["device"]["allocator"]
    assert alloc["available"] and \
        alloc["total_bytes"] >= c["device"]["total_bytes"] > 0


def _family_op(family, doc, i):
    """Op ``i`` of a small per-doc stream of each family, valid on an
    empty doc."""
    if family == "string":
        return {"mt": "insert", "kind": 0, "pos": 0, "text": f"s{i}"}
    if family == "map":
        return {"op": "set", "key": f"k{i % 5}", "value": i}
    if family == "matrix":
        if i < 2:
            return {"mx": "insRow" if i == 0 else "insCol", "pos": 0,
                    "count": 2, "opKey": [9, i]}
        return {"mx": "setCell", "row": i % 2, "col": (i // 2) % 2,
                "value": i}
    return {"op": "insert", "parent": "root", "field": "c", "after": None,
            "nodes": [{"id": f"{doc}-n{i}", "type": "t", "value": i}]}


def _family_engine(family, device):
    from fluidframework_tpu_torch.server import serving as S
    kw = dict(n_docs=4, batch_window=8, n_partitions=4, device=device)
    return {"string": lambda: S.StringServingEngine(capacity=512, **kw),
            "map": lambda: S.MapServingEngine(n_keys=16, **kw),
            "matrix": lambda: S.MatrixServingEngine(cell_capacity=4096,
                                                    **kw),
            "tree": lambda: S.TreeServingEngine(capacity=256, **kw)}[
                family]()


@pytest.mark.parametrize("family", ["string", "map", "matrix", "tree"])
def test_catchup_diff_on_card_equals_cpu(cuda, family):
    """Two generations of a CPU engine: the generation diff built and
    applied on the card reads as the same catch-up on the CPU and as the
    live engine; the string family's tail replay launches B1."""
    from fluidframework_tpu_torch.server import read_plane as rp
    from fluidframework_tpu_torch.testing.chaos import digest
    docs = [f"d{i}" for i in range(4)]
    eng = _family_engine(family, "cpu")
    for d in docs:
        eng.connect(d, 1)
    cseq = {d: 0 for d in docs}
    gens = []
    for n in (12, 20, 8):
        for _ in range(n):
            for d in docs:
                cseq[d] += 1
                _m, nack = eng.submit(d, 1, cseq[d], 0,
                                      _family_op(family, d, cseq[d] - 1))
                assert nack is None
        eng.flush()
        gens.append(eng.summarize())
    s_from, s_to = gens[0], gens[1]
    want = digest(eng, family, docs)
    cpu = rp.apply_generation_diff(
        family, rp.build_generation_diff(family, s_from, s_to,
                                         device="cpu"), s_from, eng.log,
        device="cpu")
    before = sk.launches
    diff = rp.build_generation_diff(family, s_from, s_to, device=cuda)
    card = rp.apply_generation_diff(family, diff, s_from, eng.log,
                                    device=cuda)
    torch.cuda.synchronize()
    if family == "string":
        assert sk.launches > before
    assert digest(card, family, docs) == digest(cpu, family, docs) == want


def test_read_replica_on_card_equals_its_leader(cuda):
    """A replica on the card anchored before a tail of its card leader
    drains it through B1 and reads as the leader, doc seqs included."""
    from fluidframework_tpu_torch.server.read_plane import (
        ReadReplica, StalenessTracker,
    )
    from fluidframework_tpu_torch.testing.chaos import digest
    docs = [f"d{i}" for i in range(4)]
    leader = _family_engine("string", cuda)
    for d in docs:
        leader.connect(d, 1)
    for i in range(8):
        leader.submit(docs[i % 4], 1, i // 4 + 1, 0,
                      _family_op("string", docs[i % 4], i))
    rep = ReadReplica(leader, summary=leader.summarize(),
                      tracker=StalenessTracker(), device=cuda)
    for i in range(8, 40):
        leader.submit(docs[i % 4], 1, i // 4 + 1, 0,
                      _family_op("string", docs[i % 4], i))
    leader.flush()
    before = sk.launches
    assert rep.poll() == 32
    assert sk.launches > before
    assert digest(rep.engine, "string", docs) == \
        digest(leader, "string", docs)
    assert all(rep.engine.deli.doc_seq(d) == leader.deli.doc_seq(d)
               for d in docs)


def test_serving_service_on_card_equals_cpu_twin(cuda):
    """A seeded container session (4 rounds, compressed and chunked
    pastes, the viewer's edits crossing the editor's turns) through
    ``ServingLocalService`` on the card and with ``device="cpu"``: the
    replica stores are equal under the parity contract after every apply
    and every compaction, the session crosses B1's props switch and a
    compaction, B1 launches once an op window of every flush, and every
    server read equals both clients."""
    from fluidframework_tpu_torch.server.serving_service import (
        ServingLocalService,
    )
    from fluidframework_tpu_torch.testing.service_session import (
        ServiceSession, doc_ids, fingerprinted,
    )
    prints, reads = [], []
    for device in (cuda, torch.device("cpu")):
        svc = ServingLocalService(n_docs=32, capacity=256, batch_window=16,
                                  compact_every=3, device=device)
        steps = fingerprinted(svc)
        windows = []
        apply = svc.store.apply_messages

        def counted(msgs, apply=apply, store=svc.store):
            apply(msgs)
            windows.append(len(store.last_op_windows))

        svc.store.apply_messages = counted
        s = ServiceSession(svc, doc_ids(32))
        before = sk.launches
        s.run(4, seed=11, paste_round=2, paste_every=4, chunk_every=16)
        svc.flush_replica()
        if device.type == "cuda":
            assert svc.store.state.seq.is_cuda
            assert sk.launches - before == sum(windows) > 0
        reads.append([svc.read_text(d, "text") for d in s.docs])
        assert reads[-1] == [ta.get_text() for ta, _, _ in s.texts] == \
            [tb.get_text() for _, tb, _ in s.texts]
        assert not svc.dropped_channels() and not svc.nacks
        prints.append(steps)
    assert prints[0] == prints[1]
    kinds = [(k, props) for k, props, _ in prints[0]]
    assert ("apply", False) in kinds and ("apply", True) in kinds
    assert ("compact", True) in kinds
    assert reads[0] == reads[1]


def test_chip_service_phase_on_card_at_small_size(cuda):
    """``chip_smoke.py``'s service phase on the card at 512 docs: every
    check of the phase (reads, props, launches a window, both B1 modes,
    the first launch of each against the plain version, the card / CPU
    twin of 256 docs crossing a compaction and the props switch) holds."""
    import chip_smoke
    out = chip_smoke.service_phase("test", "cuda", D=512, twin_docs=256,
                                   prop_docs=64, paste_every=16,
                                   chunk_every=128)
    assert out["launches"] > 0 and out["twin_launches"] > 0
    assert out["max_abs_err"] == 0
