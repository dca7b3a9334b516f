"""The port's TensorStringStore (device="cpu") against the JAX
TensorStringStore: the same messages / columnar batches must give the same
text, digests and full snapshots (planes and interner tables), in every
wire profile. Tolerance: exact."""

import numpy as np
import pytest

from fluidframework_tpu.ops.string_store import TensorStringStore as JStore
from fluidframework_tpu.testing.synthetic import rich_storm, typing_storm
from fluidframework_tpu_torch.ops.string_store import (
    TensorStringStore as TStore,
)


def _pair(D=8, S=256):
    return JStore(D, S), TStore(D, S, device="cpu")


def _assert_same(j, t, docs=None):
    for d in (docs if docs is not None else range(j.n_docs)):
        assert j.read_text(d) == t.read_text(d), d
    assert np.array_equal(j.digests(), t.digests())
    sj, st = j.snapshot(), t.snapshot()
    for k, v in st["planes"].items():
        assert np.array_equal(np.asarray(sj["planes"][k]), v), k
    for k in ("count", "overflow"):
        assert np.array_equal(sj[k], st[k]), k
    for k in ("payloads", "client_idx", "prop_planes", "prop_values",
              "has_props"):
        assert sj[k] == st[k], k


def test_apply_messages_collab_streams():
    from tests.test_merge_tree_kernel import collab_stream
    j, t = _pair()
    streams = [collab_stream(s, n_rounds=8, with_annotates=s % 2 == 1)
               for s in range(4)]
    for d, (text, _, msgs) in enumerate(streams):
        for store in (j, t):
            store.apply_messages((d, m) for m in msgs)
        assert t.read_text(d) == text
    _assert_same(j, t)


def _typing_batch(D, O, seed, start_seq, base):
    planes, nxt = typing_storm(D, O, seed=seed, start_seq=start_seq)
    seq_base = np.full((D,), base, np.int32)
    ref = seq_base[:, None] + np.arange(O, dtype=np.int32)[None, :]
    return planes, seq_base, ref, nxt


def test_apply_planes_broadcast_compact8_with_fused_compaction():
    D, O = 8, 16
    j, t = _pair(D)
    rows = np.arange(D, dtype=np.int32)
    client = np.ones((D, O), np.int32)
    seq = 1
    for b in range(3):
        planes, seq_base, ref, seq = _typing_batch(D, O, b, seq, b * O)
        ms = np.full((D,), b * O, np.int32) if b == 2 else None
        for store in (j, t):
            store.apply_planes(rows, planes["kind"], planes["a0"],
                               planes["a1"], seq_base, client, ref, "abcd",
                               min_seq=ms)
        assert j.last_profile == t.last_profile == \
            ("compact8", "pos16", "broadcast")
    _assert_same(j, t)


@pytest.mark.parametrize("profile", ["lag16", "ref_wide", "pos32"])
def test_apply_planes_forced_wire_profiles(profile):
    """A row subset (the scatter path) in each of the wider profiles."""
    D, O = 8, 16
    j, t = _pair(D)
    rows = np.array([5, 1, 6], np.int32)
    R = len(rows)
    planes, _ = typing_storm(R, O, seed=4)
    kind, a0, a1 = planes["kind"], planes["a0"].copy(), planes["a1"].copy()
    base = 100_000 if profile == "ref_wide" else 10
    seq_base = np.full((R,), base, np.int32)
    ref = np.broadcast_to(seq_base[:, None], (R, O)).copy()
    if profile == "lag16":
        ref[:, -4:] = base - 300       # lags past a byte, within u16
    elif profile == "ref_wide":
        ref[:, :] = 3                  # lags past u16
    else:
        rm = kind == 1
        a0[rm] += 40_000               # positions past i16: a no-op range
        a1[rm] += 40_000
    client = np.full((R, O), 7, np.int32)
    # the row subset rides the scatter path; zamboni fuses for every row
    ms = np.full((D,), base + O // 2, np.int32)
    for store in (j, t):
        store.apply_planes(rows, kind, a0, a1, seq_base, client, ref, "xyz",
                           min_seq=ms)
        assert store.last_profile[0] == ("lag16" if profile == "pos32"
                                         else profile)
        assert store.last_profile[1] == \
            ("pos32" if profile == "pos32" else "pos16")
    _assert_same(j, t)


@pytest.mark.parametrize("wire,n_texts", [("tab8", 0), ("tab16", 300),
                                           ("plane", 70_000)])
def test_apply_planes_rich_payloads(wire, n_texts):
    """Per-op payloads + single-key annotates in each rich wire form: a
    u8 or u16 index into device-side tables, or (huge tables) a resolved
    i32 a2 plane."""
    D, O = 8, 24
    j, t = _pair(D)
    rows = np.arange(D, dtype=np.int32)
    planes, texts, props, _ = rich_storm(D, O, seed=2)
    texts = texts + [f"pad{i}" for i in range(n_texts)]
    seq_base = np.zeros((D,), np.int32)
    for store in (j, t):
        store.apply_planes(rows, planes["kind"], planes["a0"], planes["a1"],
                           seq_base, planes["client"], planes["ref_seq"] * 0,
                           texts=texts, tidx=planes["tidx"], props=props)
        assert store.last_rich_wire == wire
    assert t._has_props
    _assert_same(j, t)


def test_from_jax_snapshot_continues_in_step():
    from tests.test_merge_tree_kernel import collab_stream
    _, _, msgs = collab_stream(3, n_rounds=10, with_annotates=True)
    half = len(msgs) // 2
    j = JStore(4, 256)
    j.apply_messages((2, m) for m in msgs[:half])
    j.compact(msgs[half // 2].seq)
    t = TStore.from_jax_snapshot(j.snapshot(), device="cpu")
    _assert_same(j, t)
    for store in (j, t):
        store.apply_messages((2, m) for m in msgs[half:])
    _assert_same(j, t)
