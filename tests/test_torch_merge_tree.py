"""The port's plain merge-tree apply / compact / digest against the JAX
package's, bit for bit.

Inputs are made with numpy from a seed and handed to both packages. After
an apply the FULL (D, S) planes must agree (slots beyond ``count`` too);
after a compaction only ``[0, count)`` and the digest are specified.
Tolerance: exact (everything is int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import merge_tree_kernel as jmt
from fluidframework_tpu.ops.pallas_string_kernel import (
    apply_string_batch_pallas,
)
from fluidframework_tpu.testing.synthetic import conflict_storm, typing_storm
from fluidframework_tpu_torch.core.constants import NOT_REMOVED
from fluidframework_tpu_torch.ops import merge_tree as tmt
from fluidframework_tpu_torch.ops.string_kernel import (
    apply_string_batch_fused,
)
from fluidframework_tpu_torch.testing.synthetic import edge_storm

ORDER = ("kind", "a0", "a1", "a2", "seq", "client", "ref_seq")
CHECK = ("seq", "client", "removed_seq", "removers", "length", "handle_op",
         "handle_off", "count", "overflow")


def _jax_state(D, S, K=4):
    return jmt.StringState.create(D, S, K)


def _torch_state(D, S, K=4):
    return tmt.StringState.create(D, S, K, device="cpu")


def _assert_full(j, t, with_props=True):
    keys = CHECK + (("prop_val",) if with_props else ())
    for k in keys:
        a = np.asarray(getattr(j, k))
        b = getattr(t, k).numpy()
        assert np.array_equal(a, b), k


def _assert_active(j, t, with_props=True):
    cnt = np.asarray(j.count)
    assert np.array_equal(cnt, t.count.numpy())
    keys = CHECK[:-2] + (("prop_val",) if with_props else ())
    for k in keys:
        a, b = np.asarray(getattr(j, k)), getattr(t, k).numpy()
        for d in range(len(cnt)):
            assert np.array_equal(a[d, :cnt[d]], b[d, :cnt[d]]), (k, d)
    assert np.array_equal(np.asarray(jmt.string_state_digest(j)),
                          tmt.string_state_digest(t).numpy())


def _run_both(D, S, op_batches, with_props):
    sj, st = _jax_state(D, S), _torch_state(D, S)
    for planes in op_batches:
        ops = [planes[k] for k in ORDER]
        sj = jmt.apply_string_batch_jit(sj, *(jnp.asarray(x) for x in ops),
                                        with_props=with_props)
        st = tmt.apply_string_batch(st, *(torch.as_tensor(x) for x in ops),
                                    with_props=with_props)
        _assert_full(sj, st, with_props)
    return sj, st


@pytest.mark.parametrize("seed", range(3))
def test_typing_storm_full_planes(seed):
    batches, seq = [], 1
    for r in range(2):
        planes, seq = typing_storm(16, 32, seed=seed * 10 + r, start_seq=seq)
        batches.append(planes)
    _run_both(16, 128, batches, with_props=False)


@pytest.mark.parametrize("with_props", [True, False])
def test_conflict_storm_full_planes(with_props):
    planes, _ = conflict_storm(8, 32, seed=3)
    _, st = _run_both(8, 256, [planes], with_props)
    assert not st.overflow.any()


@pytest.mark.parametrize("with_props", [True, False])
def test_edge_clients_and_keys_full_planes(with_props):
    batches, seq = [], 1
    for r in range(2):
        planes, seq = edge_storm(8, 32, seed=r, start_seq=seq)
        batches.append(planes)
    _run_both(8, 256, batches, with_props)


def _msg_planes(msgs):
    from tests.test_megadoc import _planes_from_msgs
    return dict(zip(ORDER, (np.array(x) for x in _planes_from_msgs(msgs))))


def test_collab_stream_multiclient():
    from tests.test_merge_tree_kernel import collab_stream
    _, _, msgs = collab_stream(4, n_rounds=8)
    _run_both(1, 128, [_msg_planes(msgs)], with_props=False)


def test_overflow_case():
    """Capacity far too small: the sticky flag is set and the state left
    where the kernel stopped — identically in both packages."""
    from tests.test_merge_tree_kernel import collab_stream
    _, _, msgs = collab_stream(7, n_rounds=8)
    _, st = _run_both(1, 8, [_msg_planes(msgs)], with_props=False)
    assert int(st.overflow[0]) == 1


def test_annotate_case():
    from tests.test_merge_tree_kernel import collab_stream
    _, _, msgs = collab_stream(5, n_rounds=8, with_annotates=True)
    _run_both(1, 128, [_msg_planes(msgs)], with_props=True)


@pytest.mark.parametrize("with_props", [False, True])
def test_fused_compact_matches_pallas(with_props):
    """The port's apply+compact (the wrapper's plain composition on CPU
    tensors) against the JAX Pallas kernel's fused epilogue, interpreted:
    ``[0, count)`` plus the digest, batch after batch."""
    D, S = 8, 128
    sj, st = _jax_state(D, S), _torch_state(D, S)
    seq = 1
    for r in range(3):
        gen = conflict_storm if with_props else typing_storm
        planes, seq = gen(D, 16, seed=r, start_seq=seq)
        ms = np.full((D,), max(seq - D * 12, 0), np.int32)
        ops = [planes[k] for k in ORDER]
        sj = apply_string_batch_pallas(
            sj, *(jnp.asarray(x) for x in ops), min_seq=jnp.asarray(ms),
            tile=8, interpret=True, with_props=with_props)
        st = apply_string_batch_fused(
            st, *(torch.as_tensor(x) for x in ops),
            min_seq=torch.as_tensor(ms), with_props=with_props)
        _assert_active(sj, st, with_props)


def test_compact_and_digest_match_xla():
    """compact_string_state and string_state_digest on their own."""
    D, S = 8, 128
    planes, seq = conflict_storm(D, 32, seed=9)
    ops = [planes[k] for k in ORDER]
    sj = jmt.apply_string_batch_jit(_jax_state(D, S),
                                    *(jnp.asarray(x) for x in ops))
    st = tmt.apply_string_batch(_torch_state(D, S),
                                *(torch.as_tensor(x) for x in ops))
    ms = np.full((D,), seq - D * 8, np.int32)
    cj = jmt.compact_string_state(sj, jnp.asarray(ms))
    ct = tmt.compact_string_state(st, torch.as_tensor(ms))
    _assert_active(cj, ct)
    assert (ct.count < st.count).any()  # tombstones really dropped
    assert np.array_equal(np.asarray(jmt.string_state_digest(sj)),
                          tmt.string_state_digest(st).numpy())


def test_numpy_round_trip():
    planes, _ = typing_storm(4, 8, seed=1)
    st = tmt.apply_string_batch(_torch_state(4, 128),
                                *(torch.as_tensor(planes[k]) for k in ORDER))
    back = tmt.state_from_numpy(tmt.state_to_numpy(st), device="cpu")
    for k, v in st.fields().items():
        assert torch.equal(v, getattr(back, k)), k


# ------------------------------------------- the live-extent invariant
# The card kernel bounds its shifts and its write-back by the live extent:
# it treats the slots from the last non-fill slot on as fill. That is exact
# only if the apply keeps every slot in [count, S) at StringState.create's
# fill (0, NOT_REMOVED for removed_seq) whenever it was fill before.

_FILL = {"removed_seq": NOT_REMOVED}


def _tail_is_fill(st):
    S = st.seq.shape[1]
    past = torch.arange(S)[None, :] >= st.count[:, None]
    for k in PLANE_KEYS:
        v = getattr(st, k)
        fill = _FILL.get(k, 0)
        m = past if v.dim() == 2 else past[:, :, None].expand_as(v)
        if not bool((v[m] == fill).all()):
            return k
    return None


def _kernel_style_compact(st, ms, with_props):
    """The plain compaction, then the vacated slots zeroed as the kernel's
    epilogue does (NOT_REMOVED for removed_seq)."""
    c = tmt.compact_string_state(st, ms, with_props)
    past = torch.arange(st.seq.shape[1])[None, :] >= c.count[:, None]
    for k in PLANE_KEYS:
        v = getattr(c, k)
        m = past if v.dim() == 2 else past[:, :, None].expand_as(v)
        v[m] = _FILL.get(k, 0)
    return c


PLANE_KEYS = tmt.PLANES + ("prop_val",)


@pytest.mark.parametrize("S", [32, 64, 96])
@pytest.mark.parametrize("corpus", ["typing", "conflict", "edge"])
def test_tail_past_count_stays_fill(corpus, S):
    gen = {"typing": typing_storm, "conflict": conflict_storm,
           "edge": edge_storm}[corpus]
    with_props = corpus != "typing"
    D = 16
    st, seq = _torch_state(D, S), 1
    overflowed = 0
    for b in range(4):
        planes, seq = gen(D, 32, seed=b, start_seq=seq)
        ops = [torch.as_tensor(planes[k]) for k in ORDER]
        assert _tail_is_fill(st) is None
        st = tmt.apply_string_batch(st, *ops, with_props=with_props)
        assert _tail_is_fill(st) is None, (b, _tail_is_fill(st))
        overflowed = int(st.overflow.sum())
        ms = torch.full((D,), max(seq - D * 20, 0), dtype=torch.int32)
        st = _kernel_style_compact(st, ms, with_props)
        assert _tail_is_fill(st) is None, b
    if S == 32:
        assert overflowed > 0   # the invariant holds through overflow too
