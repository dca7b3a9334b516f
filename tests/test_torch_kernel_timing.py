"""The nearly full inputs that ``testing/kernel_timing.py`` times the
kernel on, run through the JAX reference and the port's plain version on
the CPU: the same state and ops give the same planes (full planes after an
apply; ``[0, count)`` plus the digest after a compaction), every op
position is valid and no doc overflows. Tolerance: exact (int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import merge_tree_kernel as jmt
from fluidframework_tpu_torch.core.constants import NOT_REMOVED
from fluidframework_tpu_torch.ops import merge_tree as tmt
from fluidframework_tpu_torch.ops.string_kernel import (
    apply_string_batch_fused,
)
from fluidframework_tpu_torch.testing import kernel_timing as kt
from fluidframework_tpu_torch.testing import synthetic

D, S, O = 8, 96, 16


def _visible_chars(st):
    act = torch.arange(st.seq.shape[1])[None, :] < st.count[:, None]
    live = act & (st.removed_seq == NOT_REMOVED)
    return (st.length * live).sum(1, dtype=torch.int32)


@pytest.mark.parametrize("spec", [s[0] for s in kt.SPECS])
def test_near_full_inputs_match_jax(spec):
    _, props, compact = next(s for s in kt.SPECS if s[0] == spec)
    st, ops, ms = kt.near_full(tmt, synthetic, D, S, O, props, device="cpu")
    assert int(st.count[0]) == S - 2 * O
    sj = jmt.StringState(**{k: jnp.asarray(v.numpy())
                            for k, v in st.fields().items()})
    jops = [jnp.asarray(t.numpy()) for t in ops]
    sj = jmt.apply_string_batch_jit(sj, *jops, with_props=props)
    out = tmt.apply_string_batch(st, *ops, with_props=props)
    if compact:
        sj = jmt.compact_string_state(sj, jnp.asarray(ms.numpy()), props)
        out = tmt.compact_string_state(out, ms, props)
    assert not out.overflow.any()
    j = tmt.StringState(**{k: torch.as_tensor(np.array(getattr(sj, k)))
                           for k in out.fields()})
    assert kt.max_abs_err(tmt, out, j, props, compact) == 0
    # the fused wrapper on CPU tensors agrees as well
    fused = apply_string_batch_fused(
        kt.near_full(tmt, synthetic, D, S, O, props, device="cpu")[0], *ops,
        min_seq=ms if compact else None, with_props=props)
    assert kt.max_abs_err(tmt, fused, out, props, compact) == 0


def test_near_full_typing_positions_are_valid():
    """Every typing-storm op lands inside the text: the visible length
    grows by exactly the storm's inserted minus removed characters."""
    st, ops, _ = kt.near_full(tmt, synthetic, D, S, O, False, device="cpu")
    before = _visible_chars(st)
    kind = ops[0]
    net = (synthetic.INS_LEN * (kind == 0).sum(1)
           - synthetic.RM_LEN * (kind == 1).sum(1)).to(torch.int32)
    out = tmt.apply_string_batch(st, *ops, with_props=False)
    assert torch.equal(_visible_chars(out), before + net)
    assert int(out.count.max()) <= S and not out.overflow.any()


def test_max_abs_err_sees_a_difference():
    st, ops, ms = kt.near_full(tmt, synthetic, D, S, O, True, device="cpu")
    out = tmt.apply_string_batch(st, *ops, with_props=True)
    bad = tmt.StringState(**{k: v.clone() for k, v in out.fields().items()})
    bad.length[3, 5] += 7
    assert kt.max_abs_err(tmt, bad, out, True, False) == 7
    bad = tmt.StringState(**{k: v.clone() for k, v in out.fields().items()})
    bad.prop_val[1, 0, 2] -= 3
    assert kt.max_abs_err(tmt, bad, out, True, True) > 0
