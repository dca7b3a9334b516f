"""Time the fused apply kernel on nearly full documents.

Every doc starts packed to ``count = S - 2*O`` live 4-char segments (the
most that one O-op batch can grow without overflowing: an op adds at most
two slots) and takes one batch of ``typing_storm`` ops (no props) or
``conflict_storm`` ops (props, K=4), moved to a seeded offset inside the
doc so the edits land across the whole text and a shift moves up to S
slots. The packed segments carry seq 0 (loaded content), so every
perspective sees them and every op position stays valid. Compaction
reclaims the tombstones of the batch's first half.

Each row holds the kernel's result against the plain PyTorch version on
the same input (``max_abs_err``: full planes, or ``[0, count)`` plus the
digest after a compaction) and times the kernel with CUDA events.

Usage (one card)::

    python3 fluidframework_tpu_torch/testing/kernel_timing.py [--root DIR]

``--root`` imports ``fluidframework_tpu_torch`` from another checkout, for
example an archive of a parent commit, so two versions of the kernel can
be timed on the same card in one session. Prints one JSON line per
(spec, S).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

SPECS = (("no-props", False, False), ("no-props+compact", False, True),
         ("props", True, False), ("props+compact", True, True))
SEG_LEN = 4   # chars per packed segment
DOCS, OPS, CAPACITIES = 10_240, 64, (384, 512)   # config #4 shapes


def near_full(mt, synthetic, D, S, O, props, K=4, seed=0, device="cuda"):
    """(state, op tensors, min_seq) for one batch on nearly full docs."""
    n = S - 2 * O
    st = mt.StringState.create(D, S, K, device=device)
    i = torch.arange(S, device=device, dtype=torch.int32)[None, :]
    live = i < n
    st.length.copy_(torch.where(live, SEG_LEN, 0).expand(D, S))
    st.handle_op.copy_(torch.where(live, i + 1, 0).expand(D, S))
    st.count.fill_(n)
    gen = synthetic.conflict_storm if props else synthetic.typing_storm
    planes, _ = gen(D, O, seed=seed, start_seq=1)
    offset = np.random.default_rng(seed + 1).integers(
        0, SEG_LEN * n + 1, size=(D, 1)).astype(np.int32)
    planes["a0"] = planes["a0"] + offset
    # a1 is a length for inserts (kind 0), a position for ranges
    planes["a1"] = planes["a1"] + np.where(planes["kind"] == 0, 0, offset)
    ops = tuple(torch.as_tensor(np.ascontiguousarray(planes[k])).to(device)
                for k in mt.OP_FIELDS)
    ms = torch.full((D,), 1 + D * O // 2, dtype=torch.int32, device=device)
    return st, ops, ms


def _clone(mt, st):
    return mt.StringState(**{k: v.clone() for k, v in st.fields().items()})


def max_abs_err(mt, st, ref, props, compact):
    """Largest difference between the kernel's state and the plain one."""
    keys = mt.PLANES + (("prop_val",) if props else ())

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    err = max(diff(st.count, ref.count), diff(st.overflow, ref.overflow))
    if not compact:
        return max([err] + [diff(getattr(st, k), getattr(ref, k))
                            for k in keys])
    if err:
        return err
    act = torch.arange(st.seq.shape[1], device=st.seq.device)[None, :] < \
        st.count[:, None]
    for k in keys:
        a, b = getattr(st, k), getattr(ref, k)
        m = act if a.dim() == 2 else act[:, :, None].expand_as(a)
        err = max(err, diff(a[m], b[m]))
    return max(err, diff(mt.string_state_digest(st),
                         mt.string_state_digest(ref)))


def measure(mt, sk, synthetic, D, S, O, spec, K=4, reps=20, seed=0):
    """One row: kernel ms (mean over ``reps`` launches after a warm-up),
    plain ms (one call), max abs error, the input's mean count."""
    _, props, compact = next(s for s in SPECS if s[0] == spec)
    st0, ops, ms = near_full(mt, synthetic, D, S, O, props, K, seed)
    m = ms if compact else None
    work = _clone(mt, st0)
    sk.apply_string_batch_fused(work, *ops, min_seq=m, with_props=props)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = mt.apply_string_batch(st0, *ops, with_props=props)
    if compact:
        ref = mt.compact_string_state(ref, ms, props)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    err = max_abs_err(mt, work, ref, props, compact)
    ev = []
    for _ in range(reps):
        for k, v in work.fields().items():
            v.copy_(getattr(st0, k))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sk.apply_string_batch_fused(work, *ops, min_seq=m, with_props=props)
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    return {"spec": spec, "D": D, "S": S, "O": O, "K": K if props else 0,
            "state": "near-full",
            "ms": sum(x.elapsed_time(y) for x, y in ev) / len(ev),
            "plain_ms": plain_ms, "max_abs_err": err,
            "mean_count": float(st0.count.float().mean()),
            "peak_count_after": int(work.count.max()),
            "overflowed_docs": int(work.overflow.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose fluidframework_tpu_torch is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.testing import synthetic

    bad = 0
    for S in CAPACITIES:
        for spec, _, _ in SPECS:
            row = measure(mt, sk, synthetic, DOCS, S, OPS, spec)
            row["root"] = os.path.abspath(args.root)
            print(json.dumps(row), flush=True)
            bad += row["max_abs_err"] != 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
