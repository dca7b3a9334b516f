"""Chained cell-table merges, each held against the plain version.

At BASELINE config #3 widths by default (a 1,024 × 1,024 grid, batches of
65,536 set-cell ops, capacity rows·cols + 65,536), for every seed:

- ``full``: the config #3 storm (8 batches) chained through the full
  merge (last-writer-wins), then one first-writer-wins batch;
- ``full-ragged``: 8 more full merges of batches whose size is drawn from
  [1, 70,000] (ragged sort tiles, odd merge passes);
- ``prefix``: the same records fed the way ``TensorMatrixStore`` feeds
  them — cell ids interned in first-write order, chunks of 4,096 (the
  last one padded), one prefix merge each with L the power of two ≥ 8
  above the identity count. ``prefix`` interns the whole storm first (one
  ``apply_batch_columnar`` call: L is fixed), ``prefix-growing`` interns
  chunk by chunk (a call per chunk: L doubles as the ids grow), then a
  first-writer-wins storm of 16 chunks;
- ``repeat``: the last batch of each mode merged again into its own
  result, eagerly and replayed in a CUDA graph, without restoring the
  input (merging a batch already merged must leave the table as it is).

Every merge runs the plain version (``merge_cells``) on the kernel's input
state, then the kernel in place, and compares all planes, ``count`` and
``overflow`` exactly; the kernel's table must stay key-sorted with unique
live keys and EMPTY past ``count``. A mismatch is recorded (plane, first
differing slot, both values, counts) and the chain goes on from the plain
result. On a CPU device the entry point runs the plain version, so only
the harness is exercised.

Usage (one card)::

    python3 fluidframework_tpu_torch/testing/cell_merge_stress.py \\
        [--seeds 16] [--out FILE]

Prints one JSON line (merges per mode, mismatches, seconds); exits 1 on
any mismatch, 2 without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

GRID, OPS, BATCHES, STORE_BATCH = 1024, 1 << 16, 8, 4096   # config #3


def first_write_ids(keys: np.ndarray) -> np.ndarray:
    """Dense ids in first-appearance order, as the store's identity dict
    hands them out."""
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inv].astype(np.int32)


def prefix_L(n_ids: int, capacity: int):
    """``TensorMatrixStore._merge_chunk``'s choice: L, or None (full)."""
    L, need = 8, min(n_ids + 1, capacity)
    while L < need:
        L *= 2
    return None if L >= capacity else L


class Checker:
    """Runs each merge through the plain version and the kernel and keeps
    the tally."""

    def __init__(self, mx, dev):
        self.mx, self.dev = mx, dev
        self.merges, self.bad = {}, []

    def merge(self, st, b, L, fww, mode, seed, i):
        mx = self.mx
        want = mx.merge_cells(st, *b, L, fww)
        count_in = int(st.count)
        mx.merge_cells_fused(st, *b, L=L, fww=fww)
        self.compare(st, want, mode, seed, i, L, int(b[0].numel()),
                     count_in)
        return st

    def compare(self, st, want, mode, seed, i, L, O, count_in):
        mx = self.mx
        self.merges[mode] = self.merges.get(mode, 0) + 1
        where = {}
        for k in mx.PLANES + ("count", "overflow"):
            a, w = getattr(st, k), getattr(want, k)
            if not torch.equal(a, w):
                bad = torch.nonzero((a != w).reshape(-1)).reshape(-1)
                j = int(bad[0])
                where[k] = {"n": int(bad.numel()), "first": j,
                            "kernel": int(a.reshape(-1)[j]),
                            "plain": int(w.reshape(-1)[j])}
        n = int(st.count)
        key = st.key
        if not int(st.overflow) and not (
                bool((key[1:n] > key[:n - 1]).all())
                and bool((key[n:] == int(mx.EMPTY_KEY)).all())):
            where["sorted_invariant"] = False
        if where:
            self.bad.append({"mode": mode, "seed": seed, "merge": i,
                             "L": L, "O": O, "count_in": count_in,
                             "count_kernel": n,
                             "count_plain": int(want.count),
                             "planes": where})
            for k, v in want.fields().items():   # go on from the plain one
                getattr(st, k).copy_(v)


def clone(mx, st):
    return mx.MatrixCellState(**{k: v.clone() for k, v in
                                 st.fields().items()})


def stress_seed(chk, synthetic, seed, grid, ops, batches, store_batch,
                repeats):
    mx, dev = chk.mx, chk.dev
    T = grid * grid + ops
    rng = np.random.default_rng(10_000 + seed)

    def on_dev(*xs):
        return [torch.as_tensor(np.ascontiguousarray(x, np.int32)).to(dev)
                for x in xs]

    def repeat(st, b, L, fww, mode):
        """Merge ``b`` again, eagerly and (on a card) in a CUDA graph,
        without restoring the input: the table must not move."""
        want = clone(mx, st)
        for r in range(repeats):
            mx.merge_cells_fused(st, *b, L=L, fww=fww)
            chk.compare(st, want, mode + " eager", seed, r, L,
                        int(b[0].numel()), int(want.count))
        if dev.type != "cuda":
            return
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(repeats):
                mx.merge_cells_fused(st, *b, L=L, fww=fww)
        for r in range(2):
            g.replay()
            torch.cuda.synchronize()
            chk.compare(st, want, mode + " graph", seed, r, L,
                        int(b[0].numel()), int(want.count))

    # full mode: the storm, one FWW batch, then ragged batches
    storm = synthetic.cell_storm(grid, grid, ops, batches, seed=seed)
    st = mx.MatrixCellState.create(T, dev)
    for i, (k, s, v) in enumerate(storm):
        chk.merge(st, on_dev(k, s, v), None, False, "full", seed, i)
    repeat(st, on_dev(*storm[-1]), None, False, "repeat full")
    seq0 = batches * ops
    k, s, v = synthetic.cell_storm(grid, grid, ops, 1, seed=seed + 1)[0]
    chk.merge(st, on_dev(k, s + seq0, v), None, True, "full", seed,
              batches)
    seq0 += ops
    for i in range(batches):
        O = int(rng.integers(1, 70_001))
        key = (rng.integers(0, grid, O) * grid
               + rng.integers(0, grid, O)).astype(np.int32)
        key[rng.random(O) < 0.05] = int(mx.EMPTY_KEY)
        seq = np.arange(seq0 + 1, seq0 + O + 1, dtype=np.int32)
        seq0 += O
        val = rng.integers(1, 1 << 30, O, dtype=np.int32)
        chk.merge(st, on_dev(key, seq, val), None, bool(i % 3 == 2),
                  "full-ragged", seed, i)

    # prefix mode, as the store feeds the same records
    raw = np.concatenate([b[0] for b in storm])
    seqs = np.concatenate([b[1] for b in storm])
    vals = np.concatenate([b[2] for b in storm])
    ids = first_write_ids(raw)
    n = len(raw)
    fww_raw, fww_seq, fww_val = synthetic.cell_storm(
        grid, grid, ops, 1, seed=seed + 1)[0]
    for mode in ("prefix", "prefix-growing"):
        st = mx.MatrixCellState.create(T, dev)
        seen = 0 if mode == "prefix-growing" else int(ids.max()) + 1
        last = None
        chunks = [(ids, seqs, vals, False)]
        # the FWW storm's new cells get ids after the storm's
        all_ids = first_write_ids(np.concatenate([raw, fww_raw]))
        chunks.append((all_ids[n:], fww_seq + batches * ops, fww_val, True))
        i = 0
        for cid, cseq, cval, fww in chunks:
            if mode == "prefix":
                seen = max(seen, int(cid.max()) + 1)
            for a in range(0, len(cid), store_batch):
                kk, ss, vv = (x[a:a + store_batch] for x in (cid, cseq, cval))
                if mode == "prefix-growing":
                    seen = max(seen, int(kk.max()) + 1)
                pad = store_batch - len(kk)
                if pad:
                    kk = np.concatenate([kk, np.full(pad, mx.EMPTY_KEY,
                                                     np.int32)])
                    ss = np.concatenate([ss, np.zeros(pad, np.int32)])
                    vv = np.concatenate([vv, np.zeros(pad, np.int32)])
                L = prefix_L(seen, T)
                last = (on_dev(kk, ss, vv), L, fww)
                chk.merge(st, last[0], L, fww, mode, seed, i)
                i += 1
        repeat(st, *last, "repeat " + mode)


def run(device="cuda", seeds=16, grid=GRID, ops=OPS, batches=BATCHES,
        store_batch=STORE_BATCH, repeats=5) -> dict:
    from fluidframework_tpu_torch.ops import cell_merge as cmk
    from fluidframework_tpu_torch.ops import matrix_kernel as mx
    from fluidframework_tpu_torch.testing import synthetic

    dev = torch.device(device)
    chk = Checker(mx, dev)
    cmk.launches = 0
    t0 = time.perf_counter()
    for seed in range(seeds):
        stress_seed(chk, synthetic, seed, grid, ops, batches, store_batch,
                    repeats)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"stress": "cell_merge", "device": str(dev),
            "grid": [grid, grid], "capacity": grid * grid + ops,
            "ops_per_batch": ops, "store_batch": store_batch,
            "seeds": seeds, "merges": chk.merges,
            "total_merges": sum(chk.merges.values()),
            "kernel_launches": cmk.launches,
            "mismatches": len(chk.bad), "first_mismatches": chk.bad[:20],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cell_merge_stress: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    res = run("cuda", seeds=args.seeds)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if res["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
