"""What the memory-only op log costs on the per-op serving path, for
two checkouts timed in turns.

``python fluidframework_tpu_torch/testing/memory_log_cost.py A B``
runs one child process per checkout in the order A, B, B, A (each child
imports ``fluidframework_tpu_torch`` from its checkout) and prints one
JSON line per child and a last line with each checkout's medians. A
child builds a ``StringServingEngine`` on the in-memory log (the
default) and times, on the card unless ``--device cpu``:

- ``submit_us``: ``OPS`` one-char inserts through ``submit``, one at a
  time, round robin over ``DOCS`` docs, a flush every ``WINDOW`` ops
  (the per-op route: sequencing, the log append, the queue, the apply);
- ``log_append_us``: the engine's log append alone (``_log_append``,
  the seam every per-op submit goes through), re-appending the same
  messages into a fresh engine's log.

Both are microseconds per op, the median of ``REPS`` runs after a
warm-up run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

DOCS = 256
OPS = 32_768
WINDOW = 4_096
REPS = 3


def child(root: str, device: str) -> dict:
    """Times the checkout ``root`` on ``device`` (one process a root:
    each imports its own package)."""
    docs, ops, window, reps = DOCS, OPS, WINDOW, REPS
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from fluidframework_tpu_torch.server.serving import StringServingEngine

    def settle():
        if device == "cuda":
            torch.cuda.synchronize()

    def engine():
        e = StringServingEngine(n_docs=docs, capacity=2 * ops // docs + 64,
                                batch_window=window, compact_every=1,
                                sequencer="native", device=device)
        for i in range(docs):
            e.connect(f"doc-{i}", 1)
        return e

    names = [f"doc-{i}" for i in range(docs)]
    submit_us, append_us = [], []
    for _ in range(reps + 1):           # the first rep warms up
        e = engine()
        settle()
        t0 = time.perf_counter()
        for i in range(ops):
            d = names[i % docs]
            _, nack = e.submit(d, 1, i // docs + 1, e.deli.doc_seq(d),
                               {"mt": "insert", "kind": 0, "pos": 0,
                                "text": "x"})
            if nack is not None:
                raise AssertionError(f"op {i} nacked: {nack}")
        e.flush()
        settle()
        submit_us.append((time.perf_counter() - t0) / ops * 1e6)
        msgs = [m for p in range(e.log.n_partitions) for m in e.log.read(p)]
        f = engine()
        t0 = time.perf_counter()
        for m in msgs:
            f._log_append(m.doc_id, m)
        append_us.append((time.perf_counter() - t0) / len(msgs) * 1e6)
    return {"root": root, "device": device, "ops": ops, "docs": docs,
            "submit_us": statistics.median(submit_us[1:]),
            "log_append_us": statistics.median(append_us[1:]),
            "submit_us_reps": submit_us[1:],
            "log_append_us_reps": append_us[1:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts to time in turns")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child, args.device)))
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts")
    a, b = args.roots
    runs = []
    for root in (a, b, b, a):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--device", args.device],
            capture_output=True, text=True, check=True).stdout
        runs.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({root: {k: statistics.median(
        r[k] for r in runs if r["root"] == root)
        for k in ("submit_us", "log_append_us")} for root in (a, b)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
