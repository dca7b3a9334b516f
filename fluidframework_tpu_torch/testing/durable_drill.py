"""Config #4 served on the durable log, killed, and recovered from disk.

The child side, ``python -m fluidframework_tpu_torch.testing.durable_drill
DIR --docs D --capacity S --ops O --summary-after K --waves N``, serves
config #4's columnar waves (``config4_wave``) through a
``StringServingEngine`` on a ``NativePartitionedLog(DIR, 8)`` and calls
``sync()`` after every batch (the group commit: an ack is durable). It
pickles a summary into ``DIR`` after batch K and prints one JSON line an
event: ``{"start": b}`` before batch b, ``{"append": ...}`` (partition
file, its size and the frame's bytes) just before the log's C append of
a batch record, ``{"acked": b}`` once its sync returned,
``{"summary": path}`` once the summary file is in place.

The parent side, ``kill_drill``, starts that child (a new interpreter:
CUDA is live in the parent, so no fork), waits for the first batch
append after the summary, watches the partition file and SIGKILLs the
child as soon as the file grows: the kill lands inside the C append's
write (the frame is left torn) or, at the latest, just after it (the
frame is whole, never synced or acked). It reports the last acked
batch. ``recover`` reopens the directory (the native log truncates a
torn tail) and loads the summary, which replays the log tail through the
same apply path.
``ranked_digests`` is the per-doc digest two engines that number their
payloads apart agree on.

Usage (the child; the parent runs it): see ``kill_drill``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import merge_tree as mt
from ..server.native_oplog import NativePartitionedLog
from ..server.serving import StringServingEngine
from ..utils.atomicfile import atomic_write_bytes
from ..utils.faultpoints import SITE_OPLOG_MID_APPEND, install
from .synthetic import typing_storm

N_PARTITIONS = 8
TEXT = "abcd"
#: the parent kills the child if it has not reached the kill by then
CHILD_TIMEOUT_S = 600.0
#: how long the parent watches a partition file for the append's write
WRITE_WAIT_S = 30.0
PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def doc_ids(n_docs: int) -> List[str]:
    return [f"doc-{i}" for i in range(n_docs)]


def config4_wave(n_docs: int, n_ops: int, b: int) -> dict:
    """typing_storm wave ``b`` (seed b) as ``ingest_planes`` keywords:
    one client a doc, clientSeqs b·O+1 .. (b+1)·O, each op seeing every
    op before it."""
    planes, _ = typing_storm(n_docs, n_ops, seed=b)
    cseq = np.broadcast_to(np.arange(b * n_ops + 1, (b + 1) * n_ops + 1,
                                     dtype=np.int32), (n_docs, n_ops))
    return dict(client=np.ones((n_docs, n_ops), np.int32), client_seq=cseq,
                ref_seq=cseq, kind=planes["kind"], a0=planes["a0"],
                a1=planes["a1"], text=TEXT)


def subset_wave(wave: dict, rows) -> dict:
    """The rows ``rows`` of a wave (the planes of those docs)."""
    return {k: (v[rows] if isinstance(v, np.ndarray) else v)
            for k, v in wave.items()}


def make_engine(docs: List[str], capacity: int, log, device):
    """Config #4's serving engine (compaction every batch, the native
    sequencer) with every doc joined; returns (engine, rows)."""
    eng = StringServingEngine(n_docs=len(docs), capacity=capacity,
                              batch_window=10 ** 9, compact_every=1,
                              sequencer="native", log=log, device=device)
    for d in docs:
        eng.connect(d, 1)
    rows = np.array([eng.doc_row(d) for d in docs], np.int32)
    return eng, rows


def ranked_digests(eng, rows) -> np.ndarray:
    """``string_state_digest`` of the rows ``rows`` with every payload
    handle replaced by the rank of its (kind, text) among the engine's
    distinct payloads. The columnar route interns a wave's text once and
    a tail replay interns it once an op, so two engines holding the same
    documents number their payloads apart; this digest does not see it."""
    pays = eng.store._payloads
    ids: Dict[tuple, int] = {}
    first = np.fromiter((ids.setdefault(p, len(ids)) for p in pays),
                        np.int64, len(pays))
    rank_of = np.empty(len(ids), np.int64)
    rank_of[[ids[p] for p in sorted(ids)]] = np.arange(len(ids))
    st = eng.store.state
    dev = st.seq.device
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    part = mt.StringState(**{k: getattr(st, k)[idx].clone()
                             for k in mt.FIELDS})
    rank = torch.as_tensor(rank_of[first], dtype=torch.int32, device=dev)
    part.handle_op = rank[part.handle_op.long()]
    return mt.string_state_digest(part).cpu().numpy()


def batches_on_disk(log, n_docs: int) -> int:
    """Columnar batches a reopened drill log holds: every record but
    the ``n_docs`` joins is one whole batch."""
    return sum(log.size(p) for p in range(log.n_partitions)) - n_docs


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class _AnnounceAppends:
    """Fault plan of the child: prints an ``append`` event at each
    ``SITE_OPLOG_MID_APPEND`` hit, just before the C side writes."""

    def hit(self, site, **ctx):
        if site == SITE_OPLOG_MID_APPEND:
            _emit({"append": ctx["offset"], "path": ctx["path"],
                   "size": os.path.getsize(ctx["path"]),
                   "nbytes": ctx["nbytes"]})


def serve(directory: str, n_docs: int, capacity: int, n_ops: int,
          summary_after: int, n_waves: int, device) -> None:
    """The child: serve ``n_waves`` config #4 waves on the durable log,
    a sync after each, a summary after batch ``summary_after``."""
    log = NativePartitionedLog(directory, N_PARTITIONS)
    eng, rows = make_engine(doc_ids(n_docs), capacity, log, device)
    log.sync()
    install(_AnnounceAppends())
    _emit({"ready": True})
    for b in range(n_waves):
        _emit({"start": b})
        res = eng.ingest_planes(rows, **config4_wave(n_docs, n_ops, b))
        if res["nacked"]:
            raise RuntimeError(f"batch {b}: {res['nacked']} nacks")
        log.sync()
        _emit({"acked": b})
        if b == summary_after:
            path = os.path.join(directory, "summary.pkl")
            atomic_write_bytes(path, pickle.dumps(eng.summarize()))
            _emit({"summary": path, "after": b})
    _emit({"done": n_waves})
    signal.pause()   # the parent kills us


def _kill_on_write(proc, ev) -> dict:
    """SIGKILL ``proc`` as soon as the partition file of the ``append``
    event ``ev`` grows past its size before the append."""
    deadline = time.perf_counter() + WRITE_WAIT_S
    size = os.path.getsize(ev["path"])
    while size <= ev["size"]:
        if time.perf_counter() > deadline or proc.poll() is not None:
            raise AssertionError(f"the append never wrote: {ev}")
        size = os.path.getsize(ev["path"])
    proc.send_signal(signal.SIGKILL)
    return {"partition_file": os.path.basename(ev["path"]),
            "size_before": ev["size"], "frame_bytes": ev["nbytes"],
            "size_at_kill": size}


def kill_drill(directory: str, n_docs: int, capacity: int, n_ops: int,
               summary_after: int, kill_batch: int, device="cuda",
               kernel_libs: Optional[dict] = None) -> dict:
    """Run ``serve`` in a child process and SIGKILL it inside the log
    append of batch ``kill_batch`` (or of the first batch it starts
    after that); returns the child's events: the last acked batch, the
    batch the kill landed in, the partition file's size before the
    append and when the kill was sent, the summary path and the batch
    walls."""
    if kill_batch <= summary_after:
        raise ValueError("the kill must land after the summary")
    os.makedirs(directory, exist_ok=True)
    cmd = [sys.executable, "-m", __name__, directory, "--docs", str(n_docs),
           "--capacity", str(capacity), "--ops", str(n_ops),
           "--summary-after", str(summary_after),
           "--waves", str(kill_batch + 2), "--device", str(device)]
    if kernel_libs:
        cmd += ["--kernel-libs", json.dumps(kernel_libs)]
    err = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=PKG_PARENT, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    watchdog = threading.Timer(CHILD_TIMEOUT_S, proc.kill)
    watchdog.start()
    starts: Dict[int, float] = {}
    walls: Dict[int, float] = {}
    acked, summary, killed_in, ready_s = -1, None, None, None
    batch, kill = None, None
    try:
        for line in proc.stdout:
            ev = json.loads(line)
            now = time.perf_counter()
            if "ready" in ev:
                ready_s = now - t0
            elif "start" in ev:
                batch = ev["start"]
                starts[batch] = now
            elif "append" in ev:
                if batch >= kill_batch and summary is not None:
                    kill = _kill_on_write(proc, ev)
                    killed_in = batch
                    break
            elif "acked" in ev:
                acked = ev["acked"]
                walls[acked] = now - starts[acked]
            elif "summary" in ev:
                summary = ev["summary"]
            elif "done" in ev:
                raise AssertionError("the child finished before the kill")
        if killed_in is None:
            err.seek(0)
            raise RuntimeError(f"durable drill child exited "
                               f"(rc {proc.wait()}):\n{err.read()[-4000:]}")
        # events the child printed before the signal landed
        for line in proc.stdout:
            ev = json.loads(line)
            if "acked" in ev:
                acked = ev["acked"]
            if "start" in ev:
                killed_in = ev["start"]
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
        rc = proc.wait()
        err.close()
    return {"last_acked": acked, "killed_in": killed_in,
            "killed_mid_batch": killed_in > acked, "rc": rc,
            "kill": kill, "summary": summary,
            "summary_after": summary_after, "batch_wall_s": walls,
            "child_ready_s": ready_s, "child_s": time.perf_counter() - t0}


def recover(directory: str, summary_path: str, device="cuda"):
    """Reopen the drill's directory (torn tail truncated) and load its
    summary; returns (engine, log, bytes the reopen truncated)."""
    paths = [os.path.join(directory, f"p{p}.log")
             for p in range(N_PARTITIONS)]
    before = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    log = NativePartitionedLog(directory, N_PARTITIONS)
    truncated = before - sum(os.path.getsize(p) for p in paths)
    with open(summary_path, "rb") as f:
        summary = pickle.load(f)
    eng = StringServingEngine.load(summary, log, device=device,
                                   sequencer="native")
    return eng, log, truncated


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory")
    ap.add_argument("--docs", type=int, default=10_240)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--ops", type=int, default=64)
    ap.add_argument("--summary-after", type=int, default=2)
    ap.add_argument("--waves", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-libs", default=None,
                    help="JSON {kernel: library path} of kernels this "
                         "checkout already built (no rebuild)")
    args = ap.parse_args(argv)
    if args.kernel_libs:
        from ..ops import cuda_build
        cuda_build.adopt(json.loads(args.kernel_libs))
    serve(args.directory, args.docs, args.capacity, args.ops,
          args.summary_after, args.waves, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
