#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / H100 port (``fluidframework_tpu_torch``).

Drives the port's main path — BASELINE config #4, SharedString ops
sequenced by Deli and merged into a (doc × segment) merge-tree state on the
card — once at full width, and holds the hand-written kernel against its
plain PyTorch version. Phases (one JSON line each):

1. device — card name, count, ``nvidia-smi`` name and power limit, build
   seconds and the ``-Xptxas -v`` report: registers, stack-frame and
   spill-store bytes of every instantiation (the kernel is built with nvcc
   and the native sequencer with g++, in parallel, into the package's
   git-ignored build directory);
2. parity — D=10,240 docs, S=384 slots, O=64 ops, 4 chained typing_storm
   batches: apply (full planes bit-identical) and fused apply+compact
   (``[0, count)`` plus digest identical), and the props specialisation on
   conflict_storm with K=4;
3. timing — CUDA events over many launches per specialisation at S=384
   and S=512: kernel ms, plain-version ms, the least time the card could
   take for the same work, the launch shape (threads and docs per CTA,
   slots per lane, CTAs per SM that the registers allow) and the input
   states' mean ``count``; once on the chained parity inputs (docs that
   start empty) and once on nearly full docs (``count = S - 2*O``, where
   the live extent is about S; ``testing/kernel_timing.py``), each held
   against the plain version;
4. serving — ``StringServingEngine(n_docs=10240, capacity=512,
   compact_every=1, sequencer="native")``: a warm-up wave then 4 waves of
   64 ops per doc through ``PipelinedIngestExecutor(depth=3)``, with zero
   nacks, no overflow, the kernel's launch count above 0, and the text and
   digests of sampled docs equal to a small ``device="cpu"`` engine fed
   the same rows.

Then the ``nvidia-smi`` line, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase raises, so
the exit code is non-zero. Without a card it exits 2 and prints no result.

Usage: ``python3 chip_smoke.py`` (one card).
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

D = 10_240          # documents (config #4)
O = 64              # ops per doc per batch
S_KERNEL = 384      # slot capacity of the kernel phase
S_SERVE = 512       # slot capacity of the serving phase
K = 4               # property planes (props specialisation)
N_BATCHES = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit peak (fp32 rate)
TEXT = "abcd"               # typing_storm insert payload (INS_LEN = 4)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(text: str) -> list:
    """Per kernel instantiation: slots per lane, shared-memory tier, props,
    compact, registers, stack-frame / spill-store / spill-load bytes."""
    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELb([01])ELb([01])ELb([01])E", m[1])
            cur = ({"slots_per_lane": int(t[1]), "smem_tier": t[2] == "1",
                    "props": t[3] == "1", "compact": t[4] == "1"}
                   if t else {"entry": m[1]})
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return out


def ctas_per_sm(regs: int, threads: int) -> int:
    """CTAs one H100 SM holds by registers (65,536, allocated per warp in
    units of 256) and by warps (64) and CTAs (32)."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from fluidframework_tpu_torch.native.build import ensure_built
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.server.ingest_pipeline import (
        PipelinedIngestExecutor,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import kernel_timing, synthetic
    from fluidframework_tpu_torch.testing.synthetic import (
        conflict_storm, typing_storm,
    )

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]

    # ---------------------------------------------------------- 1. device
    native = {}

    def build_native():
        t0 = time.perf_counter()
        native["path"] = ensure_built("libdeli.so")
        native["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    th.start()
    sk._load()
    th.join()
    if "path" not in native:
        raise RuntimeError("native sequencer build failed")
    ptxas = ptxas_report(sk.build_info["ptxas"])
    if not ptxas or any("registers" not in k for k in ptxas):
        raise RuntimeError("no -Xptxas -v report for the kernel")
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": sk.build_info["seconds"],
          "native_build_s": native["seconds"],
          "spill_store_bytes_max": max(k["spill_stores"] for k in ptxas),
          "stack_frame_bytes_max": max(k["stack_frame"] for k in ptxas),
          "instantiations": ptxas})

    # ---------------------------------------------------------- 2. parity
    def clone(st):
        return mt.StringState(**{k: v.clone()
                                 for k, v in st.fields().items()})

    def corpus(gen):
        """Chained batches (device op planes, min_seq floor, next seq)."""
        out, seq = [], 1
        for b in range(N_BATCHES):
            planes, nxt = gen(D, O, seed=b, start_seq=seq)
            ops = tuple(torch.as_tensor(planes[k]).to(dev)
                        for k in mt.OP_FIELDS)
            # floor = the batch's first seq: every tombstone removed
            # before this batch is reclaimable
            ms = torch.full((D,), seq, dtype=torch.int32, device=dev)
            out.append((ops, ms, int((planes["kind"] != 12).sum())))
            seq = nxt
        return out

    max_err = 0

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    def check_parity(batches, S, props, compact, n_batches):
        """Kernel vs plain version on the same chained inputs; returns the
        kernel's input states, the max abs error, overflowed docs and the
        peak slot count."""
        err = 0
        st = mt.StringState.create(D, S, K, device=dev)
        ref = clone(st)
        states = []   # the kernel's input state before each batch
        for ops, ms, _ in batches[:n_batches]:
            states.append(clone(st))
            m = ms if compact else None
            sk.apply_string_batch_fused(st, *ops, min_seq=m,
                                        with_props=props)
            ref = mt.apply_string_batch(ref, *ops, with_props=props)
            if compact:
                ref = mt.compact_string_state(ref, ms, props)
            torch.cuda.synchronize()
            keys = mt.PLANES + (("prop_val",) if props else ())
            if compact:
                if not torch.equal(st.count, ref.count):
                    raise AssertionError("count diverged")
                act = torch.arange(S, device=dev)[None, :] < \
                    st.count[:, None]
                for k in keys:
                    a, b = getattr(st, k), getattr(ref, k)
                    m3 = act if a.dim() == 2 else act[:, :, None].expand_as(a)
                    err = max(err, diff(a[m3], b[m3]))
                err = max(err, diff(mt.string_state_digest(st),
                                    mt.string_state_digest(ref)))
            else:
                for k in keys + ("count", "overflow"):
                    err = max(err, diff(getattr(st, k), getattr(ref, k)))
            if err:
                raise AssertionError(
                    f"kernel != plain (S={S}, props={props}, "
                    f"compact={compact}): max abs err {err}")
        return states, err, int(st.overflow.sum()), int(st.count.max())

    typing, conflict = corpus(typing_storm), corpus(conflict_storm)
    specs = [("no-props", False, False), ("no-props+compact", False, True),
             ("props", True, False), ("props+compact", True, True)]
    inputs = {}
    for S in (S_KERNEL, S_SERVE):
        for name, props, compact in specs:
            batches = conflict if props else typing
            # the props corpus grows past S=384 uncompacted after 2 batches
            nb = 2 if props and not compact else N_BATCHES
            states, err, ovf, peak = check_parity(batches, S, props,
                                                  compact, nb)
            max_err = max(max_err, err)
            inputs[(name, S)] = (states, batches[:nb], props, compact)
            emit({"phase": "parity", "spec": name, "D": D, "S": S, "O": O,
                  "K": K if props else 0, "batches": nb,
                  "corpus": "conflict_storm" if props else "typing_storm",
                  "check": "[0,count)+digest" if compact else "full planes",
                  "max_abs_err": err, "overflowed_docs": ovf,
                  "peak_count": peak})

    # ---------------------------------------------------------- 3. timing
    def bound(S, props, compact, work):
        """Least time for the same work: bytes each read/written once vs
        int32 operations (one per visible slot per op) at peak rate.
        ``work``: (real ops, mean input count) of each batch."""
        k = K if props else 0
        nbytes = (2 * (7 + k) * D * S * 4 + 7 * D * O * 4 + 2 * 2 * D * 4
                  + (D * 4 if compact else 0))
        n_ops = sum(n * int(c) + n for n, c in work)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / len(work) / INT_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations"), nbytes

    def time_kernel(states, batches, props, compact, rounds=5):
        work = clone(states[0])
        ev = []
        for _ in range(rounds):
            for st0, (ops, ms, _) in zip(states, batches):
                for k, v in work.fields().items():
                    v.copy_(getattr(st0, k))
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                sk.apply_string_batch_fused(
                    work, *ops, min_seq=ms if compact else None,
                    with_props=props)
                b.record()
                ev.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / len(ev)

    def time_plain(states, batches, props, compact):
        ops, ms, _ = batches[0]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = mt.apply_string_batch(states[0], *ops, with_props=props)
        if compact:
            mt.compact_string_state(out, ms, props)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    def launch_shape(S, props, compact):
        shape = sk.launch_shape(S, K if props else 0)
        regs = next(k["registers"] for k in ptxas
                    if (k.get("slots_per_lane"), k.get("smem_tier"),
                        k.get("props"), k.get("compact"))
                    == (shape["slots_per_lane"], S > 2048, props, compact))
        shape.update(registers=regs,
                     ctas_per_sm=ctas_per_sm(regs, shape["threads"]))
        return shape

    timing = {}

    def timed(name, S, state, props, compact, ms_k, ms_p, work):
        b_ms, b_by, nbytes = bound(S, props, compact, work)
        timing[(name, S, state)] = dict(ms=ms_k, plain_ms=ms_p,
                                        bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "timing", "spec": name, "D": D, "S": S, "O": O,
              "state": state, "ms": ms_k, "plain_ms": ms_p,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
              "library_ms": None,
              "launch_shape": launch_shape(S, props, compact),
              "mean_count": sum(c for _, c in work) / len(work),
              "card": smi})

    for (name, S), (states, batches, props, compact) in inputs.items():
        time_kernel(states, batches, props, compact, rounds=1)  # warm-up
        ms_k = time_kernel(states, batches, props, compact)
        ms_p = time_plain(states, batches, props, compact)
        timed(name, S, "chained", props, compact, ms_k, ms_p,
              [(n_real, float(st.count.float().mean()))
               for (_, _, n_real), st in zip(batches, states)])
    del inputs, typing, conflict
    torch.cuda.empty_cache()
    # nearly full docs: the live extent is about S, so it saves nothing
    for S in (S_KERNEL, S_SERVE):
        for name, props, compact in specs:
            row = kernel_timing.measure(mt, sk, synthetic, D, S, O, name, K)
            if row["max_abs_err"] or row["overflowed_docs"]:
                raise AssertionError(f"nearly full docs ({name}, S={S}): "
                                     f"{row}")
            timed(name, S, "near-full", props, compact, row["ms"],
                  row["plain_ms"], [(D * O, row["mean_count"])])

    # --------------------------------------------------------- 4. serving
    docs = [f"doc-{i}" for i in range(D)]
    waves = []
    for b in range(N_BATCHES + 1):
        planes, _ = typing_storm(D, O, seed=b)
        cseq = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                         dtype=np.int32), (D, O))
        # the client saw everything sequenced so far (join = seq 1)
        waves.append(dict(client=np.ones((D, O), np.int32),
                          client_seq=cseq, ref_seq=cseq,
                          kind=planes["kind"], a0=planes["a0"],
                          a1=planes["a1"], text=TEXT))
    eng = StringServingEngine(n_docs=D, capacity=S_SERVE,
                              batch_window=10 ** 9, compact_every=1,
                              sequencer="native")
    if type(eng.deli).__name__ != "NativeDeliAdapter":
        raise AssertionError("serving must run the native sequencer")
    for d in docs:
        eng.connect(d, 1)
    rows = np.array([eng.doc_row(d) for d in docs], np.int32)

    sk.launches = 0   # the main path starts here
    t0 = time.perf_counter()
    warm = eng.ingest_planes(rows, **waves[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ex = PipelinedIngestExecutor(eng, depth=3)
    t0 = time.perf_counter()
    tickets = [ex.submit(rows, **w) for w in waves[1:]]
    ex.drain()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    results = [tk.result() for tk in tickets]
    pipe = ex.stats()
    ex.close()
    launches = sk.launches   # the main path ends here
    n_ok = sum(D * O - r["nacked"] for r in results)
    nacked = warm["nacked"] + sum(r["nacked"] for r in results)
    over = eng.overflowed_docs()
    wave_wall = [tk.t_done - (tickets[i - 1].t_done if i else t0)
                 for i, tk in enumerate(tickets)]
    if nacked or over:
        raise AssertionError(f"serving: {nacked} nacks, {len(over)} "
                             "overflowed docs")
    if launches <= 0:
        raise AssertionError("serving never launched the kernel")

    sample = sorted({0, 7, D // 2, D - 1})
    small = StringServingEngine(n_docs=len(sample), capacity=S_SERVE,
                                batch_window=10 ** 9, compact_every=1,
                                sequencer="native", device="cpu")
    for i in sample:
        small.connect(docs[i], 1)
    srows = np.array([small.doc_row(docs[i]) for i in sample], np.int32)
    for w in waves:
        small.ingest_planes(srows, **{k: (v[sample] if isinstance(
            v, np.ndarray) else v) for k, v in w.items()})
    digests = eng.store.digests()
    for r, i in zip(srows, sample):
        if eng.read_text(docs[i]) != small.read_text(docs[i]):
            raise AssertionError(f"{docs[i]}: text differs from CPU engine")
        if digests[i] != small.store.digests()[r]:
            raise AssertionError(f"{docs[i]}: digest differs from CPU")
    lengths = eng.store.visible_lengths()
    emit({"phase": "serving", "docs": D, "capacity": S_SERVE,
          "ops_per_wave": D * O, "waves": len(tickets),
          "ops_per_s": n_ok / elapsed, "elapsed_s": elapsed,
          "wave_wall_s": wave_wall, "warmup_wave_s": warm_s,
          "nacked": nacked, "overflowed_docs": len(over),
          "kernel_launches": launches,
          "launches_per_wave": launches / (len(tickets) + 1),
          "pipeline_max_inflight": pipe["max_inflight"],
          "pipeline_overlap": pipe["overlap"],
          "pipeline_stage_busy_ms": pipe["stage_busy_ms"],
          "sampled_docs_match_cpu": sample,
          "visible_len_min_max": [int(lengths.min()), int(lengths.max())],
          "card": smi})

    main_t = timing[("no-props+compact", S_SERVE, "chained")]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "string_apply",
        "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/string_apply.cu",
        "replaces": "fluidframework_tpu/ops/pallas_string_kernel.py:208",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,
        "shape": {"D": D, "S": S_SERVE, "O": O,
                  "spec": "no-props+compact (the serving path)"},
        "specialisations": [
            {"spec": name, "S": S, "state": state, **t}
            for (name, S, state), t in timing.items()],
        "total_s": time.perf_counter() - t_start,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
