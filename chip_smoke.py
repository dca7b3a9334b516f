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
   the same rows;
5. recovery — the same waves at S=384 (``bench.py``'s kernel capacity,
   which the corpus outgrows), the first serially and the rest pipelined,
   until docs overflow: the drain and one more ``recover_overflowed``
   rebuild them from the log, then every doc's text (and the digest of
   every doc that never overflowed) equals a capacity-1024 control engine
   fed the same waves. Then ``summarize``, a tail wave to 1,024 flat docs,
   ``StringServingEngine.load`` on the card and one more recovery: every
   doc's text, ``doc_seq``, flat digest and graduated digest equal the
   live engine's, and a resubmitted clientSeq is dup-acked with its seq.
   Every launch shape outside the flat tier (rebuild and graduated
   stores) is timed and held against the plain version on the inputs the
   path gave it. The line reports the docs re-uploaded and graduated, the
   rebuild capacities and op windows, recovery seconds by part (log scan,
   rebuild apply, compaction, adopt), summarize and load seconds and the
   launches by shape.

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


def recovery_phase(D, O, docs, wave, waves, smi, dev, clone, bound,
                   max_err):
    """Phase 5: serve config #4 at S=384 until docs overflow, recover,
    hold every doc against a capacity-1024 control, summarize, send a
    tail wave, load, hold the reloaded engine against the live one, and
    time every launch shape outside the flat tier against the plain
    version. Returns (launches, rebuild shape rows, max abs error)."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.ops import string_store
    from fluidframework_tpu_torch.server.ingest_pipeline import (
        PipelinedIngestExecutor,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import kernel_timing

    t_phase = time.perf_counter()
    rows_all = np.arange(D, dtype=np.int32)
    recoveries = []   # (report, time split) of each recovery that healed

    def engine(capacity, **kw):
        e = StringServingEngine(n_docs=D, capacity=capacity,
                                batch_window=10 ** 9, compact_every=1,
                                sequencer="native", device=dev, **kw)
        for d in docs:
            e.connect(d, 1)
        if not np.array_equal([e.doc_row(d) for d in docs], rows_all):
            raise AssertionError("rows not allocated in doc order")
        return e

    def recording(e):
        """Keep every recovery's report and time split (the engine's
        own calls included: drain's, the compaction cadence's, load's)."""
        recover = e.recover_overflowed

        def wrapped(*a, **kw):
            rep = recover(*a, **kw)
            if rep:
                recoveries.append((dict(rep), dict(e.last_recovery)))
            return rep
        e.recover_overflowed = wrapped
        return e

    def serve(e, ws):
        """The first wave serially, the rest through the executor."""
        res = [e.ingest_planes(rows_all, **ws[0])]
        with PipelinedIngestExecutor(e, depth=3) as ex:
            tks = [ex.submit(rows_all, **w) for w in ws[1:]]
            ex.drain()
            res += [tk.result() for tk in tks]
        if any(r["nacked"] for r in res):
            raise AssertionError("recovery phase: nacked ops")

    # the first launch of every shape outside the flat tier (rebuild and
    # graduated stores), kept to time it against the plain version later
    shape_inputs = {}
    flat_apply = string_store.apply_string_batch_fused

    def keep_inputs(state, *ops, min_seq=None, with_props=False):
        key = (*state.seq.shape, ops[0].shape[1], with_props,
               min_seq is not None)
        if key[0] != D and key not in shape_inputs:
            shape_inputs[key] = (clone(state), ops, min_seq)
        return flat_apply(state, *ops, min_seq=min_seq,
                          with_props=with_props)
    string_store.apply_string_batch_fused = keep_inputs

    launch_shapes = {}

    def count_launches():
        for k, n in sk.shapes.items():
            launch_shapes[k] = launch_shapes.get(k, 0) + n
        return sk.launches

    # serve at S=384 until docs overflow; detection is one compaction
    # late, so after the drain one more recover_overflowed heals the rest
    sk.launches = 0
    sk.shapes.clear()
    t0 = time.perf_counter()
    live = recording(engine(S_KERNEL))
    rec_waves = list(waves)
    serve(live, rec_waves)
    live.recover_overflowed()
    while not recoveries and len(rec_waves) < 8:
        rec_waves.append(wave(len(rec_waves)))
        live.ingest_planes(rows_all, **rec_waves[-1])
        live.recover_overflowed()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    phase_launches = count_launches()
    healed = {d: how for rep, _ in recoveries for d, how in rep.items()}
    if not healed:
        raise AssertionError(f"no doc overflowed in {len(rec_waves)} waves")
    if live.overflowed_docs():
        raise AssertionError("overflowed docs left after recovery")
    served = list(recoveries)

    # the same waves into an engine whose capacity never overflows
    t0 = time.perf_counter()
    control = engine(1024)
    serve(control, rec_waves)
    control.recover_overflowed()
    if control.last_recovery or control._graduated:
        raise AssertionError("the control engine overflowed")
    dl, dc = live.store.digests(), control.store.digests()
    for i, d in enumerate(docs):
        if live.read_text(d) != control.read_text(d):
            raise AssertionError(f"{d}: text differs from the control")
        if d not in healed and dl[i] != dc[i]:
            raise AssertionError(f"{d}: digest differs from the control")
    for i in sorted({0, 7, D // 2, D - 1} | set(
            int(d[4:]) for d in list(healed)[:4])):
        n = len(control.read_text(docs[i]))
        for p in (0, n // 2, n - 1):
            if live.get_properties(docs[i], p) != \
                    control.get_properties(docs[i], p):
                raise AssertionError(f"{docs[i]}@{p}: properties differ")
    compare_s = time.perf_counter() - t0
    del control
    torch.cuda.empty_cache()

    # reload: summary, a tail wave to 1,024 flat docs (every 10th), load
    sk.launches = 0
    sk.shapes.clear()
    t0 = time.perf_counter()
    summary = live.summarize()
    summarize_s = time.perf_counter() - t0
    tail = [i for i, d in enumerate(docs) if d in live._doc_rows][::10]
    tail = tail[:1024]
    tw = {k: (v[tail] if isinstance(v, np.ndarray) else v)
          for k, v in wave(len(rec_waves)).items()}
    tres = live.ingest_planes(rows_all[tail], **tw)
    live.note_acked_planes([docs[i] for i in tail], tw["client"],
                           tw["client_seq"], tres["seq"])
    live.recover_overflowed()
    t0 = time.perf_counter()
    loaded = recording(StringServingEngine.load(
        summary, live.log, device=dev, sequencer="native"))
    loaded.recover_overflowed()   # the replayed tail overflowed its docs
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if loaded._doc_rows != live._doc_rows or \
            sorted(loaded._graduated) != sorted(live._graduated):
        raise AssertionError("reloaded rows or tiers differ from live")
    for d in docs:
        if loaded.read_text(d) != live.read_text(d) or \
                loaded.deli.doc_seq(d) != live.deli.doc_seq(d):
            raise AssertionError(f"{d}: reloaded text or seq differs")
    if not np.array_equal(loaded.store.digests(), live.store.digests()):
        raise AssertionError("reloaded flat digests differ from live")
    for d, st in live._graduated.items():
        if loaded._graduated[d].digests()[0] != st.digests()[0]:
            raise AssertionError(f"{d}: reloaded graduated digest differs")
    d0 = docs[tail[0]]
    cs, seq = int(tw["client_seq"][0, 5]), int(tres["seq"][0, 5])
    for e in (live, loaded):   # a resubmit is dup-acked with its seq
        msg, nack = e.submit(d0, 1, cs, 0, {"mt": "insert", "kind": 0,
                                            "pos": 0, "text": "x"})
        if msg is not None or nack.seq != seq:
            raise AssertionError(f"resubmit of {d0}:{cs} not dup-acked")
        e.submit(d0, 1, int(tw["client_seq"][0, -1]) + 1,
                 e.deli.doc_seq(d0), {"mt": "insert", "kind": 0, "pos": 3,
                                      "text": "Z"})
    if loaded.read_text(d0) != live.read_text(d0):
        raise AssertionError(f"{d0}: text differs after a new op")
    tail_graduated = len(live._graduated)
    torch.cuda.synchronize()
    phase_launches += count_launches()
    string_store.apply_string_batch_fused = flat_apply
    reloaded_s = time.perf_counter() - t0

    # every launch shape outside the flat tier against the plain version
    rebuild_rows = []
    for (d_, s_, o_, props, compact), (st0, ops, ms) in sorted(
            shape_inputs.items()):
        work = clone(st0)
        sk.apply_string_batch_fused(work, *ops, min_seq=ms,
                                    with_props=props)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = mt.apply_string_batch(st0, *ops, with_props=props)
        if compact:
            ref = mt.compact_string_state(ref, ms, props)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        err = kernel_timing.max_abs_err(mt, work, ref, props, compact)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"kernel != plain at D={d_} S={s_} "
                                 f"O={o_}: max abs err {err}")
        mean_seen = float(st0.count.float().mean()
                          + work.count.float().mean()) / 2
        n_real = int((ops[0] != 12).sum())
        ev = []
        for _ in range(10):
            for k, v in work.fields().items():
                v.copy_(getattr(st0, k))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sk.apply_string_batch_fused(work, *ops, min_seq=ms,
                                        with_props=props)
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        b_ms, b_by, nbytes = bound(s_, props, compact,
                                   [(n_real, mean_seen)], d=d_, o=o_)
        k_ = K if props else 0
        rebuild_rows.append({
            "spec": ("props" if props else "no-props")
            + ("+compact" if compact else ""),
            "D": d_, "S": s_, "O": o_, "K": k_, "state": "rebuild",
            "ms": sum(x.elapsed_time(y) for x, y in ev) / len(ev),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "max_abs_err": err, "real_ops": n_real,
            "mean_count_seen": mean_seen,
            "launches": launch_shapes.get((d_, s_, o_, k_, compact), 0)})
    del shape_inputs, summary, loaded, live
    torch.cuda.empty_cache()

    def split(rec):
        rep, stats = rec
        outcome = {}
        for how in rep.values():
            outcome[how] = outcome.get(how, 0) + 1
        return {**stats, "outcomes": outcome}

    all_rec = [split(r) for r in recoveries]
    emit({"phase": "recovery", "docs": D, "capacity": S_KERNEL,
          "control_capacity": 1024, "waves": len(rec_waves),
          "ops_per_wave": D * O,
          "overflowed_docs": len(healed),
          "reuploaded": sum(h == "reuploaded" for h in healed.values()),
          "graduated": sum(h == "graduated" for h in healed.values()),
          "serving_recoveries": [split(r) for r in served],
          "tail_docs": len(tail), "tail_graduated": tail_graduated,
          "recoveries": all_rec,
          "recovery_s": {k: sum(r.get(k, 0.0) for r in all_rec)
                         for k in ("scan_s", "apply_s", "compact_s",
                                   "adopt_s")},
          "serve_s": serve_s, "control_compare_s": compare_s,
          "summarize_s": summarize_s, "load_s": load_s,
          "reload_and_checks_s": reloaded_s,
          "kernel_launches": phase_launches,
          "launch_shapes": [
              {"D": k[0], "S": k[1], "O": k[2], "K": k[3],
               "compact": k[4], "launches": n}
              for k, n in sorted(launch_shapes.items())],
          "rebuild_shapes": rebuild_rows,
          "texts_equal_control": D, "reloaded_equal_live": D,
          "total_s": time.perf_counter() - t_phase, "card": smi})

    return phase_launches, rebuild_rows, max_err


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
    def bound(S, props, compact, work, d=D, o=O):
        """Least time for the same work: bytes each read/written once vs
        int32 operations (one per visible slot per op) at peak rate.
        ``work``: (real ops, mean count the ops see) of each batch."""
        k = K if props else 0
        nbytes = (2 * (7 + k) * d * S * 4 + 7 * d * o * 4 + 2 * 2 * d * 4
                  + (d * 4 if compact else 0))
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

    def wave(b):
        """typing_storm wave ``b`` (seed b) for every doc, clientSeqs
        b·O+1 .. (b+1)·O."""
        planes, _ = typing_storm(D, O, seed=b)
        cseq = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                         dtype=np.int32), (D, O))
        # the client saw everything sequenced so far (join = seq 1)
        return dict(client=np.ones((D, O), np.int32), client_seq=cseq,
                    ref_seq=cseq, kind=planes["kind"], a0=planes["a0"],
                    a1=planes["a1"], text=TEXT)

    waves = [wave(b) for b in range(N_BATCHES + 1)]
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

    del eng, small
    torch.cuda.empty_cache()

    phase_launches, rebuild_rows, max_err = recovery_phase(
        D, O, docs, wave, waves, smi, dev, clone, bound, max_err)

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
        "recovery_launches": phase_launches,
        "specialisations": [
            {"spec": name, "S": S, "state": state, **t}
            for (name, S, state), t in timing.items()] + rebuild_rows,
        "total_s": time.perf_counter() - t_start,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
