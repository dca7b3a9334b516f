"""Time a hand kernel on its main-path shapes, of this checkout or another.

``--kernel string_apply`` (the default) times the fused apply kernel on
nearly full documents: every doc starts packed to ``count = S - 2*O`` live
4-char segments (the most that one O-op batch can grow without
overflowing: an op adds at most two slots) and takes one batch of
``typing_storm`` ops (no props) or ``conflict_storm`` ops (props, K=4),
moved to a seeded offset inside the doc so the edits land across the
whole text and a shift moves up to S slots. The packed segments carry seq
0 (loaded content), so every perspective sees them and every op position
stays valid. Compaction reclaims the tombstones of the batch's first half.

``--kernel cell_merge`` times K2 at config #3's two shapes: ``prefix`` —
the store route's last merge (the storm's 524,288 records through
``TensorMatrixStore`` in chunks of 4,096; the state, chunk and L of its
last merge, L = 2^19), and ``full`` — the storm's last raw batch (T =
1,114,112, O = 65,536) merged into the table the first seven left.
``--kernel tree_apply`` times K5 at ``benches/profile_tree.py``'s shapes
(8,192 docs, capacity 128): ``wire`` — the last record wave of a
``TreeServingEngine`` (wire mode, o = 4), and ``planes`` — its kernel-alone
batch (wave 9 packed into record planes) on the state the waves left;
``--tree-inputs FILE`` adds K5 inputs saved by ``chip_smoke.py --parent``
(the per-op, recovery and load paths' widest launches). ``--kernel
axis_apply,axis_resolve`` times K3 and K4 on the inputs in ``--axis-inputs
FILE``: the matrix engine's widest launch of each kernel on each of its
paths, saved by ``chip_smoke.py --parent`` (``save_inputs``).
``--kernel map_apply`` times K1 through its entry points at config #2's
shapes: dense at D = 1,024 (the kernel loop's batches) and at D = 10,240
(config #4's doc count), and the packed serving batch (D = 1,024, K = 64,
O = 64). ``--kernel tree_expand`` times K6 through
``expand_tree_wire_fused`` (what a caller pays, including any memset the
checkout's entry point makes) on the serving engine's last record wave, as
shipped (u16 ids and values) and widened to u32. ``--kernel
megadoc_apply`` times K7 on the widest launch of ``chip_smoke.py``'s
megadoc kernel loop (64 mega docs × 8 shards × 4,096 slots, K = 4, O =
512): K7 grows the docs window by window of ``synthetic.megadoc_storm``,
rebalancing whenever a shard passes 75 %, until every doc holds more than
16,384 active slots; the last of those windows is timed, with its bound
(the state planes in and out once and the op planes, at 3.35 TB/s).
``--megadoc-inputs FILE`` times K7 on the inputs saved there instead
(``save_inputs``; ``chip_smoke.py --parent`` writes the megadoc
phase's widest kernel-loop and engine launches).
``map_apply`` or ``tree_expand`` add a ``launch_floor`` row: a
one-element ``x.add_(1)`` timed the same way, a yardstick for a kernel
bound by its launch that the port never calls.

Each row holds the kernel's result against the plain PyTorch version on
the same input (``max_abs_err``: full planes, or ``[0, count)`` plus the
digest after a compaction; K3 / K4: every plane and both outputs) and
times the kernel with CUDA events: K1-K7 as ``ms`` (20 calls back to
back in one CUDA graph, K1 and K6 50, each restoring its input state
first, minus the same graph of the restores alone; K1 writes the same
state again on every call, and K4 and K6 mutate nothing, so none of the
three restores anything) and ``call_ms`` (one eager call, minus the
restore).

Usage (one card)::

    python3 fluidframework_tpu_torch/testing/kernel_timing.py \\
        [--kernel string_apply|cell_merge|tree_apply|axis_apply|
                  axis_resolve|map_apply|tree_expand|megadoc_apply[,...]]
        [--root DIR] \\
        [--profile] \\
        [--tree-inputs FILE] [--axis-inputs FILE] [--megadoc-inputs FILE]

``--root`` imports ``fluidframework_tpu_torch`` from another checkout, for
example an archive of a parent commit, so two versions of a kernel can be
timed on the same card in one run (run parent, change, change,
parent). Prints one JSON line per row; exits 1 when a row's max abs error
is not 0, 2 without a card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

SPECS = (("no-props", False, False), ("no-props+compact", False, True),
         ("props", True, False), ("props+compact", True, True))
SEG_LEN = 4   # chars per packed segment
DOCS, OPS, CAPACITIES = 10_240, 64, (384, 512)   # config #4 shapes
CELL_GRID, CELL_OPS, CELL_BATCHES, CELL_CHUNK = 1024, 1 << 16, 8, 4096
TREE_DOCS, TREE_N, TREE_WAVES = 8192, 128, 7     # profile_tree.py
MAP_D, MAP_K, MAP_O, MAP_WIDE_D = 1024, 64, 64, 10_240   # config #2, #4
AXIS_KERNELS = ("axis_apply", "axis_resolve")
KERNELS = ("string_apply", "cell_merge", "tree_apply") + AXIS_KERNELS + (
    "map_apply", "tree_expand", "megadoc_apply")
# chip_smoke.py's megadoc phase: mega docs × shards × slots a shard, property
# planes, ops a window; the active slots every doc passes before its
# compaction, the windows of the corpus, the shard fill that rebalances
MEGA_D, MEGA_N, MEGA_S, MEGA_K, MEGA_O = 64, 8, 4096, 4, 512
MEGA_TARGET, MEGA_WINDOWS, MEGA_REBALANCE = 16_384, 28, 0.75
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
AXIS_RESOLVE = 13                                # OpKind.AXIS_RESOLVE


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


def _graph_ms(fn, reps=20):
    """Mean ms per call of ``fn`` run back to back: ``reps`` calls in one
    CUDA graph, one replay between CUDA events (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _eager_ms(fn, reps=10):
    """Mean ms of ``reps`` eager calls, each bracketed by CUDA events."""
    fn()
    ev = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    return sum(x.elapsed_time(y) for x, y in ev) / len(ev)


def device_ms_by_kernel(fn, reps=20):
    """{kernel name: mean device ms per call of ``fn``} from
    ``torch.profiler`` over ``reps`` eager calls (the state copies show as
    ``Memcpy DtoD``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", 0) or 0
        if total:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0]
            out[name[:60]] = out.get(name[:60], 0.0) + total / 1e3 / reps
    return out


def time_in_place(fields, state0, work, launch, profile=False):
    """{"ms", "call_ms"} of ``launch(work)`` on a copy of ``state0``: the
    copy is timed alone and taken off; ``work`` ends holding one launch's
    result. ``fields(s)`` maps plane names to tensors. ``profile`` adds
    the device ms of each kernel a call launches."""
    def copy():
        for k, v in fields(work).items():
            v.copy_(fields(state0)[k])

    def run():
        copy()
        launch(work)

    out = {"ms": _graph_ms(run) - _graph_ms(copy),
           "call_ms": _eager_ms(run) - _eager_ms(copy)}
    if profile:
        out["device_ms_by_kernel"] = device_ms_by_kernel(run)
    run()   # the result the caller compares
    torch.cuda.synchronize()
    return out


def cell_inputs(mx, synthetic, device, grid=CELL_GRID, ops=CELL_OPS,
                batches=CELL_BATCHES, chunk=CELL_CHUNK):
    """{"prefix": (state, batch, L), "full": (state, batch, None)}: the
    store route's last merge and the raw storm's last one (see above)."""
    T = grid * grid + ops
    storm = synthetic.cell_storm(grid, grid, ops, batches, seed=0)
    raw = [tuple(torch.as_tensor(x).to(device) for x in b) for b in storm]
    clone = lambda s: mx.MatrixCellState(  # noqa: E731
        **{k: v.clone() for k, v in s.fields().items()})
    st = mx.MatrixCellState.create(T, device)
    for b in raw[:-1]:
        mx.merge_cells_fused(st, *b)
    out = {"full": (clone(st), raw[-1], None)}
    recs = [np.concatenate(x) for x in zip(*storm)]
    fused, last = mx.merge_cells_fused, {}

    def keep_last(state, k, s, v, L=None, fww=False):
        last["prefix"] = (clone(state), (k, s, v), L)
        return fused(state, k, s, v, L, fww)

    mx.merge_cells_fused = keep_last
    try:
        store = mx.TensorMatrixStore(capacity=T, batch_size=chunk,
                                     device=device)
        store.apply_batch_columnar((recs[0] // grid).tolist(),
                                   (recs[0] % grid).tolist(),
                                   recs[2].tolist(), recs[1])
    finally:
        mx.merge_cells_fused = fused
    out.update(last)
    return out


def measure_cell(mx, synthetic, device="cuda", profile=False, **sizes):
    """K2's rows: prefix and full."""
    rows = []
    for spec, (state0, b, L) in cell_inputs(mx, synthetic, device,
                                            **sizes).items():
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        want = mx.merge_cells(state0, *b, L, False)
        z.record()
        work = mx.MatrixCellState(**{k: v.clone() for k, v in
                                     state0.fields().items()})
        t = time_in_place(lambda s: s.fields(), state0, work,
                          lambda w: mx.merge_cells_fused(w, *b, L=L),
                          profile)
        err = max(int((getattr(work, k).long() - getattr(want, k).long())
                      .abs().max()) for k in want.fields())
        rows.append({"kernel": "cell_merge", "spec": spec,
                     "T": state0.key.shape[0],
                     "L": state0.key.shape[0] if L is None else L,
                     "O": b[0].numel(), "live_in": int(state0.count),
                     "live_out": int(want.count), **t,
                     "plain_ms": a.elapsed_time(z), "max_abs_err": err})
    return rows


def serving_waves(tstore, synthetic, device, docs=TREE_DOCS, N=TREE_N,
                  waves=TREE_WAVES):
    """(engine, doc ids, (state before, wire args, o)): a
    ``TreeServingEngine`` through profile_tree.py's first ``waves`` waves
    (two dict waves, then record waves) and its last record wave's wire as
    it reached ``apply_tree_wire_fused``."""
    from fluidframework_tpu_torch.server.serving import TreeServingEngine
    from fluidframework_tpu_torch.server.tree_wire import encode_tree_batch

    ids = [f"t-{i}" for i in range(docs)]
    eng = TreeServingEngine(n_docs=docs, capacity=N, batch_window=10 ** 9,
                            sequencer="native", device=device)
    for d in ids:
        eng.connect(d, 1)
    rows = np.array([eng.doc_row(d) for d in ids], np.int32)
    ones, zeros = [1] * docs, [0] * docs
    wave_ops = [synthetic.profile_tree_waves(ids, w)[1]
                for w in range(waves)]
    captured, wire_fused = {}, tstore.apply_tree_wire_fused

    def keep_wire(state, *args, o):
        captured["wire"] = (state.clone(), args, o)
        return wire_fused(state, *args, o=o)

    tstore.apply_tree_wire_fused = keep_wire
    try:
        for w, ops in enumerate(wave_ops):
            if w < 2:
                eng.ingest_batch(ids, ones, [w + 1] * docs, zeros, ops)
            else:
                eng.ingest_records(None, ones, [w + 1] * docs, zeros,
                                   encode_tree_batch(ops), rows=rows)
        eng.sync()
    finally:
        tstore.apply_tree_wire_fused = wire_fused
    return eng, ids, captured["wire"]


def tree_inputs(tk, tstore, synthetic, device, docs=TREE_DOCS, N=TREE_N,
                waves=TREE_WAVES, served=None):
    """{"wire": (state, planes, base), "planes": (state, planes, None)}:
    the serving engine's last record wave (wire mode; its dense records and
    seq base) and the kernel-alone batch on the state the waves left.
    ``served``: a ``serving_waves`` result to reuse."""
    from fluidframework_tpu_torch.server.tree_wire import encode_tree_batch

    eng, ids, (before, args, o) = served or serving_waves(
        tstore, synthetic, device, docs, N, waves)
    cols, ids_, vals, row, pos, base = args[:6]
    dense = tk.expand_tree_wire(cols, ids_, vals, row, pos, *args[6:],
                                n_docs=docs, o=o)
    batch9 = encode_tree_batch(synthetic.profile_tree_waves(ids, 9)[1])
    planes = eng.store.pack_records(
        np.arange(docs, dtype=np.int64)[batch9["rec_op"]],
        eng._map_records(batch9["recs"], batch9),
        np.full(len(batch9["rec_op"]), 50, np.int64))
    return {"wire": (before, dense, base),
            "planes": (eng.store.state.clone(),
                       torch.from_numpy(planes).to(device), None)}


def expand_inputs(tstore, synthetic, device, docs=TREE_DOCS, N=TREE_N,
                  waves=TREE_WAVES, served=None):
    """{spec: (state before, wire args, o)}: the serving engine's last
    record wave as shipped (u16 ids and values at these table sizes) and,
    when it shipped u16 ids, the same records with ids and values widened
    to u32. ``served``: a ``serving_waves`` result to reuse."""
    _, _, (before, args, o) = served or serving_waves(
        tstore, synthetic, device, docs, N, waves)
    bits = 8 * args[1].element_size()
    out = {f"serving wave, u{bits} ids": (before, args, o)}
    if bits == 16:
        wide = [torch.from_numpy(x.cpu().numpy().astype(np.uint32))
                .to(args[1].device) for x in args[1:3]]
        out["serving wave, u32 ids"] = (before, (args[0], *wide, *args[3:]),
                                        o)
    return out


def saved_tree_inputs(tk, path, device):
    """K5 inputs saved with ``torch.save`` as {spec: (state planes by
    name, (9, D, O) records, base or None)} — ``chip_smoke.py --parent``
    saves the per-op, recovery and load paths' widest launches so that the
    parent's kernel is timed on them too."""
    return {spec: (tk.TreeState(**{k: v.to(device)
                                   for k, v in fields.items()}),
                   planes.to(device),
                   None if base is None else base.to(device))
            for spec, (fields, planes, base) in torch.load(path).items()}


def measure_tree(tk, ta, tstore, synthetic, device="cuda", profile=False,
                 saved=None, served=None, **sizes):
    """K5's rows: wire and planes, then the ``saved`` inputs."""
    rows = []
    inputs = tree_inputs(tk, tstore, synthetic, device, served=served,
                         **sizes)
    if saved:
        inputs.update(saved_tree_inputs(tk, saved, device))
    for spec, (state0, planes, base) in inputs.items():
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        if base is None:
            want = tk.apply_tree_planes(state0, planes)
        else:
            want = tk.apply_tree_batch(state0, *planes[:7],
                                       tk.wire_seq(planes[8], base),
                                       planes[7])
        z.record()
        work = state0.clone()
        t = time_in_place(lambda s: s.fields(), state0, work,
                          lambda w: ta.launch_apply(w, planes, base),
                          profile)
        err = max(int((getattr(work, k).long() - getattr(want, k).long())
                      .abs().max()) for k in want.fields())
        rows.append({"kernel": "tree_apply", "spec": spec,
                     "D": planes.shape[1], "N": state0.node_id.shape[1],
                     "O": planes.shape[2],
                     "records": int((planes[0] != 0).sum()), **t,
                     "plain_ms": a.elapsed_time(z), "max_abs_err": err})
    return rows


def expand_call(tk, wire, n_docs, o):
    """K6 through its entry point: a fresh (9, D, o) buffer (the plain
    version on CPU tensors)."""
    cols, ids, vals, row, pos = wire[:5]
    return tk.expand_tree_wire_fused(cols, ids, vals, row, pos, *wire[6:],
                                     n_docs=n_docs, o=o)


def measure_expand(tk, tstore, synthetic, device="cuda", profile=False,
                   served=None, **sizes):
    """K6's rows: the serving wave at u16 and at u32 ids."""
    rows = []
    for spec, (before, wire, o) in expand_inputs(
            tstore, synthetic, device, served=served, **sizes).items():
        D = before.node_id.shape[0]
        cols, ids, vals, row, pos = wire[:5]
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        want = tk.expand_tree_wire(cols, ids, vals, row, pos, *wire[6:],
                                   n_docs=D, o=o)
        z.record()
        fn = lambda: expand_call(tk, wire, D, o)  # noqa: E731
        t = {"ms": _graph_ms(fn, 50), "call_ms": _eager_ms(fn)}
        if profile:
            t["device_ms_by_kernel"] = device_ms_by_kernel(fn)
        got = fn()
        torch.cuda.synchronize()
        rows.append({"kernel": "tree_expand", "spec": spec, "D": D, "o": o,
                     "R": cols.shape[0], "ids": str(ids.dtype), **t,
                     "plain_ms": a.elapsed_time(z),
                     "max_abs_err": int((got.long() - want.long()).abs()
                                        .max())})
    return rows


def map_inputs(mk, synthetic, device, D=MAP_D, K=MAP_K, O=MAP_O,
               wide_d=MAP_WIDE_D):
    """{spec: (state, mode, args)}: dense (D, O) batches (mode "dense": the
    four op planes) at D and at ``wide_d`` docs, as ``chip_smoke.py``'s map
    phase times them (``map_raw_batches``, seed = the doc count), and
    config #2's packed serving batch (mode "packed": buffer, R, O, wide
    values; every row, in order). Each state starts zeroed."""
    out = {}
    for d in (D, wide_d):
        planes = synthetic.map_raw_batches(d, K, O, 1, seed=d)[0]
        out[f"dense, D = {d}"] = (
            mk.MapState.create(d, K, device), "dense",
            tuple(torch.as_tensor(p).to(device) for p in planes))
    kind, kidx, _, vidx, _ = synthetic.map_serving_batch(D, O, 0, n_keys=K)
    buf, wide = mk.pack_map_batch(kind, kidx, vidx + 1,
                                  np.arange(D, dtype=np.int32) * O,
                                  np.arange(D, dtype=np.int32))
    out["packed, config #2 serving"] = (
        mk.MapState.create(D, K, device), "packed",
        (torch.as_tensor(buf).to(device), D, O, wide))
    return out


def map_call(mk, mode, state, args, plain=False):
    """K1 through its entry point on ``state`` in place (the plain version
    on CPU tensors), or the plain version's new state."""
    if mode == "dense":
        fn = mk.apply_map_batch if plain else mk.apply_map_batch_fused
    else:
        fn = mk.map_columnar_apply if plain else mk.map_columnar_apply_fused
    return fn(state, *args)


def measure_map(mk, synthetic, device="cuda", profile=False, **sizes):
    """K1's rows: dense at two doc counts and the packed serving batch.
    The kernel reads no state and writes the same planes on every call, so
    the calls are timed back to back on one state."""
    rows = []
    for spec, (state0, mode, args) in map_inputs(mk, synthetic, device,
                                                 **sizes).items():
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        want = map_call(mk, mode, state0, args, plain=True)
        z.record()
        fn = lambda: map_call(mk, mode, state0, args)  # noqa: E731
        t = {"ms": _graph_ms(fn, 50), "call_ms": _eager_ms(fn)}
        if profile:
            t["device_ms_by_kernel"] = device_ms_by_kernel(fn)
        torch.cuda.synchronize()
        D, K = state0.present.shape
        rows.append({"kernel": "map_apply", "spec": spec, "D": D, "K": K,
                     "O": args[2] if mode == "packed" else args[0].shape[1],
                     **t, "plain_ms": a.elapsed_time(z),
                     "max_abs_err": max(
                         int((getattr(state0, k).long()
                              - getattr(want, k).long()).abs().max())
                         for k in mk.PLANES)})
    return rows


def launch_floor(profile=False):
    """The card's launch floor: ``x.add_(1)`` on one int32, timed as the
    kernels are (a yardstick; the port never calls it)."""
    x = torch.zeros(1, dtype=torch.int32, device="cuda")
    fn = lambda: x.add_(1)  # noqa: E731
    t = {"ms": _graph_ms(fn, 50), "call_ms": _eager_ms(fn)}
    if profile:
        t["device_ms_by_kernel"] = device_ms_by_kernel(fn)
    return {"kernel": "launch_floor", "spec": "x.add_(1), one int32", **t,
            "max_abs_err": 0}


def save_inputs(path, launches) -> None:
    """Save kernel inputs with ``torch.save`` as {key: (state planes by
    name, op planes)}, on the CPU. ``launches`` maps each key to (a
    ``StringState``, its op tensors): K3 / K4 keys are (kernel, spec) —
    for K3 the seven op planes, for K4 kind, pos, client and ref_seq —
    and K7 keys a spec, with the seven op planes."""
    torch.save({key: ({k: v.cpu() for k, v in st.fields().items()},
                      [o.cpu() for o in ops])
                for key, (st, ops) in launches.items()}, path)


def saved_inputs(mt, path, device):
    """{(kernel, spec): (state, op planes)} on ``device`` from a file of
    ``save_inputs``."""
    return {key: (mt.StringState(**{k: v.to(device)
                                    for k, v in fields.items()}),
                  [o.to(device) for o in ops])
            for key, (fields, ops) in torch.load(path).items()}


def axis_launch(ak, kernel, state, ops):
    """The kernel's entry point: K3 updates ``state`` in place; both
    return the (run, off) outputs. On CPU tensors: the plain versions."""
    if kernel == "axis_apply":
        return ak.apply_axis_batch_fused(state, *ops)
    return ak.resolve_axis_fused(state, *ops)


def axis_plain(ak, kernel, state, ops):
    """(state after, run, off) of the plain version; K4 leaves the state
    alone and answers -1 where the kind is not AXIS_RESOLVE."""
    if kernel == "axis_apply":
        return ak.apply_axis_batch(state, *ops)
    kind, pos, client, ref = ops
    run, off = ak.resolve_axis_positions(state, pos, client, ref)
    res = kind == AXIS_RESOLVE
    return state, torch.where(res, run, -1), torch.where(res, off, -1)


def axis_err(mt, got, want) -> int:
    """Largest difference over every plane (slots past count included),
    count, overflow and both outputs."""
    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    (st, run, off), (ref, rr, ro) = got, want
    return max([diff(getattr(st, k), getattr(ref, k)) for k in mt.FIELDS]
               + [diff(run, rr), diff(off, ro)])


def measure_axis(mt, ak, path, kernels=AXIS_KERNELS, device="cuda",
                 profile=False):
    """K3 / K4 rows on the saved inputs of ``path``."""
    rows = []
    for (kernel, spec), (state0, ops) in saved_inputs(
            mt, path, device).items():
        if kernel not in kernels:
            continue
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        want = axis_plain(ak, kernel, state0, ops)
        z.record()
        work = mt.StringState(**{k: v.clone()
                                 for k, v in state0.fields().items()})
        out = {}

        def launch(w):
            out["run_off"] = axis_launch(ak, kernel, w, ops)

        if kernel == "axis_apply":
            t = time_in_place(lambda s: s.fields(), state0, work, launch,
                              profile)
        else:
            fn = lambda: launch(work)  # noqa: E731
            t = {"ms": _graph_ms(fn), "call_ms": _eager_ms(fn)}
            if profile:
                t["device_ms_by_kernel"] = device_ms_by_kernel(fn)
            fn()
            torch.cuda.synchronize()
        D, S = state0.seq.shape
        rows.append({"kernel": kernel, "spec": spec, "D": D, "S": S,
                     "O": ops[0].shape[1], **t,
                     "plain_ms": a.elapsed_time(z),
                     "max_abs_err": axis_err(mt, (work, *out["run_off"]),
                                             want)})
    return rows


def megadoc_windows(synthetic, D=MEGA_D, O=MEGA_O, windows=MEGA_WINDOWS,
                    seed=0):
    """The megadoc phase's op windows: (D, O) int32 numpy planes by field
    name, in order (columns of one ``megadoc_storm``)."""
    planes = synthetic.megadoc_storm(D, O * windows, seed)
    return [{k: np.ascontiguousarray(v[:, w * O:(w + 1) * O])
             for k, v in planes.items()} for w in range(windows)]


def megadoc_rebalance(mgk, state, S=MEGA_S):
    """The phase's preemptive rebalance: once a shard passes
    ``MEGA_REBALANCE`` of S (and nothing overflowed)."""
    if int(state.count.max()) > MEGA_REBALANCE * S and \
            not bool(state.overflow.any()):
        return mgk.rebalance_megadoc(state)
    return state


def megadoc_bound(D, n, S, O, K):
    """(ms, bytes): the least time for one launch, bound by bytes: the
    state planes (7 + K a slot) and count / overflow in and out once, the
    op planes in once, at the card's memory rate."""
    nbytes = 2 * (7 + K) * 4 * D * n * S + 2 * 2 * 4 * D * n + 7 * 4 * D * O
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def megadoc_inputs(mt, mgk, synthetic, device="cuda"):
    """(state, op tensors) of the megadoc kernel loop's widest launch: K7
    grows the docs window by window until every doc holds more than
    ``MEGA_TARGET`` active slots; the input of the last of those
    windows."""
    st = mgk.create_megadoc_state(MEGA_D, MEGA_S, MEGA_N, MEGA_K, device)
    for planes in megadoc_windows(synthetic):
        st = megadoc_rebalance(mgk, st)
        ops = tuple(torch.from_numpy(planes[k]).to(device)
                    for k in mt.OP_FIELDS)
        before = _clone(mt, st)
        mgk.apply_megadoc_batch(st, *ops)
        if int(st.count.sum(dim=1).min()) > MEGA_TARGET:
            return before, ops
    raise AssertionError("the megadoc corpus ran out before every doc held "
                         f"{MEGA_TARGET} active slots")


def measure_megadoc(mt, mgk, synthetic, device="cuda", profile=False,
                    saved=None):
    """K7's rows: the widest launch of the megadoc kernel loop, or each
    launch saved in ``saved`` (a file of ``save_inputs``)."""
    if saved:
        launches = saved_inputs(mt, saved, device)
    else:
        launches = {"widest": megadoc_inputs(mt, mgk, synthetic, device)}
    rows = []
    for spec, (state0, ops) in launches.items():
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        want = mgk.apply_megadoc_plain(state0, *ops)
        z.record()
        work = _clone(mt, state0)
        t = time_in_place(lambda s: s.fields(), state0, work,
                          lambda w: mgk.apply_megadoc_batch(w, *ops),
                          profile)
        err = max(int((getattr(work, k).long() - getattr(want, k).long())
                      .abs().max()) for k in mt.FIELDS)
        D, n = state0.count.shape
        S = state0.seq.shape[1] // n
        K = state0.prop_val.shape[2]
        O = ops[0].shape[1]
        bound_ms, nbytes = megadoc_bound(D, n, S, O, K)
        rows.append({"kernel": "megadoc_apply", "spec": spec, "D": D,
                     "n": n, "S": S, "O": O, "K": K,
                     "active_slots_min": int(state0.count.sum(dim=1).min()),
                     **t, "plain_ms": a.elapsed_time(z), "bound_ms": bound_ms,
                     "bound_by": "bytes", "bytes": nbytes,
                     "max_abs_err": err})
        del want, work
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose fluidframework_tpu_torch is timed")
    ap.add_argument("--kernel", default="string_apply",
                    help="comma-separated: " + ", ".join(KERNELS))
    ap.add_argument("--tree-inputs", default=None,
                    help="tree_apply: also time K5 on the inputs saved in "
                         "this file (chip_smoke.py --parent writes it)")
    ap.add_argument("--axis-inputs", default=None,
                    help="axis_apply / axis_resolve: the K3 / K4 inputs "
                         "saved in this file (chip_smoke.py --parent "
                         "writes it)")
    ap.add_argument("--megadoc-inputs", default=None,
                    help="megadoc_apply: time K7 on the inputs saved in "
                         "this file (chip_smoke.py --parent writes it)")
    ap.add_argument("--profile", action="store_true",
                    help="K1 - K7 rows: add each launched kernel's device "
                         "ms (torch.profiler)")
    args = ap.parse_args(argv)
    kernels = args.kernel.split(",")
    if set(kernels) - set(KERNELS):
        ap.error(f"--kernel: one or more of {', '.join(KERNELS)}")
    axis = [k for k in kernels if k in AXIS_KERNELS]
    if axis and not args.axis_inputs:
        ap.error("--kernel axis_apply / axis_resolve need --axis-inputs")
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    from fluidframework_tpu_torch.ops import map_kernel as mk
    from fluidframework_tpu_torch.ops import matrix_kernel as mx
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops import tree_store as tstore
    from fluidframework_tpu_torch.testing import synthetic

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rows = []
    if "string_apply" in kernels:
        for S in CAPACITIES:
            for spec, _, _ in SPECS:
                rows.append(measure(mt, sk, synthetic, DOCS, S, OPS, spec))
    if "cell_merge" in kernels:
        rows += measure_cell(mx, synthetic, profile=args.profile)
    if "map_apply" in kernels:
        rows += measure_map(mk, synthetic, profile=args.profile)
    served = None
    if {"tree_apply", "tree_expand"} & set(kernels):
        served = serving_waves(tstore, synthetic, "cuda")
    if "tree_apply" in kernels:
        rows += measure_tree(tk, ta, tstore, synthetic,
                             profile=args.profile, saved=args.tree_inputs,
                             served=served)
    if "tree_expand" in kernels:
        rows += measure_expand(tk, tstore, synthetic, profile=args.profile,
                               served=served)
    del served
    if axis:
        rows += measure_axis(mt, ak, args.axis_inputs, axis,
                             profile=args.profile)
    if "megadoc_apply" in kernels:
        from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
        rows += measure_megadoc(mt, mgk, synthetic, profile=args.profile,
                                saved=args.megadoc_inputs)
    if {"map_apply", "tree_expand"} & set(kernels):
        rows.append(launch_floor(args.profile))
    bad = 0
    for row in rows:
        row.setdefault("kernel", "string_apply")
        row.update(root=os.path.abspath(args.root), card=card)
        print(json.dumps(row), flush=True)
        bad += row["max_abs_err"] != 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
