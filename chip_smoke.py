#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / H100 port (``fluidframework_tpu_torch``).

Drives the port's paths once at full width — BASELINE config #4
(SharedString ops sequenced by Deli and merged into a (doc × segment)
merge-tree state on the card), config #2 (SharedMap), config #3 (the
SharedMatrix cell table, then the whole matrix engine), SharedTree
serving at ``benches/profile_tree.py``'s shapes and container clients on
the in-process service — and holds each
hand-written kernel against its plain PyTorch version. Phases (one JSON line each):

1. device — card name, count, ``nvidia-smi`` name and power limit, build
   seconds and the ``-Xptxas -v`` report: registers, stack-frame and
   spill-store bytes of every instantiation (the kernel sources are built
   with one nvcc each and the native sequencer and durable log with one
   g++ each, all in parallel, into the package's git-ignored build
   directory);
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
   launches by shape;
6. map — BASELINE config #2 (1,024 maps × 64 key slots, 64 ops per map
   per batch, set:delete:clear = 8:2:1): its 64 raw batches chained
   through the map kernel (``csrc/map_apply.cu``) and the plain version
   on the card (all planes equal after every batch); a
   ``MapServingEngine`` on the card with the native sequencer takes 12
   columnar batches (warm-up + 11 timed; zero nacks, planes equal a
   ``device="cpu"`` engine fed the same batches, ops/s), then 320 per-op
   submits with clears on 16 maps (reads equal the CPU engine's), a full
   and an incremental summary and a load of each on the card (reads, and
   the incremental load's digests, equal the live engine's). The kernel
   is timed dense at D=1,024 and D=10,240 and packed at config #2, each
   row with its launches on the paths, beside the card's launch floor (a
   one-element ``x.add_(1)`` timed the same way);
7. matrix_cells — BASELINE config #3 (a 1,024 × 1,024 grid, 8 batches of
   65,536 set-cell ops, capacity rows·cols + O): the batches through the
   cell merge kernel (``csrc/cell_merge.cu``) in full mode against the
   plain version on the card, then the same 524,288 records through
   ``TensorMatrixStore.apply_batch_columnar`` (batch 4,096: 128 prefix
   merges) against a store whose merges run the plain version, a
   first-writer-wins storm, and ``snapshot_delta`` / ``apply_delta`` /
   ``restore`` on the card equal to the live store. Both modes are timed;
8. matrix_engine — SharedMatrix served end to end by
   ``MatrixServingEngine`` (config #3): (a) the reference bench's serving
   shape (64 docs, each a 32 × 32 grid, cell capacity 1 << 17, axis
   capacity 128, a warm-up and 6 storms of 4,096 setCells through
   ``ingest_cells``); (b) config #3's 1,024 × 1,024 grid in one doc, both
   axes built by 64 concurrent inserts of 16 from 4 clients, then 8 storms
   of 65,536 setCells; (c) 3 per-op concurrent waves on (a)'s engine (4
   clients a doc, 128 ops a doc a flush, ref_seq lagging by up to 16, FWW
   on a quarter of the docs). Each engine equals a ``device="cpu"``
   engine fed the same inputs (dims, every axis plane slot, the cell
   table, 4,096 sampled cells, ``to_lists`` of (a)'s docs); then full and
   incremental summaries of both card engines load on the card and equal
   the live engine. Every launch of the axis kernels (``csrc/
   axis_apply.cu``: K3 ``axis_apply``, K4 ``axis_resolve``) on these
   paths is held against its plain version on its own input, and each is
   timed on its widest launch of every path. The line reports the ops/s of (a) and (b) and their host seconds
   by part (sequencing, resolve, FWW filter, cell merge, log);
9. tree — SharedTree served end to end at ``benches/profile_tree.py``'s
   shapes (8,192 docs, capacity 128, the native sequencer): (a) the tree
   record scan (``csrc/tree_apply.cu``: K5 ``tree_apply``) against the
   plain ``apply_tree_planes`` on 4 chained ``tree_record_storm`` batches
   of 64 records a doc (every kind, docs overflowing), and the same
   records through the wire at u16 and u32 id widths (K6 ``tree_expand``
   + K5 wire mode) against the plain ``apply_tree_wire``; (b)
   ``TreeServingEngine``: profile_tree.py's warm-up, dict, serial record
   and 4 pipelined record waves, then 4 pipelined flat leaf waves on a
   second engine, each equal to a ``device="cpu"`` twin (all planes,
   sampled ``to_dict``), with ops/s per path and the ingest stages' busy
   ms; (c) a 256-doc ``tree_op_storm`` through per-op ``submit`` (3
   clients, lagging refs) and through ``ingest_batch``, equal to a CPU
   twin; (d) a capacity-32 engine grown until docs overflow, recovered
   (re-uploads and graduations) equal to a capacity-1,024 control, then
   full and incremental summaries loaded on the card equal to the live
   engine, and a dup-acked resubmit; (e) K5 (wire mode at the serving
   wave's shape, planes mode at profile_tree.py's kernel-alone shape, and
   the launch with the most records of each of the per-op, recovery and
   load paths, kept as the engines made it) and K6 (the serving wave as
   shipped, u16 ids, and widened to u32) timed in CUDA graphs beside their
   plain versions and bounds;
10. megadoc — the mega tier (long documents split into 8 shards, one
   thread-block cluster of K7 ``megadoc_apply``, ``csrc/megadoc_apply.cu``,
   a doc): (a) 64 mega docs × 8 shards × 4,096 slots (K = 4) grown by
   windows of 512 ``megadoc_storm`` ops, rebalanced whenever a shard passes
   75 %, until every doc holds more than 16,384 active slots, compacted
   and taken 2 windows further, every K7 launch equal to the plain version
   on its input (all planes), the widest launch timed beside its bound;
   (b) ``StringServingEngine(mega_docs=16, mega_capacity_per_shard=4096)``
   fed per-op submits from 4 clients a doc (lagging refs, inserts, removes,
   annotates) until every doc passes 8,192 active slots, its texts and
   sampled properties equal a ``device="cpu"`` twin fed the same stream
   for 2 docs, ops/s, and the same plan replayed on a second card engine
   with every K7 launch against the plain version; (c) its summary loaded
   on the card, a small engine's summary with a ``markMega`` in the log
   tail loaded, a mega overflow that re-uploads and one that graduates
   (every K7 launch against the plain version), and a mega doc at the engine's
   shape (``mega_capacity_per_shard=4096``, compaction off) whose history
   of tombstone churn passes 8 × 4,096 slots while its live text stays
   inside the tier: recovered through K7 (a one-doc mega rebuild on a
   wider layout) as ``reuploaded``, its text equal to the shadow text
   (its CPU twin was cut to keep the script inside its time limit). The
   line reports each part's seconds,
   K7's launches by path, ``cudaOccupancyMaxActiveClusters``, the cluster
   waves and per-op time of each timed launch and its ptxas registers and
   spills;
11. intervals — config #4's serving shape (10,240 docs, S=512,
   compact_every=1, the native sequencer) with the interval docs' base
   text in every doc and 4 intervals with props on every 10th (1,024
   docs, ``add_intervals_bulk``): (a) a warm-up wave, heartbeats on 64
   interval docs, 2 pipelined waves, heartbeats, 2 more
   (``synthetic.interval_wave``: annotate 50 %, insert 30 %, remove 20 %,
   refs pinned at each wave's first seq, so floors cross the previous
   wave's tombstones mid-wave and each wave is cut into segments, one
   string_apply launch each, the crossing docs' anchors slid off one row
   gather after their segment); every launch of the last wave against the
   plain version (all planes); 64 sampled docs (32 with intervals)
   against a ``device="cpu"`` engine fed the same rows (texts, planes and
   digest with payload handles ranked per doc, every interval's endpoints
   and props); the same waves on a second card engine with no intervals;
   (b) a 1,024-doc engine at capacity 128, intervals on every doc, fed
   waves (inserts only on every 16th) until docs overflow, heartbeats,
   ``recover_overflowed`` (re-uploads and graduations) and one graduated
   doc regrown, equal to a ``device="cpu"`` twin that recovers the same
   way (reports, texts, digests, anchors, endpoints); (c) a full and an
   incremental summary of both engines loaded on the card, their
   intervals equal to the live engine's and the next interval id going
   on. The line reports each wave's wall, segments and their widths,
   slide gathers and launches by width beside the bare engine's walls,
   the unfused compactions' device ms and host s, and (b)'s and (c)'s
   seconds;
12. mesh — doc-sharded and replicated state (``parallel/``) on a mesh of
   4 doc shards all on the card (the card named 4 times) and on the mesh
   of every card present: (a) config #4 (10,240 docs, S=512, 64 ops a
   doc, compact_every=1) served sharded, a warm-up and 3 waves, every
   doc's digest equal to the unsharded engine's on the card and
   ``string_apply`` launched once a shard each wave; a 512-doc sharded
   card engine equal to its twin on 4 CPU shards; the summary loaded
   sharded and unsharded, digest-equal; (b) the replicated step (2
   replicas × 2 doc shards, 10,240 docs, S=384): ``agree`` 1 and digests
   equal to one B1 apply, ``agree`` 0 with ``inject_divergence``; (c) the
   map (config #2's batches), tree (profile_tree.py's waves at 8,192 docs)
   and matrix (64 docs of 32 × 32, 2 storms of 4,096 setCells) engines
   sharded against unsharded, with K1-K5 launched on every shard; (d) the
   collective-free check (no tensor moves between devices in a sharded
   apply). The line reports the wall a wave sharded and unsharded, B1's
   launches a wave, the load seconds and the launches a shard of each
   kernel; the kernels line carries them as ``mesh_launches_per_shard``;
13. durable — config #4 on the durable op log (``server/oplog.py``,
   ``server/native_oplog.py`` + ``native/oplog.cpp``, built with g++
   beside the kernels): (a) 10,240 docs, S=512, O=64 served by an engine
   on ``NativePartitionedLog(tmpdir, 8)`` with ``sync()`` after every
   batch and by one on the in-memory log, fed the same batches in turns
   (2 rounds of a warm-up and 5 timed batches): ops/s of both and their
   ratio, the bytes and the sync of every batch, and the filesystem the
   directory lies on (an fsync on tmpfs is no durability figure); (b) a
   child process (``testing/durable_drill.py``) serves the same config on
   the card, summarizes after batch 2 and is SIGKILLed inside the log
   append of batch 4, as soon as the partition file grows (the frame is
   left torn, or whole if the write won the race: one of the two must
   show); the directory is reopened (a torn tail truncated) and the
   summary loaded on the card, the tail replayed through string_apply:
   every doc equals an engine on the card that applied exactly the
   batches on disk (every acked batch; the killed one only whole) by a
   digest with payloads ranked by text, doc seqs and sampled texts, and
   512 docs equal a ``device="cpu"`` twin; (c) the JSONL spill at 512
   docs: recovery verifies the chain, the load on the card equals the
   live engine, one flipped bit (``faultpoints.corrupt_bitflip``) is
   refused at the record that holds it, and the summary anchor refuses a
   truncation at a record boundary. string_apply's launches on these
   paths are ``durable_launches`` in the kernels line;
14. door — config #4's 10,240 docs served from 10 TCP clients through the
   columnar front door (``server/columnar_ingress.py``, the native frame
   decode ``native/ingress.cpp``): 9 clients send one insert of ``"w{k}"``
   at 0 a doc a wave, one sends inserts, removes and annotates, 24 waves
   (245,760 ops), windows of 4,096 rows at 2 ms, pipeline depth 3, the
   native sequencer, S=512. Every op is acked once with seq > 0, each doc's
   text is its client's, string_apply launches at least once a window, the
   door's decode tier is native, and the door engine's planes, payload
   table and digests equal a second engine on the card fed the door's
   windows directly through ``ingest_planes``; the first launch of each
   specialisation is held against the plain version. Then 4 waves through
   an ``AdmissionController`` whose tenant budget sheds ops, resubmitted
   by the clients after the hint, every op acked once. The line reports
   ops/s, windows, ``drain_stats()``, ``pipeline_stats()``, the stage
   latency p50 / p99, string_apply's launches and device ms, the hot-doc
   gauges and a capacity census; a second line the admission run;
15. readplane — the read plane (``server/read_plane.py``,
   ``server/observer.py``) behind the same door storm, 24 waves and a
   2-wave tail, every wave held at a gate until the one before it is
   acked: a ``ReadPlane`` on the door's engine encodes one window a log
   append, an ``ObserverHub`` behind an ``ObserverDoor`` fans it to 3
   ``ResilientObserver``s over TCP (each socket lost twice inside a
   window run while the storm flows, and killed once while idle) and 64
   in-process sinks; a ``ReadReplica`` on the card, anchored after
   the joins, is polled at every gate; generations are saved after waves
   12 and 24. Every observer applies every op once with its doc seqs the
   sequencer's, every sink gets the same bytes object a window, no string
   window is a JSON frame, the replica equals the leader (payload handles
   ranked by text), the generation diff plus the tail reads as a load of
   the newer generation and as the live engine, the catch-up rung answers
   ``diff_ok``, and B1's first launch in the replica and in the catch-up
   equals the plain version. The line reports the windows, encode and
   publish ms a window (1 and 64 subscribers), the hub's delivery p99
   and the replica's drain-lag p99, reconnects and torn windows,
   the replica's polls, ops/s and B1 launches, and the catch-up's diff ms
   against a full replay from the older generation;
16. service — the in-process Tinylicious service with its device replica
   (``server/serving_service.py``): ``ServingLocalService(n_docs=10240,
   capacity=512, n_props=8, batch_window=64, compact_every=16,
   n_partitions=4)`` on the card serves config #4's 10,240 docs
   (``svc00000`` ...) to 20,480 container clients
   (``testing/service_session.py``: a turn-mode editor and an immediate
   viewer a doc, ``examples/shared_text.py``'s schema), 4 seeded rounds of
   1-3 editor edits (typing inserts 70 %, removes 15 %, annotates of 8
   keys 15 %, none in the first round) and one viewer edit crossing them,
   the title set once, a compressed 6,000-char paste in one doc of 64 and
   a chunked 20,000-char one in one of 1,024. Every ``flush_replica``
   merges the string channels through B1, every 16th compacts. Checks:
   every doc's server read equals both clients; ``get_properties`` at 4
   seeded positions of 1,024 docs equals the editor's; one served
   channel a doc, nothing dropped, nacked or left pending; the store on
   the card, B1 launched once an op window of every flush in both its
   modes, the first launch of each held against the plain version; the
   same session on 256 docs through a card service and a ``device="cpu"``
   twin equal under the parity contract after every apply and
   compaction (a props switch and a compaction crossed). The line
   reports string ops merged a second, the wall and the open time,
   wire ops against runtime ops and the compressed and chunked
   envelopes, flushes, B1 launches and call ms (CUDA events: mean, p99),
   compactions, summaries acked and host seconds by part (client stack,
   sequencing, lambdas, the replica's decode, flush and compaction,
   reads).

With ``--parent DIR`` (another checkout, e.g. an archive of the parent
commit) a last phase, parent_timing, times K1-K7 of DIR and of this
checkout in turns (parent, change, change, parent) with
``testing/kernel_timing.py`` at the shapes it defines (and the launch
floor beside K1 / K6) and at the widest launches the tree,
matrix_engine and megadoc phases saved, and the ``map_apply``,
``cell_merge``, ``axis_apply``, ``axis_resolve``, ``tree_apply``,
``tree_expand`` and ``megadoc_apply`` rows get ``parent_ms`` (null
without it). The ``axis_apply`` and
``axis_resolve`` entries also carry their ptxas report (registers,
spills) and the eager ``call_ms`` beside the graph ``ms``.

Then the ``nvidia-smi`` line, a ``{"kernels": [...]}`` line (the eight
kernels: ``string_apply``, ``map_apply``, ``cell_merge``, ``axis_apply``,
``axis_resolve``, ``tree_apply``, ``tree_expand``, ``megadoc_apply``, each
with its launches
on its own paths, every count set to 0 just before a path and read just
after: config #4 serving; config #2's kernel loop and its serving route;
config #3's kernel loop, the store route and the matrix engine's paths;
the tree phase's kernel loop, serving, flat serving, per-op, recovery and
load paths; the megadoc phase's kernel loop and engine, and its summary /
recovery path beside them; the interval phase's serving and recovery paths
as ``string_apply``'s ``interval_launches`` and
``interval_recovery_launches``; the durable phase's as its
``durable_launches``; the door phase's as ``door_launches``; the
readplane phase's as ``readplane_launches`` (the storm's, leader and
replica, of which the replica's, and the catch-up's); the service
phase's as ``service_launches`` (the 10,240-doc session's, and its card
twin's apart); and ``launches`` is the serving path's
(``serving_launches``), the door phase's, the readplane phase's and the
service session's together), and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase raises, so
the exit code is non-zero. Without a card it exits 2 and prints no result.

Usage: ``python3 chip_smoke.py [--parent DIR]`` (one card).
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
D_STRING = D                # config #4's doc count, a map timing shape
MAP_D, MAP_K, MAP_O = 1024, 64, 64   # config #2: maps × key slots × ops
MAP_RAW_BATCHES = 64        # config2_map_storm.py's kernel loop
MAP_SERVE_BATCHES = 12      # its serving loop: warm-up + 11 timed
MAP_PER_OP = 320            # per-op submits across 16 maps
MX_GRID, MX_OPS, MX_BATCHES = 1024, 1 << 16, 8   # config #3
MX_STORE_BATCH = 4096       # TensorMatrixStore's default chunk
MX_DOCS, MX_DOC_GRID = 64, 32          # config #3's serving shape
MX_SERVE_STORMS = 6                    # timed storms after a warm-up
MX_CELL_CAP_A, MX_AXIS_CAP_A = 1 << 17, 128
MX_BIG_STORMS = 8                      # 8 × 65,536 = 524,288 setCells
MX_WAVE_OPS, MX_WAVES = 128, 3         # (c): ops per doc per flush
MX_SAMPLES = 4096                      # get_cell probes per check
RESOLVE, NOOP = 13, 12                 # OpKind.AXIS_RESOLVE, OpKind.NOOP
# the op bytes an axis window slot needs by kind: an insert reads all 7
# planes, a remove all but a2, a resolve kind/a0/client/ref_seq, any
# other kind (NOOP) only its kind
AXIS_OP_BYTES = {0: 28, 1: 24, RESOLVE: 16}


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


def timed_events(fn, reps):
    """Mean ms of ``reps`` calls of ``fn`` bracketed by CUDA events (after
    one warm-up call)."""
    import torch
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


def graph_ms(fn, reps):
    """Mean ms per call of ``fn`` as the card runs it back to back: ``reps``
    calls captured in one CUDA graph, one replay between CUDA events. The
    host's enqueue, longer than these kernels, is left out."""
    import torch
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


def work_bound(nbytes, n_ops):
    """(ms, "bytes" or "operations"): the least time for a function that
    must move ``nbytes`` and do ``n_ops`` int32 operations, the larger of
    the two at the card's peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def string_bound(S, props, compact, work, d=D, o=O):
    """B1's least time for the same work: bytes each read / written once
    vs int32 operations (one per visible slot per op) at peak rate.
    ``work``: (real ops, mean count the ops see) of each batch. Returns
    (ms, "bytes" or "operations", bytes)."""
    k = K if props else 0
    nbytes = (2 * (7 + k) * d * S * 4 + 7 * d * o * 4 + 2 * 2 * d * 4
              + (d * 4 if compact else 0))
    n_ops = sum(n * int(c) + n for n, c in work)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / len(work) / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def map_bound(kind, a0, op_bytes, n_keys):
    """K1: the op input read once and the state planes written once where
    the batch writes them: every slot of a row with a clear, and each
    slot a set or delete touches. The function never reads the state (an
    untouched slot keeps its value in place)."""
    import torch
    from fluidframework_tpu_torch.ops.schema import OpKind
    keyed = ((kind == int(OpKind.MAP_SET))
             | (kind == int(OpKind.MAP_DELETE)))
    hit = ((a0.long()[:, :, None]
            == torch.arange(n_keys, device=a0.device)) & keyed[:, :, None])
    written = int((hit.any(1) | (kind == int(OpKind.MAP_CLEAR))
                   .any(1, keepdim=True)).sum())
    nbytes = op_bytes + 3 * 4 * written
    b_ms, b_by = work_bound(nbytes, kind.numel() + written)
    return {"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "slots_written": written}


def cell_bound(live_in, live_out, n):
    """K2: the live cells read before and written after (the EMPTY tail
    is EMPTY on both sides), the batch read once, count / overflow read
    and written; a comparison sort of the batch and one merge. Returns
    (ms, bound_by, bytes)."""
    nbytes = 3 * 4 * (live_in + live_out + n) + 4 * 4
    n_ops = live_in + n + n * max(n - 1, 1).bit_length()
    return (*work_bound(nbytes, n_ops), nbytes)


def axis_apply_bound(before, ops, after):
    """K3: the live extent of the 7 planes read before and written after,
    count / overflow, the ops by kind and the two (D, O) outputs; one
    visible-slot pass an op. Returns (ms, bound_by, bytes, int ops)."""
    D, _ = before.seq.shape
    O = ops[0].shape[1]
    real = (ops[0] != NOOP).sum(dim=1).long()
    hi_in, hi_out = _live_extent(before), _live_extent(after)
    nbytes = int(7 * 4 * (hi_in + hi_out).sum()) + 4 * 4 * D + \
        _axis_op_bytes(ops[0]) + 2 * 4 * D * O
    n_ops = int((real * (before.count.long() + after.count.long())
                 ).sum()) // 2
    return (*work_bound(nbytes, n_ops), nbytes, n_ops)


def axis_resolve_bound(st, kind, pos, client, ref):
    """K4: the resolves' inputs and the two outputs, the live planes read
    once; the search walk each resolve needs. Returns (ms, bound_by,
    bytes, int ops)."""
    import torch
    D, _ = st.seq.shape
    O = kind.shape[1]
    is_res = kind == RESOLVE
    nbytes = _axis_op_bytes(torch.where(is_res, RESOLVE, NOOP)) + \
        2 * 4 * D * O + 7 * 4 * int(st.count.long().sum()) + 4 * D
    n_ops = _resolve_walk(st, kind, pos, client, ref)
    return (*work_bound(nbytes, n_ops), nbytes, n_ops)


def map_phase(smi, dev):
    """Phase 6: BASELINE config #2 at full width (1,024 maps × 64 key
    slots, 64 ops per doc per batch, set:delete:clear = 8:2:1). Returns the
    ``map_apply`` kernels-line entry."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import map_apply as mak
    from fluidframework_tpu_torch.ops import map_kernel as mk
    from fluidframework_tpu_torch.ops.schema import OpKind
    from fluidframework_tpu_torch.server.serving import MapServingEngine
    from fluidframework_tpu_torch.testing import kernel_timing, synthetic
    from fluidframework_tpu_torch.testing.synthetic import (
        map_raw_batches, map_serving_batch,
    )

    t_phase = time.perf_counter()
    D, K, O = MAP_D, MAP_K, MAP_O

    def diff(a, b):
        return max(int((getattr(a, k).long() - getattr(b, k).long())
                       .abs().max()) for k in mk.PLANES)

    # raw loop: 64 chained batches through the kernel and the plain version
    raw = [tuple(torch.as_tensor(p).to(dev) for p in b)
           for b in map_raw_batches(D, K, O, MAP_RAW_BATCHES, seed=0)]
    st = mk.MapState.create(D, K, dev)
    ref = mk.MapState.create(D, K, dev)
    err = 0
    mak.launches = 0   # config #2's kernel loop starts here
    for b in raw:
        mk.apply_map_batch_fused(st, *b)
        ref = mk.apply_map_batch(ref, *b)
        torch.cuda.synchronize()
        err = max(err, diff(st, ref))
        if err:
            raise AssertionError(f"map kernel != plain: max abs err {err}")
    raw_launches = mak.launches   # and ends here
    if raw_launches != MAP_RAW_BATCHES:
        raise AssertionError(f"kernel loop launched {raw_launches} times")

    # timing: dense at config #2 and at config #4's doc count, packed at
    # config #2 (the serving shape)
    rows_specs = []

    for spec, (work, mode, args) in kernel_timing.map_inputs(
            mk, synthetic, dev, D, K, O, D_STRING).items():
        run = lambda: kernel_timing.map_call(  # noqa: E731
            mk, mode, work, args)
        t = {"ms": graph_ms(run, 50), "call_ms": timed_events(run, 20)}
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = kernel_timing.map_call(mk, mode, work, args, plain=True)
        z.record()
        torch.cuda.synchronize()
        chk = mk.MapState(*(v.clone() for v in work.fields().values()))
        kernel_timing.map_call(mk, mode, chk, args)
        e = diff(chk, out)
        err = max(err, e)
        if mode == "dense":
            kind, a0, op_bytes = args[0], args[1], 4 * args[0].numel() * 4
        else:
            kind, a0 = mk.map_unpack(args[0], *args[1:3], work.present
                                     .shape[0], True, args[3])[:2]
            op_bytes = args[0].numel() * 4
        rows_specs.append({"spec": spec, "D": work.present.shape[0], "K": K,
                           "O": O, **t, "plain_ms": a.elapsed_time(z),
                           **map_bound(kind, a0, op_bytes, K),
                           "max_abs_err": e})
    packed = rows_specs[-1]
    if err:
        raise AssertionError(f"map kernel != plain: max abs err {err}")
    del raw, st, ref, work, chk, out, kind, a0

    # columnar serving on the card against the same batches on the CPU
    docs = [f"map-{i}" for i in range(D)]

    def engine(device):
        e = MapServingEngine(n_docs=D, n_keys=K, batch_window=10 ** 9,
                             sequencer="native", device=device)
        for d in docs:
            e.connect(d, 1)
        return e, np.array([e.doc_row(d) for d in docs], np.int32)

    def ingest(e, rows, b, **kw):
        kind, kidx, keys, vidx, values = map_serving_batch(D, O, b,
                                                           n_keys=K)
        cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                       dtype=np.int32), (D, O))
        return e.ingest_planes(rows, np.ones((D, O), np.int32), cs,
                               np.zeros((D, O), np.int32), kind, kidx,
                               keys, values, vidx)

    eng, rows = engine(dev)
    if type(eng.deli).__name__ != "NativeDeliAdapter":
        raise AssertionError("map serving must run the native sequencer")
    mak.launches = 0   # the map path starts here
    nacked = ingest(eng, rows, 0)["nacked"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(1, MAP_SERVE_BATCHES):
        nacked += ingest(eng, rows, b)["nacked"]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    # per-op route: a second client on 16 docs, with clears
    op_docs = docs[:16]
    cpu, cpu_rows = engine("cpu")
    for b in range(MAP_SERVE_BATCHES):
        ingest(cpu, cpu_rows, b)

    def per_op(e, n, cs0):
        for i in range(n):
            d = op_docs[i % 16]
            c = {"op": "clear"} if i % 29 == 0 else \
                {"op": "delete", "key": f"k{i % 7}"} if i % 5 == 0 else \
                {"op": "set", "key": f"k{i % 11}", "value": {"i": i}}
            _, nack = e.submit(d, 2, cs0 + i // 16, e.deli.doc_seq(d), c)
            if nack is not None:
                raise AssertionError(f"per-op map route nacked: {nack}")

    for e in (eng, cpu):
        for d in op_docs:
            e.connect(d, 2)
        per_op(e, MAP_PER_OP, 1)
        e.flush()
    torch.cuda.synchronize()
    launches = mak.launches   # the map path ends here
    if nacked:
        raise AssertionError(f"map serving: {nacked} nacks")
    if launches <= 0:
        raise AssertionError("map serving never launched the kernel")
    for k in mk.PLANES:
        if not torch.equal(getattr(eng.store.state, k).cpu(),
                           getattr(cpu.store.state, k)):
            raise AssertionError(f"map serving: plane {k} differs from CPU")
    for d in op_docs:
        if eng.read_doc(d) != cpu.read_doc(d):
            raise AssertionError(f"{d}: per-op reads differ from CPU")

    # summaries: full, more traffic, incremental; load both on the card
    t0 = time.perf_counter()
    full = eng.summarize()
    ingest(eng, rows, MAP_SERVE_BATCHES)
    per_op(eng, 64, MAP_PER_OP // 16 + 1)
    inc = eng.summarize(incremental=True)
    summarize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_inc = MapServingEngine.load(inc, eng.log, device=dev,
                                     sequencer="native")
    from_full = MapServingEngine.load(full, eng.log, device=dev,
                                      sequencer="native")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if inc.get("kind") != "delta":
        raise AssertionError("the second summary is not incremental")
    if not np.array_equal(from_inc.store.digests(), eng.store.digests()):
        raise AssertionError("loaded digests differ from the live engine")
    for d in docs:
        want = eng.read_doc(d)
        if from_inc.read_doc(d) != want or from_full.read_doc(d) != want:
            raise AssertionError(f"{d}: loaded reads differ from live")
    n_ops = D * O * (MAP_SERVE_BATCHES - 1)
    for row in rows_specs:   # each timing shape's launches on the paths
        row["launches"] = {f"dense, D = {D}": raw_launches,
                           packed["spec"]: launches}.get(row["spec"], 0)
    floor = kernel_timing.launch_floor()["ms"]
    emit({"phase": "map", "docs": D, "n_keys": K, "ops_per_batch": D * O,
          "raw_batches": MAP_RAW_BATCHES, "raw_max_abs_err": 0,
          "serving_batches": MAP_SERVE_BATCHES, "nacked": nacked,
          "serving_ops_per_s": n_ops / serve_s, "serving_s": serve_s,
          "per_op_submits": MAP_PER_OP, "kernel_launches": launches,
          "kernel_loop_launches": raw_launches,
          "planes_equal_cpu": True, "summarize_s": summarize_s,
          "load_s": load_s, "loaded_equal_live": D,
          "timing": rows_specs, "launch_floor_ms": floor,
          "total_s": time.perf_counter() - t_phase, "card": smi})
    return {
        "name": "map_apply", "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/map_apply.cu",
        "replaces": "fluidframework_tpu/ops/map_kernel.py:101,131",
        "launches": raw_launches + launches,
        "launches_by_path": {"kernel loop (dense)": raw_launches,
                             "serving (packed + per-op flush)": launches},
        "max_abs_err": err,
        "ms": packed["ms"], "call_ms": packed["call_ms"],
        "plain_ms": packed["plain_ms"],
        "bound_ms": packed["bound_ms"], "bound_by": packed["bound_by"],
        "library_ms": None, "launch_floor_ms": floor,
        "shape": {"D": D, "K": K, "O": O, "spec": packed["spec"]},
        "specialisations": rows_specs}


def matrix_phase(smi, dev):
    """Phase 7: BASELINE config #3 at full width (a 1,024 × 1,024 grid,
    8 batches of 65,536 set-cell ops, table capacity rows·cols + O).
    Returns the ``cell_merge`` kernels-line entry."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import cell_merge as cmk
    from fluidframework_tpu_torch.ops import matrix_kernel as mx
    from fluidframework_tpu_torch.testing.synthetic import cell_storm

    t_phase = time.perf_counter()
    G, O3 = MX_GRID, MX_OPS
    T = G * G + O3

    def diff(a, b):
        return max(int((getattr(a, k).long() - getattr(b, k).long())
                       .abs().max()) for k in mx.PLANES + ("count",
                                                           "overflow"))

    def clone(s):
        return mx.MatrixCellState(**{k: v.clone()
                                     for k, v in s.fields().items()})

    def plain_in_place(state, k, s, v, L=None, fww=False):
        out = mx.merge_cells(state, k, s, v, L, fww)
        for name, t in state.fields().items():
            t.copy_(getattr(out, name))
        return state

    # raw batches: full mode, kernel against plain after every batch
    storm = cell_storm(G, G, O3, MX_BATCHES, seed=0)
    batches = [tuple(torch.as_tensor(x).to(dev) for x in b) for b in storm]
    st = mx.MatrixCellState.create(T, dev)
    ref = mx.MatrixCellState.create(T, dev)
    err = 0
    inputs = []
    cmk.launches = 0   # config #3's kernel loop starts here
    for b in batches:
        inputs.append(clone(st))
        mx.merge_cells_fused(st, *b)
        ref = mx.apply_cells_batch(ref, *b)
        torch.cuda.synchronize()
        err = max(err, diff(st, ref))
        if err:
            raise AssertionError(f"cell merge (full) != plain: {err}")
    raw_launches = cmk.launches   # and ends here
    if raw_launches != MX_BATCHES:
        raise AssertionError(f"kernel loop launched {raw_launches} merges")
    if int(st.overflow):
        raise AssertionError("config #3 storm overflowed its table")
    live_cells = int(st.count)
    work = clone(st)
    rows_specs = []

    def time_merge(state0, b, L, label):
        """Time one merge of ``b`` into a copy of ``state0`` (the copy
        before each merge is timed apart and taken off) and hold the
        kernel's result against the plain version's."""
        work = clone(state0)

        def copy():
            for name, t in work.fields().items():
                t.copy_(getattr(state0, name))

        def run():
            copy()
            mx.merge_cells_fused(work, *b, L=L)

        def check(when):
            """Max abs error of the kernel's merge against the plain
            one's; raises with the first differing slot of each plane."""
            run()
            torch.cuda.synchronize()
            e = diff(work, out)
            if e:
                where = {}
                for k in mx.PLANES:
                    bad = torch.nonzero(getattr(work, k) != getattr(out, k))
                    if len(bad):
                        i = int(bad[0])
                        where[k] = {"first": i, "n": len(bad),
                                    "kernel": int(getattr(work, k)[i]),
                                    "plain": int(getattr(out, k)[i])}
                raise AssertionError(
                    f"cell merge ({label}, {when}) != plain: max abs err "
                    f"{e}; count {int(work.count)} / {int(out.count)}; "
                    f"{where}")
            return e

        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = mx.merge_cells(state0, *b, L, False)
        z.record()
        torch.cuda.synchronize()
        check("before timing")
        t = {"ms": graph_ms(run, 10) - graph_ms(copy, 10),
             "call_ms": timed_events(run, 10) - timed_events(copy, 10)}
        e = check("after timing")
        live_in, live_out, n = int(state0.count), int(out.count), b[0].numel()
        b_ms, b_by, nbytes = cell_bound(live_in, live_out, n)
        rows_specs.append({"spec": label, "T": T,
                           "L": T if L is None else L, "O": n, **t,
                           "plain_ms": a.elapsed_time(z), "bound_ms": b_ms,
                           "bound_by": b_by, "bytes": nbytes,
                           "max_abs_err": e, "live_in": live_in,
                           "live_out": live_out})
        return e

    err = max(err, time_merge(inputs[-1], batches[-1], None,
                              "full (config #3 kernel loop)"))
    del inputs, ref, work
    torch.cuda.empty_cache()

    # store route: the same records through the store, kernel against a
    # store whose merges run the plain version on the card
    recs = [np.concatenate(x) for x in zip(*storm)]
    row_keys = (recs[0] // G).tolist()
    col_keys = (recs[0] % G).tolist()
    values = recs[2].tolist()
    seqs = recs[1]
    fww_storm = cell_storm(G, G, O3, 1, seed=1)[0]
    fww_cols = ((fww_storm[0] // G).tolist(), (fww_storm[0] % G).tolist(),
                fww_storm[2].tolist(),
                fww_storm[1] + MX_BATCHES * O3)
    stores = []
    fused = mx.merge_cells_fused
    n_chunks = -(-len(row_keys) // MX_STORE_BATCH)
    last_chunk = {}

    def keep_last(state, k, s, v, L=None, fww=False):
        """The store's merge entry point, keeping the input state, the
        chunk and L of the storm's last merge (the timed prefix shape)."""
        keep_last.calls += 1
        if keep_last.calls == n_chunks:
            last_chunk.update(state=clone(state), batch=(k, s, v), L=L)
        return fused(state, k, s, v, L, fww)
    keep_last.calls = 0

    cmk.launches = 0   # the matrix path starts here
    t0 = time.perf_counter()
    for plain in (False, True):
        mx.merge_cells_fused = plain_in_place if plain else keep_last
        try:
            s = mx.TensorMatrixStore(capacity=T, batch_size=MX_STORE_BATCH,
                                     device=dev)
            s.apply_batch_columnar(row_keys, col_keys, values, seqs)
            torch.cuda.synchronize()
            if not plain:
                store_s = time.perf_counter() - t0
                launches = cmk.launches   # the matrix path ends here
                pre_fww = (s.snapshot(), s.table_bases())
            s.switch_set_cell_policy()
            s.apply_batch_columnar(*fww_cols)
            stores.append(s)
        finally:
            mx.merge_cells_fused = fused
    kern, plain_store = stores
    for k in mx.PLANES + ("count", "overflow"):
        if not torch.equal(getattr(kern.state, k), getattr(plain_store.state,
                                                           k)):
            raise AssertionError(f"store route: {k} differs from plain")
    if kern.overflowed():
        raise AssertionError("store route overflowed")
    if launches != -(-len(row_keys) // MX_STORE_BATCH):
        raise AssertionError(f"store route launched {launches} merges")
    # the storm's last merge, on the state and the chunk (interned ids,
    # padded, the store's seqs) that _merge_chunk gave the kernel
    L_final = last_chunk["L"]
    if L_final is None:
        raise AssertionError("the store route's last merge is not prefix")
    err = max(err, time_merge(last_chunk["state"], last_chunk["batch"],
                              L_final, "prefix (store route, last chunk)"))
    main = rows_specs[-1]
    del last_chunk

    # round trip: the pre-FWW snapshot plus the delta since equals live
    snap, bases = pre_fww
    t0 = time.perf_counter()
    delta = kern.snapshot_delta(bases)
    back = mx.TensorMatrixStore.restore(snap, device=dev)
    back.apply_delta(delta)
    whole = mx.TensorMatrixStore.restore(kern.snapshot(), device=dev)
    roundtrip_s = time.perf_counter() - t0
    for r in (back, whole):
        for k in mx.PLANES + ("count", "overflow"):
            if not torch.equal(getattr(r.state, k), getattr(kern.state, k)):
                raise AssertionError(f"round trip: {k} differs")
        if r.fww != kern.fww or r.digest() != kern.digest():
            raise AssertionError("round trip: policy or digest differs")
    probe = list(kern._cell_ids)[::max(len(kern._cell_ids) // 64, 1)]
    if [back.read_cell(c) for c in probe] != \
            [kern.read_cell(c) for c in probe]:
        raise AssertionError("round trip: read_cell differs")
    if err:
        raise AssertionError(f"cell merge != plain: max abs err {err}")
    emit({"phase": "matrix_cells", "grid": [G, G], "capacity": T,
          "raw_batches": MX_BATCHES, "ops_per_batch": O3,
          "raw_max_abs_err": 0, "live_cells": live_cells,
          "kernel_loop_launches": raw_launches,
          "store_records": len(row_keys), "store_batch": MX_STORE_BATCH,
          "store_merges": launches, "store_final_L": L_final,
          "store_s": store_s, "store_equal_plain": True,
          "store_live_cells": int(kern.state.count),
          "fww_records": O3, "roundtrip_s": roundtrip_s,
          "timing": rows_specs, "total_s": time.perf_counter() - t_phase,
          "card": smi})
    return {
        "name": "cell_merge", "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/cell_merge.cu",
        "replaces": "fluidframework_tpu/ops/matrix_kernel.py:164",
        "launches": raw_launches + launches,
        "launches_by_path": {"kernel loop (full mode)": raw_launches,
                             "store route (prefix mode)": launches},
        "max_abs_err": err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": {"T": T, "L": L_final, "O": MX_STORE_BATCH,
                  "spec": "prefix (the store route)"},
        "specialisations": rows_specs}


def _axis_clone(st):
    from fluidframework_tpu_torch.ops import merge_tree as mt
    return mt.StringState(**{k: v.clone() for k, v in st.fields().items()})


def _axis_op_bytes(kind):
    """Bytes the window's op planes must supply, counted per slot from its
    kind (AXIS_OP_BYTES; 4 B for any other kind)."""
    import torch
    per = torch.full_like(kind, 4, dtype=torch.long)
    for k, b in AXIS_OP_BYTES.items():
        per = torch.where(kind == k, b, per)
    return int(per.sum())


def _live_extent(st):
    """Per axis row: max(count, 1 + the last slot differing from fill)."""
    import torch
    from fluidframework_tpu_torch.core.constants import NOT_REMOVED
    from fluidframework_tpu_torch.ops import merge_tree as mt
    S = st.seq.shape[1]
    nonfill = torch.zeros_like(st.seq, dtype=torch.bool)
    for k in mt.PLANES:
        fill = NOT_REMOVED if k == "removed_seq" else 0
        nonfill |= getattr(st, k) != fill
    idx = torch.arange(1, S + 1, device=st.seq.device)
    last = torch.where(nonfill, idx, 0).amax(dim=1)
    return torch.maximum(last, st.count.long())


def _resolve_walk(st, kind, pos, client, ref):
    """Slots a resolve must examine, summed over the window's resolves:
    up to and including the visible slot holding pos, or the row's count
    when none does (the work K4's data needs)."""
    import torch
    from fluidframework_tpu_torch.ops import merge_tree as mt
    D, S = st.seq.shape
    step = max((1 << 24) // max(D * S, 1), 1)
    iota = torch.arange(S, device=st.seq.device)
    active = (iota[None, :] < st.count[:, None])[:, None, :]
    pl = {k: getattr(st, k)[:, None, :] for k in mt.PLANES}
    total = 0
    for o0 in range(0, pos.shape[1], step):
        sl = slice(o0, o0 + step)
        p, cl, rs = (x[:, sl, None] for x in (pos, client, ref))
        bit = (pl["removers"] >> cl.clamp(0, 31)) & 1
        vis = active & ((pl["seq"] <= rs) | (pl["client"] == cl)) & ~(
            (pl["removed_seq"] <= rs) | ((bit != 0) & (cl >= 0)))
        ln = torch.where(vis, pl["length"], 0)
        end = torch.cumsum(ln, dim=2)
        inside = vis & (end - ln <= p) & (p < end)
        first = torch.where(inside, iota, S).amin(dim=2)
        walk = torch.where(first < S, first + 1,
                           st.count[:, None].long().expand_as(first))
        total += int(torch.where(kind[:, sl] == RESOLVE, walk, 0).sum())
    return total


def _deep_axis_rows(dev, D=4, S=8192, O=512, windows=6, seed=5):
    """The card tests' deepest K3 launch
    (``test_axis_apply_deep_rows_at_the_limit``: rows of thousands of live
    slots at S = 8,192, the block path): the state the first windows leave
    and the last window's op planes."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import axis_kernel as ak
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.testing.synthetic import axis_window
    rng = np.random.default_rng(seed)
    st = mt.StringState.create(D, S, n_props=1, device=dev)
    seq = 1
    for w in range(windows):
        planes, seq = axis_window(
            rng, ak.axis_visible_lengths(st).cpu().numpy(), O, seq,
            mix=(0.7, 0.1, 0.15, 0.05))
        ops = [torch.as_tensor(planes[k]).to(dev) for k in mt.OP_FIELDS]
        if w == windows - 1:
            return _axis_clone(st), ops
        ak.apply_axis_batch_fused(st, *ops)


def matrix_engine_phase(smi, dev, docs_a=MX_DOCS, grid_a=MX_DOC_GRID,
                        storms_a=MX_SERVE_STORMS, grid_b=MX_GRID,
                        ops_b=MX_OPS, storms_b=MX_BIG_STORMS,
                        wave_ops=MX_WAVE_OPS, waves=MX_WAVES,
                        samples=MX_SAMPLES, keep_inputs=None):
    """Phase 8: SharedMatrix served end to end (config #3). (a) the
    reference bench's serving shape: ``docs_a`` docs, each a grid_a ×
    grid_a grid made by per-op inserts, a warm-up and ``storms_a`` storms
    of 64 setCells per doc through ``ingest_cells``; (b) config #3's
    grid_b × grid_b grid in one doc, both axes built by 64 concurrent
    inserts of grid_b / 64 from 4 clients, then ``storms_b`` storms of
    ``ops_b`` setCells; (c) ``waves`` per-op concurrent waves on (a)'s
    engine (4 clients per doc, ``wave_ops`` ops per doc per flush, ref_seq
    lagging by up to 16, FWW on a quarter of the docs). Every engine is
    held against a ``device="cpu"`` engine fed the same inputs; then each
    card engine is summarized (full, then incremental after more ops) and
    both summaries load on the card and equal the live engine. Every K3 /
    K4 launch of the paths is held against its plain version on its own
    input afterwards, and each kernel is timed on its widest launch of
    every path (saved to ``keep_inputs`` for ``kernel_timing.py
    --axis-inputs`` when given, with the card tests' deepest K3 launch).
    Returns the ``axis_apply`` and
    ``axis_resolve`` kernels-line entries."""
    import collections

    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import axis_apply as axk
    from fluidframework_tpu_torch.ops import axis_kernel as ak
    from fluidframework_tpu_torch.ops import cell_merge as cmk
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.server.serving import MatrixServingEngine
    from fluidframework_tpu_torch.testing import kernel_timing

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(3)
    calls = {"apply": [], "resolve": []}
    capture = [False]
    fused_apply, fused_resolve = ak.apply_axis_batch_fused, \
        ak.resolve_axis_fused

    def keep_apply(state, *ops):
        """K3's entry point, keeping each card launch's input and output."""
        if not (capture[0] and state.seq.is_cuda):
            return fused_apply(state, *ops)
        before = _axis_clone(state)
        run, off = fused_apply(state, *ops)
        calls["apply"].append((path[0], before, ops, _axis_clone(state),
                               run, off))
        return run, off

    def keep_resolve(state, kind, pos, client, ref):
        """K4's entry point, keeping each card launch's input and output."""
        run, off = fused_resolve(state, kind, pos, client, ref)
        if capture[0] and state.seq.is_cuda:
            calls["resolve"].append((path[0], _axis_clone(state),
                                     (kind, pos, client, ref), run, off))
        return run, off

    path = [""]
    launches = {"apply": collections.Counter(),
                "resolve": collections.Counter(),
                "cell_merge": collections.Counter()}

    def begin(name):
        """Counts to 0 just before a path; ``end`` reads them just after
        (the cell merges the engine launches are reported beside them)."""
        path[0] = name
        capture[0] = True
        axk.apply_launches = axk.resolve_launches = cmk.launches = 0

    def end():
        if on_card:
            torch.cuda.synchronize()
        launches["apply"][path[0]] += axk.apply_launches
        launches["resolve"][path[0]] += axk.resolve_launches
        launches["cell_merge"][path[0]] += cmk.launches
        capture[0] = False

    parts = collections.defaultdict(float)
    timing_on = [False]

    def time_parts(e):
        """Host seconds by part of the columnar cell route."""
        def wrap(obj, name, part):
            fn = getattr(obj, name)

            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    if timing_on[0]:
                        parts[part] += time.perf_counter() - t0
            setattr(obj, name, timed)
        wrap(e, "_sequence_columnar", "sequencing")
        wrap(e, "_cell_resolve", "resolve (planes, launch)")
        wrap(e, "_fww_filter_columnar", "fww_filter")
        wrap(e.store, "apply_batch_columnar", "cell_merge")
        wrap(e, "_cell_record", "log")

    result_fn = ak.PendingResolve.result

    def timed_result(self):
        t0 = time.perf_counter()
        try:
            return result_fn(self)
        finally:
            if timing_on[0]:
                parts["resolve (wait)"] += time.perf_counter() - t0

    def engine(device, n_docs, cell_capacity, axis_capacity):
        return MatrixServingEngine(
            n_docs=n_docs, cell_capacity=cell_capacity,
            axis_capacity=axis_capacity, batch_window=10 ** 9,
            sequencer="native", device=device)

    def submit_all(e, items):
        """Per-op submits (doc, client, clientSeq, ref_seq, op); none may
        be nacked."""
        for d, c, cs, ref, op in items:
            _, nack = e.submit(d, c, cs, ref, op)
            if nack is not None:
                raise AssertionError(f"{d}: {op} nacked ({nack})")

    def ingest(e, batch):
        nacked = e.ingest_cells(*batch)["nacked"]
        if nacked:
            raise AssertionError(f"cell ingest: {nacked} nacks")

    def same(card, cpu, docs, lists):
        """The card engine against its CPU twin: dims, axis planes (all
        slots), the cell table, sampled cells, and to_lists of ``lists``."""
        for d in docs:
            if card.dims(d) != cpu.dims(d):
                raise AssertionError(f"{d}: dims differ from CPU")
        for k in mt.FIELDS:
            if not torch.equal(getattr(card.axis_store.state, k).cpu(),
                               getattr(cpu.axis_store.state, k)):
                raise AssertionError(f"axis plane {k} differs from CPU")
        n = int(cpu.store.state.count)
        if int(card.store.state.count) != n or \
                card.store.digest() != cpu.store.digest():
            raise AssertionError("cell table count / digest differ")
        for k in mxk.PLANES:
            if not torch.equal(getattr(card.store.state, k)[:n].cpu(),
                               getattr(cpu.store.state, k)[:n]):
                raise AssertionError(f"cell plane {k} differs from CPU")
        probe(card, cpu, docs)
        for d in lists:
            if card.to_lists(d) != cpu.to_lists(d):
                raise AssertionError(f"{d}: to_lists differs from CPU")

    def probe(a, b, docs):
        prng = np.random.default_rng(11)
        dims = {d: a.dims(d) for d in docs}
        for i in range(samples):
            d = docs[i % len(docs)]
            nr, nc = dims[d]
            r, c = int(prng.integers(0, nr)), int(prng.integers(0, nc))
            if a.get_cell(d, r, c) != b.get_cell(d, r, c):
                raise AssertionError(f"{d}: get_cell({r}, {c}) differs")

    def storm(docs, cs, grid, n_per_doc, clients, refs):
        """``n_per_doc`` setCells per doc, docs interleaved, clients in
        turn, every client at the doc's ref ``refs[d]``."""
        ids = [d for _ in range(n_per_doc) for d in docs]
        cl = [clients[i % len(clients)] for i in range(n_per_doc)
              for _ in docs]
        cseq = []
        for d, c in zip(ids, cl):
            cs[d, c] += 1
            cseq.append(cs[d, c])
        n = len(ids)
        return (ids, cl, cseq, [refs[d] for d in ids],
                rng.integers(0, grid, n).tolist(),
                rng.integers(0, grid, n).tolist(),
                rng.integers(0, 1 << 20, n).tolist())

    ak.apply_axis_batch_fused, ak.resolve_axis_fused = keep_apply, \
        keep_resolve
    ak.PendingResolve.result = timed_result
    try:
        # (a) config #3's serving shape: the reference bench's grid storms
        docs_a_ids = [f"mx-{i}" for i in range(docs_a)]
        eng_a = engine(dev, docs_a, MX_CELL_CAP_A, MX_AXIS_CAP_A)
        cpu_a = engine("cpu", docs_a, MX_CELL_CAP_A, MX_AXIS_CAP_A)
        if type(eng_a.deli).__name__ != "NativeDeliAdapter":
            raise AssertionError("matrix serving must run the native "
                                 "sequencer")
        time_parts(eng_a)
        cs_a = collections.Counter()   # clientSeqs by (doc, client)
        setup = []
        for d in docs_a_ids:
            for e in (eng_a, cpu_a):
                e.connect(d, 7)
            for mx in ("insRow", "insCol"):
                cs_a[d, 7] += 1
                setup.append((d, 7, cs_a[d, 7], 0,
                              {"mx": mx, "pos": 0, "count": grid_a,
                               "opKey": (7, cs_a[d, 7])}))
        begin("(a) setup: per-op inserts, one flush")
        submit_all(eng_a, setup)
        eng_a.flush()
        end()
        submit_all(cpu_a, setup)
        cpu_a.flush()
        zero = {d: 0 for d in docs_a_ids}
        a_batches = [storm(docs_a_ids, cs_a, grid_a, 64, [7], zero)
                     for _ in range(storms_a + 1)]
        begin("(a) ingest_cells storms")
        ingest(eng_a, a_batches[0])                 # warm-up
        eng_a.dims(docs_a_ids[0])
        timing_on[0] = True
        t0 = time.perf_counter()
        for b in a_batches[1:]:
            ingest(eng_a, b)
        eng_a.dims(docs_a_ids[0])      # end sync: harvests the newest
        a_s = time.perf_counter() - t0
        timing_on[0] = False
        end()
        parts["other"] = a_s - sum(parts.values())
        a_parts = dict(parts)
        parts.clear()
        for b in a_batches:
            ingest(cpu_a, b)

        # (c) per-op concurrent waves on (a)'s engine
        clients = (7, 8, 9, 10)
        refs_c, seq_a = {}, {}
        for d in docs_a_ids:
            for c in clients[1:]:
                for e in (eng_a, cpu_a):
                    s = e.connect(d, c).seq
                seq_a[d] = s
            for c in clients:
                refs_c[d, c] = seq_a[d]
        wave_s = []
        min_axis_ops = None   # real ops of the emptiest axis row a flush
        for w in range(waves):
            items = []
            dims = {d: eng_a.dims(d) for d in docs_a_ids}
            for i in range(wave_ops):
                for di, d in enumerate(docs_a_ids):
                    c = clients[int(rng.integers(0, 4))]
                    cs_a[d, c] += 1
                    refs_c[d, c] = max(refs_c[d, c],
                                       seq_a[d] - int(rng.integers(0, 17)))
                    nr, nc = dims[d]
                    roll = rng.random()
                    if w == 0 and i == 0 and di % 4 == 0:
                        op = {"mx": "policy"}
                    elif roll < 0.82:
                        op = {"mx": "setCell",
                              "row": int(rng.integers(0, nr)),
                              "col": int(rng.integers(0, nc)),
                              "value": f"{d}/{w}/{i}"}
                    elif roll < 0.91:
                        ax = "insRow" if roll < 0.865 else "insCol"
                        op = {"mx": ax, "pos": int(rng.integers(
                            0, (nr if ax == "insRow" else nc) + 1)),
                            "count": int(rng.integers(1, 3)),
                            "opKey": (c, 1000 * w + i)}
                    else:
                        ax = "rmRow" if roll < 0.955 else "rmCol"
                        n = nr if ax == "rmRow" else nc
                        op = {"mx": ax,
                              "start": int(rng.integers(0, n - 2)),
                              "count": 1}
                    items.append((d, c, cs_a[d, c], refs_c[d, c], op))
                    seq_a[d] += 1
            per_axis = collections.Counter()
            for d, _, _, _, op in items:
                mx = op["mx"]
                for a, hit in ((0, ("setCell", "insRow", "rmRow")),
                               (1, ("setCell", "insCol", "rmCol"))):
                    per_axis[d, a] += mx in hit
            least = min(per_axis[d, a] for d in docs_a_ids for a in (0, 1))
            min_axis_ops = least if min_axis_ops is None else min(
                min_axis_ops, least)
            begin("(c) per-op concurrent waves")
            t0 = time.perf_counter()
            submit_all(eng_a, items)
            eng_a.flush()
            end()
            wave_s.append(time.perf_counter() - t0)
            submit_all(cpu_a, items)
            cpu_a.flush()
        same(eng_a, cpu_a, docs_a_ids, docs_a_ids)

        # (b) config #3's grid in one doc
        eng_b = engine(dev, 1, grid_b * grid_b + ops_b, grid_b)
        cpu_b = engine("cpu", 1, grid_b * grid_b + ops_b, grid_b)
        time_parts(eng_b)
        doc = "mx-grid"
        bclients = (1, 2, 3, 4)
        seq_b = 0
        refs_b = {}
        for c in bclients:
            for e in (eng_b, cpu_b):
                seq_b = e.connect(doc, c).seq
            refs_b[c] = seq_b
        run_len = grid_b // 64
        axes = {"insRow": [], "insCol": []}   # (seq, client) per insert
        items, cs_b = [], collections.Counter()   # by (doc, client)
        for i in range(128):
            ax = ("insRow", "insCol")[i % 2]
            c = bclients[int(rng.integers(0, 4))]
            refs_b[c] = max(refs_b[c], seq_b - int(rng.integers(0, 17)))
            seen = sum(1 for s, cl in axes[ax]
                       if s <= refs_b[c] or cl == c)
            cs_b[doc, c] += 1
            seq_b += 1
            items.append((doc, c, cs_b[doc, c], refs_b[c],
                          {"mx": ax,
                           "pos": int(rng.integers(0, seen * run_len + 1)),
                           "count": run_len, "opKey": (c, cs_b[doc, c])}))
            axes[ax].append((seq_b, c))
        begin("(b) axis build: 128 concurrent inserts, one flush")
        submit_all(eng_b, items)
        eng_b.flush()
        end()
        submit_all(cpu_b, items)
        cpu_b.flush()
        if eng_b.dims(doc) != (grid_b, grid_b):
            raise AssertionError(f"grid is {eng_b.dims(doc)}")
        refs_all = {doc: seq_b}
        b_batches = [storm([doc], cs_b, grid_b, ops_b, bclients, refs_all)
                     for _ in range(storms_b)]
        begin("(b) ingest_cells storms")
        timing_on[0] = True
        t0 = time.perf_counter()
        for b in b_batches:
            ingest(eng_b, b)
        eng_b.dims(doc)
        b_s = time.perf_counter() - t0
        timing_on[0] = False
        end()
        parts["other"] = b_s - sum(parts.values())
        b_parts = dict(parts)
        parts.clear()
        t0 = time.perf_counter()
        for b in b_batches:
            ingest(cpu_b, b)
        cpu_b.dims(doc)
        b_cpu_s = time.perf_counter() - t0
        same(eng_b, cpu_b, [doc], [])

        # summaries: full, more ops, incremental; load both on the card
        begin("summaries and loads")
        reloads = []
        for e, docs, more in (
                (eng_a, docs_a_ids, lambda e: storm(
                    docs_a_ids, cs_a, grid_a, 8, [7],
                    {d: e.deli.doc_seq(d) for d in docs_a_ids})),
                (eng_b, [doc], lambda e: storm(
                    [doc], cs_b, grid_b, min(ops_b, 4096), bclients,
                    {doc: e.deli.doc_seq(doc)}))):
            full = e.summarize()
            ingest(e, more(e))
            inc = e.summarize(incremental=True)
            if inc.get("kind") != "delta":
                raise AssertionError("the second summary is not a delta")
            ingest(e, more(e))   # a log tail past both summaries
            for s in (full, inc):
                back = MatrixServingEngine.load(s, e.log, device=dev,
                                                sequencer="native")
                reloads.append((e, back, docs))
        end()
        for e, back, docs in reloads:
            for d in docs:
                if back.dims(d) != e.dims(d):
                    raise AssertionError(f"{d}: reloaded dims differ")
            if back.store.read_cells() != e.store.read_cells():
                raise AssertionError("reloaded cells differ from live")
            probe(back, e, docs)
            if len(docs) > 1:
                for d in docs:
                    if back.to_lists(d) != e.to_lists(d):
                        raise AssertionError(f"{d}: reload to_lists")
    finally:
        ak.apply_axis_batch_fused, ak.resolve_axis_fused = fused_apply, \
            fused_resolve
        ak.PendingResolve.result = result_fn

    if on_card:
        if launches["resolve"]["(b) ingest_cells storms"] != storms_b:
            raise AssertionError("(b) storms: one K4 launch each expected")
        if launches["apply"]["(c) per-op concurrent waves"] < waves:
            raise AssertionError("(c) waves: K3 not launched every flush")
        for kind in ("apply", "resolve"):
            if sum(launches[kind].values()) <= 0:
                raise AssertionError(f"axis {kind} kernel never launched")
    if wave_ops >= MX_WAVE_OPS and min_axis_ops < 64:
        raise AssertionError(f"(c): an axis row got {min_axis_ops} ops")

    # every card launch of the paths against the plain version
    err = {"apply": 0, "resolve": 0}

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    for tag, before, ops, after, run, off in calls["apply"]:
        ref, rr, ro = ak.apply_axis_batch(before, *ops)
        e = max([diff(getattr(after, k), getattr(ref, k))
                 for k in mt.FIELDS] + [diff(run, rr), diff(off, ro)])
        err["apply"] = max(err["apply"], e)
    for tag, st, (kind, pos, client, ref), run, off in calls["resolve"]:
        rr, ro = ak.resolve_axis_positions(st, pos, client, ref)
        is_res = kind == RESOLVE
        e = max(diff(run, torch.where(is_res, rr, -1)),
                diff(off, torch.where(is_res, ro, -1)))
        err["resolve"] = max(err["resolve"], e)
    if err["apply"] or err["resolve"]:
        raise AssertionError(f"axis kernels != plain: {err}")

    # timing, on each path's widest launch; the main rows first: (c) for
    # K3, (b)'s storms for K4
    rows = {"apply": [], "resolve": []}
    main_tags = {"apply": "(c) per-op concurrent waves",
                 "resolve": "(b) ingest_cells storms"}

    def events_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z), out

    def time_apply(tag, before, ops):
        work = _axis_clone(before)

        def copy():
            for k, v in work.fields().items():
                v.copy_(getattr(before, k))

        def run():
            copy()
            fused_apply(work, *ops)

        t = {"ms": graph_ms(run, 20) - graph_ms(copy, 20),
             "call_ms": timed_events(run, 10) - timed_events(copy, 10)}
        plain_ms, (ref, _, _) = events_ms(
            lambda: ak.apply_axis_batch(before, *ops))
        run()
        torch.cuda.synchronize()
        e = max(diff(getattr(work, k), getattr(ref, k)) for k in mt.FIELDS)
        D, S = before.seq.shape
        O = ops[0].shape[1]
        b_ms, b_by, nbytes, n_ops = axis_apply_bound(before, ops, ref)
        rows["apply"].append({"spec": tag, "D": D, "S": S, "O": O, **t,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "bytes": nbytes,
                              "int_ops": n_ops, "max_abs_err": e,
                              "mean_count": float(before.count.float()
                                                  .mean())})

    def time_resolve(tag, st, ops):
        kind, pos, client, ref = ops
        fn = lambda: fused_resolve(st, *ops)  # noqa: E731
        t = {"ms": graph_ms(fn, 20), "call_ms": timed_events(fn, 10)}
        plain_ms, (rr, ro) = events_ms(
            lambda: ak.resolve_axis_positions(st, pos, client, ref))
        run, off = fn()
        is_res = kind == RESOLVE
        e = max(diff(run, torch.where(is_res, rr, -1)),
                diff(off, torch.where(is_res, ro, -1)))
        D, S = st.seq.shape
        O = kind.shape[1]
        b_ms, b_by, nbytes, n_ops = axis_resolve_bound(st, *ops)
        rows["resolve"].append({"spec": tag, "D": D, "S": S, "O": O, **t,
                                "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "bytes": nbytes,
                                "int_ops": n_ops,
                                "resolves": int(is_res.sum()),
                                "max_abs_err": e})

    if on_card:
        widest = {}
        for kind in ("apply", "resolve"):
            tags = sorted({x[0] for x in calls[kind]},
                          key=lambda t: (t != main_tags[kind], t))
            for tag in tags:   # the widest (the last of equal widths)
                widest[kind, tag] = max(
                    reversed([x for x in calls[kind] if x[0] == tag]),
                    key=lambda x: x[2][0].numel())
        for (kind, tag), x in widest.items():
            (time_apply if kind == "apply" else time_resolve)(
                tag, x[1], x[2])
        if keep_inputs:   # and the card tests' deepest rows beside them
            saved = {("axis_" + kind, tag): (x[1], list(x[2]))
                     for (kind, tag), x in widest.items()}
            saved["axis_apply", "card test: S = 8,192 deep rows"] = \
                _deep_axis_rows(dev)
            kernel_timing.save_inputs(keep_inputs, saved)
        del widest
        for kind in ("apply", "resolve"):
            err[kind] = max([err[kind]] + [r["max_abs_err"]
                                           for r in rows[kind]])
        if err["apply"] or err["resolve"]:
            raise AssertionError(f"axis kernels != plain after timing: "
                                 f"{err}")
    del calls

    n_a = storms_a * docs_a * 64
    n_b = storms_b * ops_b
    emit({"phase": "matrix_engine",
          "a": {"docs": docs_a, "grid": [grid_a, grid_a],
                "cell_capacity": MX_CELL_CAP_A,
                "axis_capacity": MX_AXIS_CAP_A, "storms": storms_a,
                "ops_per_storm": docs_a * 64, "ops_per_s": n_a / a_s,
                "storms_s": a_s, "seconds_by_part": a_parts},
          "b": {"docs": 1, "grid": [grid_b, grid_b],
                "cell_capacity": grid_b * grid_b + ops_b,
                "axis_capacity": grid_b, "storms": storms_b,
                "ops_per_storm": ops_b, "ops_per_s": n_b / b_s,
                "storms_s": b_s, "cpu_twin_storms_s": b_cpu_s,
                "live_cells": int(eng_b.store.state.count),
                "seconds_by_part": b_parts},
          "c": {"waves": waves, "ops_per_doc_per_flush": wave_ops,
                "clients_per_doc": 4, "fww_docs": (docs_a + 3) // 4,
                "min_real_ops_per_axis_row": min_axis_ops,
                "wave_s": wave_s},
          "nacked": 0, "engines_equal_cpu": True, "reloads_equal_live": 4,
          "sampled_cells_per_check": samples,
          "launches": {k: dict(v) for k, v in launches.items()},
          "max_abs_err": err, "timing": rows,
          "total_s": time.perf_counter() - t_phase, "card": smi})

    def entry(kind, name, replaces, main):
        m = main or {}
        return {"name": name, "route": "cuda",
                "source": "fluidframework_tpu_torch/csrc/axis_apply.cu",
                "replaces": replaces,
                "launches": sum(launches[kind].values()),
                "launches_by_path": dict(launches[kind]),
                "max_abs_err": err[kind],
                "ms": m.get("ms"), "call_ms": m.get("call_ms"),
                "plain_ms": m.get("plain_ms"),
                "bound_ms": m.get("bound_ms"),
                "bound_by": m.get("bound_by"), "library_ms": None,
                "shape": {k: m.get(k) for k in ("D", "S", "O", "spec")},
                "specialisations": rows[kind]}

    return (entry("apply", "axis_apply",
                  "fluidframework_tpu/ops/axis_kernel.py:62",
                  rows["apply"][0] if rows["apply"] else None),
            entry("resolve", "axis_resolve",
                  "fluidframework_tpu/ops/axis_kernel.py:114",
                  rows["resolve"][0] if rows["resolve"] else None))


TREE_D, TREE_N, TREE_O = 8192, 128, 64   # profile_tree.py's serving shape
TREE_BATCHES = 4                           # chained kernel-loop batches
TREE_PIPE_WAVES = 4                        # pipelined record / leaf waves
TREE_MIX_DOCS, TREE_MIX_OPS = 256, 8       # (c): docs, ops per doc
TREE_REC_DOCS, TREE_REC_CAP = 256, 32      # (d): docs, tier capacity
TREE_SAMPLES = 64                          # to_dict probes per check
SECTOR = 32                 # bytes: the least one scattered access moves
# the sectors a tree record touches past its doc's node_id plane, by base
# kind: an insert reads its anchor's parent, field and next_sib and its
# parent's created_seq, and writes the new slot's 8 planes, the anchor's
# next_sib and the neighbour's prev_sib; a setValue writes one value; the
# flag kinds need only the node_id plane
TREE_KIND_SECTORS = {5: 14, 8: 1}


def tree_apply_bound(before, planes, wire):
    """Bytes a serial scan must move, counted per doc from its records'
    base kinds. Every doc with a non-NOOP record reads its node_id plane
    (each lookup and the free-slot search scan it) and reads and writes
    its overflow flag. A doc with a remove or move reads and writes all
    8 planes (the subtree walk). Any other such doc adds the parent,
    field and prev_sib planes, read once, where an insert has no anchor
    (the head search), and the 32-B sectors of TREE_KIND_SECTORS for
    each record. The (9, D, O) records are read once, and the (D,) base
    in wire mode. A dead anchor's head search is not charged, so the
    count errs low. Operations: one N-wide pass per real record."""
    import torch
    kind = planes[0].long()
    base_k = torch.where((kind >= 9) & (kind <= 12), kind - 4, kind)
    active = (kind != 0).any(dim=1)
    moves = ((base_k == 6) | (base_k == 7)).any(dim=1)
    light = active & ~moves
    head = light & ((base_k == 5) & (planes[3] == 0)).any(dim=1)
    sectors = torch.zeros_like(kind)
    for k, n in TREE_KIND_SECTORS.items():
        sectors += (base_k == k).long() * n
    n_sec = int((sectors.sum(dim=1) * light).sum())
    Dn, Nn = before.node_id.shape
    plane = 4 * Nn
    nbytes = 8 * int(active.sum()) + plane * (
        int(light.sum()) + 3 * int(head.sum()) + 16 * int(moves.sum())) \
        + SECTOR * n_sec + planes.numel() * 4 + (4 * Dn if wire else 0)
    real = int((kind != 0).sum())
    return work_bound(nbytes, real * Nn), nbytes, int(active.sum()), \
        real


def tree_phase(smi, dev, keep_inputs=None):
    """Phase 9: SharedTree served end to end at ``benches/profile_tree.py``'s
    shapes (8,192 docs, capacity 128, the native sequencer). (a) K5 in
    planes mode against the plain ``apply_tree_planes`` on the card after
    each of 4 chained ``tree_record_storm`` batches (O=64, every record
    kind, some docs overflowing), and the same records through the wire
    (``pack_wire_records`` at u16 and u32 id widths) by K6 + K5 wire mode
    against the plain ``apply_tree_wire``; (b) ``TreeServingEngine``: a
    warm-up ``ingest_batch`` wave, a dict wave, a serial ``ingest_records``
    wave and 4 pre-encoded waves through ``PipelinedIngestExecutor(
    depth=3)``, then on a second engine a seed ``ingest_leaves`` wave and 4
    flat leaf waves pipelined with cached rows, each engine equal to a
    ``device="cpu"`` twin (all planes, sampled ``to_dict``); (c) a
    ``tree_op_storm`` on 256 docs through per-op ``submit`` (3 clients,
    lagging refs) and the same kind of storm through ``ingest_batch``,
    equal to a CPU twin; (d) a capacity-32 engine grown until docs
    overflow, ``recover_overflowed`` (re-uploads and graduations) equal to
    a capacity-1,024 control, full and incremental summaries loaded on the
    card equal to the live engine, a dup-acked resubmit; (e) K5 (wire mode
    at the serving wave's shape, planes mode at profile_tree.py's
    kernel-alone shape) and K6 timed in CUDA graphs beside their plain
    versions and bounds. Returns the ``tree_apply`` and ``tree_expand``
    kernels-line entries."""
    import collections

    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import tree_apply as ta
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops import tree_store as tstore
    from fluidframework_tpu_torch.server.ingest_pipeline import (
        PipelinedIngestExecutor,
    )
    from fluidframework_tpu_torch.server.serving import TreeServingEngine
    from fluidframework_tpu_torch.server.tree_wire import (
        encode_leaf_records, encode_tree_batch,
    )
    from fluidframework_tpu_torch.testing import kernel_timing
    from fluidframework_tpu_torch.testing.synthetic import (
        profile_tree_waves, tree_op_storm, tree_record_storm,
        tree_storm_flat,
    )

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    D, N, O = TREE_D, TREE_N, TREE_O
    ALL = tk.TREE_PLANES + ("overflow",)
    launches = {"apply": collections.Counter(),
                "expand": collections.Counter()}
    path = [""]
    err = {"apply": 0, "expand": 0}

    def begin(name):
        """Counts to 0 just before a path; ``end`` reads them just after."""
        path[0] = name
        ta.apply_launches = ta.expand_launches = 0

    def end():
        torch.cuda.synchronize()
        launches["apply"][path[0]] += ta.apply_launches
        launches["expand"][path[0]] += ta.expand_launches

    def diff(a, b):
        return int((a.long().cpu() - b.long().cpu()).abs().max()) \
            if a.numel() else 0

    def state_err(a, b):
        return max(diff(getattr(a, k), getattr(b, k)) for k in ALL)

    widest, widest_launches = {}, collections.Counter()
    launch_apply = ta.launch_apply

    def keep_widest(state, planes, base=None):
        """K5 as the engines call it; on the per-op, recovery and load
        paths it keeps, per capacity N, the launch with the most records
        (its input state, records and base) for timing in (e)."""
        tag = (path[0].split(":")[0], state.node_id.shape[1])
        if tag[0] in ("per-op", "recovery", "load"):
            n = int((planes[0] != 0).sum())
            widest_launches[tag] += 1
            if n > widest.get(tag, (0,))[0]:
                widest[tag] = (n, state.clone(), planes.clone(),
                               None if base is None else base.clone())
        return launch_apply(state, planes, base)

    # ------------------------------------------- (a) kernel parity
    storms = [tree_record_storm(D, O, seed=b, capacity=N,
                                start_seq=1 + 1000 * b)
              for b in range(TREE_BATCHES)]
    st = tk.TreeState.create(D, N, device=dev)
    ref = st.clone()
    begin("kernel loop: planes")
    for b, p in enumerate(storms):
        pd = torch.from_numpy(p).to(dev)
        tk.apply_tree_planes_fused(st, pd)
        ref = tk.apply_tree_planes(ref, pd)
        torch.cuda.synchronize()
        err["apply"] = max(err["apply"], state_err(st, ref))
    end()
    kernel_ovf = int(st.overflow.sum())
    if err["apply"] or not kernel_ovf:
        raise AssertionError(f"K5 planes != plain ({err['apply']}) or no "
                             f"overflow ({kernel_ovf})")
    wire_rows = []
    for width in (np.uint16, np.uint32):
        ws = tk.TreeState.create(D, N, device=dev)
        wref = ws.clone()
        begin(f"kernel loop: wire {np.dtype(width).name}")
        for b, p in enumerate(storms):
            recs, rec_op, rows = tree_storm_flat(p)
            cols, ids, vals, row, pos, o = tstore.pack_wire_records(
                recs, rec_op, rows, id_t=width, val_t=width)
            m = np.arange(int(recs.max()) + 2, dtype=np.int32)
            base = np.full(D, 1 + 1000 * b, np.int32)
            wd = [torch.from_numpy(x).to(dev) for x in (
                cols, ids, vals, row, pos, base, m, m, m, m)]
            got = tk.expand_tree_wire_fused(*wd[:5], *wd[6:], n_docs=D,
                                            o=o)
            want = tk.expand_tree_wire(*wd[:5], *wd[6:], n_docs=D, o=o)
            err["expand"] = max(err["expand"], diff(got, want))
            tk.apply_tree_wire_fused(ws, *wd, o=o)
            wref = tk.apply_tree_wire(wref, *wd, o=o)
            torch.cuda.synchronize()
            err["apply"] = max(err["apply"], state_err(ws, wref),
                               state_err(ws, ref) if b == 3 else 0)
        end()
        wire_rows.append({"ids": np.dtype(width).name, "records": len(recs),
                          "o": o, "pos": np.dtype(pos.dtype).name})
    if err["apply"] or err["expand"]:
        raise AssertionError(f"tree kernels != plain: {err}")
    del st, ref, ws, wref
    torch.cuda.empty_cache()

    # ------------------------------------------- (b) serving
    captured = {}
    wire_fused = tstore.apply_tree_wire_fused

    def keep_wire(state, *args, o):
        """The serving path's wire apply, keeping the last launch's input
        (the state before it and the uploaded wire) for timing."""
        if state.node_id.device.type == dev.type and \
                state.node_id.shape[0] == D:
            captured["wire"] = (state.clone(), args, o)
        return wire_fused(state, *args, o=o)

    tstore.apply_tree_wire_fused = keep_wire
    docs = [f"t-{i}" for i in range(D)]
    ones, zeros = [1] * D, [0] * D

    def serving_engine(device):
        e = TreeServingEngine(n_docs=D, capacity=N, batch_window=10 ** 9,
                              sequencer="native", device=device)
        if type(e.deli).__name__ != "NativeDeliAdapter":
            raise AssertionError("tree serving must run the native "
                                 "sequencer")
        for d in docs:
            e.connect(d, 1)
        return e

    waves = [profile_tree_waves(docs, w)[1] for w in range(3 +
                                                           TREE_PIPE_WAVES)]
    pre = [encode_tree_batch(w) for w in waves[2:]]
    eng, twin = serving_engine(dev), serving_engine("cpu")
    rows = np.array([eng.doc_row(d) for d in docs], np.int32)
    for d in docs:
        twin.doc_row(d)
    serve = {}
    begin("serving")
    t0 = time.perf_counter()
    eng.ingest_batch(docs, ones, ones, zeros, waves[0])
    torch.cuda.synchronize()
    serve["warmup_wave_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r1 = eng.ingest_batch(docs, ones, [2] * D, zeros, waves[1])
    eng.sync()
    serve["dict_wave_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r2 = eng.ingest_records(None, ones, [3] * D, zeros, pre[0], rows=rows)
    eng.sync()
    serve["records_wave_s"] = time.perf_counter() - t0
    ex = PipelinedIngestExecutor(eng, depth=3)
    t0 = time.perf_counter()
    tickets = [ex.submit(None, ones, [w + 4] * D, zeros, b, rows=rows)
               for w, b in enumerate(pre[1:])]
    ex.drain()
    eng.sync()
    pipe_s = time.perf_counter() - t0
    results = [r1, r2] + [t.result() for t in tickets]
    pipe = ex.stats()
    ex.close()
    end()
    nacked = sum(r["nacked"] for r in results)
    twin.ingest_batch(docs, ones, ones, zeros, waves[0])
    twin.ingest_batch(docs, ones, [2] * D, zeros, waves[1])
    for w, b in enumerate(pre):
        twin.ingest_records(None, ones, [w + 3] * D, zeros, b, rows=rows)
    over = eng.overflowed_docs()
    e = state_err(eng.store.state, twin.store.state)
    sample = sorted({0, 1, D // 2, D - 1} |
                    set(np.random.default_rng(0).integers(
                        0, D, TREE_SAMPLES).tolist()))
    if nacked or over or e or launches["apply"]["serving"] <= 0 or \
            launches["expand"]["serving"] <= 0:
        raise AssertionError(f"tree serving: {nacked} nacks, {len(over)} "
                             f"overflowed, planes err {e}, launches "
                             f"{dict(launches['apply'])}")
    for i in sample:
        if eng.to_dict(docs[i]) != twin.to_dict(docs[i]):
            raise AssertionError(f"{docs[i]}: to_dict differs from CPU")
    if len(eng.to_dict(docs[7])["children"]["kids"]) != \
            3 + TREE_PIPE_WAVES:
        raise AssertionError("tree serving: the waves did not all apply")
    serve.update({
        "dict_ops_per_s": D / serve["dict_wave_s"],
        "records_ops_per_s": D / serve["records_wave_s"],
        "pipelined_ops_per_s": TREE_PIPE_WAVES * D / pipe_s,
        "pipelined_s": pipe_s, "pipeline_max_inflight": pipe["max_inflight"],
        "pipeline_overlap": pipe["overlap"],
        "pipeline_stage_busy_ms": pipe["stage_busy_ms"],
        "stage_ms_by_wave": [r["stage_ms"] for r in results]})
    serve_wire = captured.pop("wire")
    del twin

    # flat leaves on a second engine, with cached rows
    leng, ltwin = serving_engine(dev), serving_engine("cpu")
    lrows = np.array([leng.doc_row(d) for d in docs], np.int32)
    for d in docs:
        ltwin.doc_row(d)
    flat = [encode_leaf_records(["root"] * D, ["kids"] * D,
                                [f"{d}-f{w}" for d in docs], [w] * D, None,
                                [f"{d}-f{w - 1}" for d in docs])
            for w in range(1, TREE_PIPE_WAVES + 1)]
    seed_args = (docs, ones, ones, zeros, ["root"] * D, ["kids"] * D,
                 [f"{d}-f0" for d in docs], zeros)
    begin("flat serving")
    leng.ingest_leaves(*seed_args)
    leng.sync()
    lex = PipelinedIngestExecutor(leng, depth=3)
    t0 = time.perf_counter()
    lt = [lex.submit(None, ones, [w + 2] * D, zeros, b, rows=lrows)
          for w, b in enumerate(flat)]
    lex.drain()
    leng.sync()
    flat_s = time.perf_counter() - t0
    lres = [t.result() for t in lt]
    lpipe = lex.stats()
    lex.close()
    end()
    ltwin.ingest_leaves(*seed_args)
    for w, b in enumerate(flat):
        ltwin.ingest_records(None, ones, [w + 2] * D, zeros, b, rows=lrows)
    e = state_err(leng.store.state, ltwin.store.state)
    if e or sum(r["nacked"] for r in lres) or leng.overflowed_docs():
        raise AssertionError(f"flat serving: planes err {e}")
    for i in sample[:8]:
        if leng.to_dict(docs[i]) != ltwin.to_dict(docs[i]):
            raise AssertionError(f"{docs[i]}: flat to_dict differs")
    serve.update({"flat_ops_per_s": TREE_PIPE_WAVES * D / flat_s,
                  "flat_s": flat_s,
                  "flat_pipeline_max_inflight": lpipe["max_inflight"],
                  "flat_stage_busy_ms": lpipe["stage_busy_ms"]})
    tstore.apply_tree_wire_fused = wire_fused
    batch9 = encode_tree_batch(profile_tree_waves(docs, 9)[1])
    kernel_planes = eng.store.pack_records(
        np.arange(D, dtype=np.int64)[batch9["rec_op"]],
        eng._map_records(batch9["recs"], batch9),
        np.full(len(batch9["rec_op"]), 50, np.int64))
    serve_state = eng.store.state.clone()
    del eng, leng, ltwin
    torch.cuda.empty_cache()

    # ------------------------------------------- (c) mixed per-op
    ta.launch_apply = keep_widest   # until the timing, (e)
    mdocs = [f"m-{i}" for i in range(TREE_MIX_DOCS)]
    mixed = [TreeServingEngine(n_docs=TREE_MIX_DOCS, capacity=N,
                               batch_window=10 ** 9, sequencer="native",
                               device=d) for d in (dev, "cpu")]
    for e_ in mixed:
        for d in mdocs:
            for c in (1, 2, 3):
                e_.connect(d, c)
    pools = {}
    storm = tree_op_storm(mdocs, TREE_MIX_OPS, seed=5, pools=pools)
    rng = np.random.default_rng(5)
    plan, cseq, refs, out = [], {}, {}, []
    card_e = mixed[0]
    begin("per-op")
    t0 = time.perf_counter()
    for d, op in storm:
        # client c joined at seq c; its ref lags the doc by up to 5 and
        # never goes back
        c = int(rng.integers(1, 4))
        cseq[d, c] = cseq.get((d, c), 0) + 1
        refs[d, c] = max(refs.get((d, c), c), card_e.deli.doc_seq(d) -
                         int(rng.integers(0, 6)))
        plan.append((d, c, cseq[d, c], refs[d, c], op))
        out.append(card_e.submit(*plan[-1]))
    card_e.flush()
    end()
    per_op_s = time.perf_counter() - t0
    out_cpu = [mixed[1].submit(*x) for x in plan]
    mixed[1].flush()
    outcomes = [[(m.seq if m else None, n.reason.name if n else None)
                 for m, n in o_] for o_ in (out, out_cpu)]
    if outcomes[0] != outcomes[1]:
        raise AssertionError("per-op outcomes differ from the CPU twin")
    storm2 = tree_op_storm(mdocs, TREE_MIX_OPS, seed=6, pools=pools)
    ids = [d for d, _ in storm2]
    cs2 = []
    for d in ids:
        cseq[d, 1] = cseq.get((d, 1), 0) + 1
        cs2.append(cseq[d, 1])
    begin("per-op: ingest_batch")
    mres = [e_.ingest_batch(ids, [1] * len(ids), cs2, [0] * len(ids),
                            [op for _d, op in storm2]) for e_ in mixed]
    end()
    if not np.array_equal(mres[0]["seq"], mres[1]["seq"]):
        raise AssertionError("mixed ingest_batch acks differ from CPU")
    e = state_err(mixed[0].store.state, mixed[1].store.state)
    if e:
        raise AssertionError(f"mixed storms: planes err {e}")
    for d in mdocs[:TREE_SAMPLES]:
        if mixed[0].to_dict(d) != mixed[1].to_dict(d):
            raise AssertionError(f"{d}: mixed to_dict differs from CPU")
    kinds = collections.Counter(op["op"] for _d, op in storm + storm2)
    applied = sum(1 for s, _ in outcomes[0] if s is not None)
    del mixed
    torch.cuda.empty_cache()

    # ------------------------------------------- (d) recovery, summary, load
    rdocs = [f"r-{i}" for i in range(TREE_REC_DOCS)]
    rec_e = TreeServingEngine(n_docs=TREE_REC_DOCS, capacity=TREE_REC_CAP,
                              batch_window=10 ** 9, sequencer="native",
                              device=dev)
    ctl = TreeServingEngine(n_docs=TREE_REC_DOCS, capacity=1024,
                            batch_window=10 ** 9, sequencer="native",
                            device=dev)
    for e_ in (rec_e, ctl):
        for d in rdocs:
            e_.connect(d, 1)
            e_.doc_row(d)
    rcs = {}

    def grow_wave(w):
        """Wave 0: 20 inserts a doc; wave 1: 15 more and, on every 4th
        doc, 10 removes (they overflow, then fit after the rebuild); every
        16th doc also inserts 40 (it graduates)."""
        ops = []
        for i, d in enumerate(rdocs):
            n = 20 if w == 0 else 15 + (40 if i % 16 == 0 else 0)
            if w == 1 and i % 4:
                n = 4
            ops += [(d, {"op": "insert", "parent": "root",
                         "field": "kids", "after": None,
                         "nodes": [{"id": f"{d}-{w}-{k}", "value": k}]})
                    for k in range(n)]
            if w == 1 and i % 4 == 0:
                ops += [(d, {"op": "remove", "id": f"{d}-0-{k}"})
                        for k in range(10)]
        return ops

    def run_wave(ops, engines):
        ids = [d for d, _ in ops]
        cs = []
        for d in ids:
            rcs[d] = rcs.get(d, 0) + 1
            cs.append(rcs[d])
        for e_ in engines:
            r = e_.ingest_batch(ids, [1] * len(ids), cs, [0] * len(ids),
                                [op for _d, op in ops])
            if r["nacked"]:
                raise AssertionError("recovery wave nacked")
        return cs

    begin("recovery")
    t0 = time.perf_counter()
    for w in range(2):
        run_wave(grow_wave(w), (rec_e, ctl))
    overflowed = len(rec_e.overflowed_docs())
    t1 = time.perf_counter()
    report = rec_e.recover_overflowed()
    recover_s = time.perf_counter() - t1
    end()
    grown_s = t1 - t0
    kinds_rec = collections.Counter(report.values())
    if not (kinds_rec["reuploaded"] and kinds_rec["graduated"]) or \
            rec_e.overflowed_docs():
        raise AssertionError(f"tree recovery: {dict(kinds_rec)}")
    for d in rdocs:
        if rec_e.to_dict(d) != ctl.to_dict(d):
            raise AssertionError(f"{d}: recovered to_dict != control")
    # summaries and loads
    t1 = time.perf_counter()
    full = rec_e.summarize()
    tail1 = [(d, {"op": "setValue", "id": f"{d}-1-0", "value": "t1"})
             for d in rdocs[1::4]]   # flat docs only (i % 4 == 1)
    run_wave(tail1, (rec_e,))
    inc = rec_e.summarize(incremental=True)
    summ_s = time.perf_counter() - t1
    tail2 = [(d, {"op": "insert", "parent": "root", "field": "tail",
                  "after": None, "nodes": [{"id": f"{d}-tail"}]})
             for d in rdocs[2::4]]
    tail_cs = run_wave(tail2, (rec_e,))
    grad = [d for d, k in report.items() if k == "graduated"]
    for d in grad:
        rcs[d] += 1
        msg, nack = rec_e.submit(d, 1, rcs[d], 0, {
            "op": "setValue", "id": f"{d}-0-15", "value": "g"})
        if nack is not None:
            raise AssertionError(f"{d}: graduated submit nacked")
    # rows the tails wrote: a load re-applies them from the log and may
    # intern their handles in another order, so only their trees compare
    touched = {d for d, _ in tail1 + tail2} | set(grad)
    loads = []
    begin("load")
    for s in (full, inc):
        t1 = time.perf_counter()
        ld = TreeServingEngine.load(s, rec_e.log, device=dev,
                                    sequencer="native")
        loads.append(time.perf_counter() - t1)
        dg, ldg = rec_e.store.digests(), ld.store.digests()
        for d in rdocs:
            if ld.to_dict(d) != rec_e.to_dict(d) or \
                    ld.deli.doc_seq(d) != rec_e.deli.doc_seq(d):
                raise AssertionError(f"{d}: load differs from live")
            if d not in touched and d not in ld._graduated and \
                    dg[rec_e.doc_row(d)] != ldg[ld.doc_row(d)]:
                raise AssertionError(f"{d}: digest differs after load")
        msg, nack = ld.submit(tail2[0][0], 1, tail_cs[0], 0,
                              {"op": "remove", "id": "x"})
        if msg is not None or nack.seq != rec_e.deli.doc_seq(tail2[0][0]):
            raise AssertionError("resubmit was not dup-acked with its seq")
    end()
    recovery = {"docs": TREE_REC_DOCS, "capacity": TREE_REC_CAP,
                "overflowed": overflowed, "report": dict(kinds_rec),
                "grow_s": grown_s, "recover_s": recover_s,
                "summarize_s": summ_s, "load_s": loads,
                "reloads_equal_live": len(loads)}
    del rec_e, ctl
    torch.cuda.empty_cache()

    ta.launch_apply = launch_apply
    # ------------------------------------------- (e) timing
    def events_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z), out

    def time_apply(tag, before, planes, base):
        work = before.clone()

        def copy():
            for k, v in work.fields().items():
                v.copy_(getattr(before, k))

        def run():
            copy()
            ta.launch_apply(work, planes, base)

        t = {"ms": graph_ms(run, 20) - graph_ms(copy, 20),
             "call_ms": timed_events(run, 10) - timed_events(copy, 10)}
        if base is None:
            plain_ms, want = events_ms(lambda: tk.apply_tree_planes(
                before, planes))
        else:
            seq = tk.wire_seq(planes[8], base)
            plain_ms, want = events_ms(lambda: tk.apply_tree_batch(
                before, *planes[:7], seq, planes[7]))
        run()
        torch.cuda.synchronize()
        e = state_err(work, want)
        (b_ms, b_by), nbytes, active, real = tree_apply_bound(
            before, planes, base is not None)
        return {"spec": tag, "D": planes.shape[1],
                "N": before.node_id.shape[1],
                "launch_shape": ta.launch_shape(
                    before.node_id.shape[1], planes.shape[1],
                    torch.cuda.get_device_properties(0).multi_processor_count),
                "O": planes.shape[2], **t, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "active_docs": active, "records": real,
                "max_abs_err": e}

    before, wire_args, o = serve_wire
    cols, ids_, vals, row, pos, base = wire_args[:6]
    maps = wire_args[6:]
    dense = tk.expand_tree_wire(cols, ids_, vals, row, pos, *maps,
                                n_docs=D, o=o)
    kept = int(((pos.long() < o) & (row.long() < D)).sum())

    def time_expand(spec, wire):
        fn = lambda: kernel_timing.expand_call(tk, wire, D, o)  # noqa: E731
        w_ids, w_vals, w_pos = wire[1], wire[2], wire[4]
        wire_bytes = kept * (3 + 3 * w_ids.element_size()
                             + w_vals.element_size() + 2
                             + w_pos.element_size()) + \
            sum(4 * m.numel() for m in maps)
        x_bytes = wire_bytes + dense.numel() * 4
        xb_ms, xb_by = work_bound(x_bytes, 10 * kept)
        plain_ms, _ = events_ms(lambda: tk.expand_tree_wire(
            *wire[:5], *maps, n_docs=D, o=o))
        return {"spec": spec, "D": D, "o": o, "records": kept,
                "R": cols.shape[0], "ids": str(w_ids.dtype),
                "pos": str(w_pos.dtype), "ms": graph_ms(fn, 50),
                "call_ms": timed_events(fn, 10), "plain_ms": plain_ms,
                "bound_ms": xb_ms, "bound_by": xb_by, "bytes": x_bytes,
                "max_abs_err": diff(fn(), dense)}

    expand_rows = [time_expand(spec, wire) for spec, (_b, wire, _o) in
                   kernel_timing.expand_inputs(
                       tstore, None, dev,
                       served=(None, None, serve_wire)).items()]
    floor = kernel_timing.launch_floor()["ms"]
    apply_rows = [
        time_apply("wire mode: serving wave", before, dense, base),
        time_apply("planes mode: profile_tree kernel-alone shape",
                   serve_state, torch.from_numpy(kernel_planes).to(dev),
                   None)]
    if keep_inputs is not None:   # for the parent's kernel (--parent)
        torch.save({f"{tag}, N = {n_slots}: its widest launch": (
            {k: v.cpu() for k, v in st_w.fields().items()}, planes_w.cpu(),
            None if base_w is None else base_w.cpu())
            for (tag, n_slots), (_n, st_w, planes_w, base_w)
            in widest.items()}, keep_inputs)
    for (tag, n_slots), (_n, st_w, planes_w, base_w) in sorted(
            widest.items()):
        apply_rows.append(time_apply(
            f"{tag}, N = {n_slots}: its widest launch", st_w, planes_w,
            base_w))
        apply_rows[-1]["launches_at_this_N"] = widest_launches[
            tag, n_slots]
    del widest
    err["apply"] = max([err["apply"]] + [r["max_abs_err"]
                                         for r in apply_rows])
    err["expand"] = max([err["expand"]] + [r["max_abs_err"]
                                           for r in expand_rows])
    if err["apply"] or err["expand"]:
        raise AssertionError(f"tree kernels != plain after timing: {err}")
    # profile_tree.py's kernel-only loop: 8 applies back to back
    planes9 = torch.from_numpy(kernel_planes).to(dev)
    loop = serve_state.clone()
    t8, _ = events_ms(lambda: [ta.launch_apply(loop, planes9)
                               for _ in range(8)])
    emit({"phase": "tree", "docs": D, "capacity": N,
          "kernel_loop": {"batches": TREE_BATCHES, "O": O,
                          "overflowed_docs": kernel_ovf,
                          "wire": wire_rows},
          "serving": serve, "nacked": nacked,
          "mixed": {"docs": TREE_MIX_DOCS, "ops": len(plan),
                    "batch_ops": len(storm2), "acked_per_op": applied,
                    "per_op_s": per_op_s, "kinds": dict(kinds)},
          "recovery": recovery,
          "launches": {k: dict(v) for k, v in launches.items()},
          "max_abs_err": err, "timing": {"apply": apply_rows,
                                         "expand": expand_rows},
          "launch_floor_ms": floor,
          "kernel_only_8_applies_ms": t8,
          "total_s": time.perf_counter() - t_phase, "card": smi})

    def entry(kind, name, replaces, main, rows, **extra):
        return {"name": name, "route": "cuda", **extra,
                "source": "fluidframework_tpu_torch/csrc/tree_apply.cu",
                "replaces": replaces,
                "launches": sum(launches[kind].values()),
                "launches_by_path": dict(launches[kind]),
                "max_abs_err": err[kind], "ms": main["ms"],
                "call_ms": main["call_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None,
                "shape": {k: main.get(k) for k in ("D", "N", "O", "o",
                                                   "spec")},
                "specialisations": rows}

    return (entry("apply", "tree_apply",
                  "fluidframework_tpu/ops/tree_kernel.py:321,367",
                  apply_rows[0], apply_rows),
            entry("expand", "tree_expand",
                  "fluidframework_tpu/ops/tree_kernel.py:379",
                  expand_rows[0], expand_rows, launch_floor_ms=floor))


MEGA_ENGINE_DOCS, MEGA_CLIENTS = 16, 4   # (b): mega docs, clients a doc
MEGA_ENGINE_TARGET = 8192                # (b): active slots each doc passes
MEGA_TWIN_DOCS = 2                       # (b): docs the CPU twin is fed
MEGA_ENGINE_MAX_OPS = 12_000             # (b): ops a doc at most
MEGA_HISTORY_OPS = 20_500                # (c): ops of the history
MEGA_HISTORY_LIVE = 2_000                # (c): chars its text keeps
MEGA_PROP_SAMPLES = 512                  # (b): get_properties probes a doc
MEGA_FLOOR_LAG = 16                      # (a): compaction floor, ops back


class MegaOpStream:
    """Per-op string edits for the engine part of the megadoc phase: per
    doc, clients in turn with refs that lag the doc's seq by up to 8 and
    never go back; 55 % inserts of 2-4 chars, 15 % removes of 2 chars, 30 %
    annotates of 1-6 chars (one of 3 keys, a value or None). Positions are
    drawn below a conservative bound of what the op's perspective sees:
    the doc's estimated length at the ref seq, less 2 for every remove
    sequenced since (an estimate that counts every remove in full)."""

    KEYS, VALUES = ("bold", "color", "size"), (1, 2, "red", None)

    def __init__(self, docs, n_clients, seed):
        import numpy as np
        self.rng = np.random.default_rng(seed)
        self.docs = docs
        self.n_clients = n_clients
        self.est = {d: [0] for d in docs}     # estimate by doc seq
        self.rms = {d: [0] for d in docs}     # removes up to doc seq
        self.ref = {}
        self.cseq = {}

    def joined(self, doc, client, seq):
        """A client's JOIN sequenced at ``seq``."""
        self._grow(doc, seq, 0, False)
        self.ref[(doc, client)] = seq
        self.cseq[(doc, client)] = 0

    def _grow(self, doc, seq, delta, removed):
        est, rms = self.est[doc], self.rms[doc]
        while len(est) <= seq:
            est.append(est[-1])
            rms.append(rms[-1])
        est[seq] = est[seq - 1] + delta if seq else delta
        rms[seq] = rms[seq - 1] + removed if seq else removed

    def next(self, doc, client, doc_seq):
        """(client_seq, ref_seq, contents) of the client's next op on a doc
        whose last seq is ``doc_seq``; call ``acked`` with its seq."""
        r = self.rng.random(4)
        key = (doc, client)
        ref = max(self.ref[key], doc_seq - int(r[0] * 9))
        self.ref[key] = ref
        self.cseq[key] += 1
        bound = max(self.est[doc][ref]
                    - 2 * (self.rms[doc][doc_seq] - self.rms[doc][ref]), 0)
        if bound < 4 or r[1] < 0.55:
            n = 2 + int(r[2] * 3)
            op = {"mt": "insert", "kind": 0, "pos": int(r[3] * (bound + 1)),
                  "text": "abcdefgh"[int(r[2] * 5):][:n].ljust(n, "x")}
            self._pending = (len(op["text"]), False)
        elif r[1] < 0.70:
            start = int(r[3] * (bound - 2))
            op = {"mt": "remove", "start": start, "end": start + 2}
            self._pending = (-2, True)
        else:
            start = int(r[3] * (bound - 1))
            op = {"mt": "annotate", "start": start,
                  "end": min(start + 1 + int(r[2] * 6), bound),
                  "props": {self.KEYS[int(r[2] * 3)]:
                            self.VALUES[int(r[0] * 4)]}}
            self._pending = (0, False)
        return self.cseq[key], ref, op

    def acked(self, doc, seq):
        self._grow(doc, seq, *self._pending)


def megadoc_history(n_ops, seed, live=MEGA_HISTORY_LIVE, word=16):
    """(ops, text): one client's caught-up edits of a doc that keep its
    text near ``live`` chars while its history grows: inserts of ``word``
    chars and removes of ``word`` chars at random positions, most of them
    cutting a segment (two slots an op), and the text they leave."""
    import numpy as np
    rng = np.random.default_rng(seed)
    text, ops = "", []
    for _ in range(n_ops):
        if len(text) < live or rng.random() < 0.5:
            pos = int(rng.integers(0, len(text) + 1))
            w = "".join("abcdefghij"[int(c)]
                        for c in rng.integers(0, 10, word))
            ops.append({"mt": "insert", "kind": 0, "pos": pos, "text": w})
            text = text[:pos] + w + text[pos:]
        else:
            at = int(rng.integers(0, len(text) - word))
            ops.append({"mt": "remove", "start": at, "end": at + word})
            text = text[:at] + text[at + word:]
    return ops, text


def megadoc_phase(smi, dev, ptxas, keep_inputs=None):
    """Phase 10: the mega tier (long documents split into 8 shards, one
    thread-block cluster of K7 a doc). (a) 64 mega docs × 8 shards × 4,096
    slots, K = 4, grown by windows of 512 ops of ``megadoc_storm`` (typing
    and conflict storms) with a rebalance whenever a shard passes 75 %,
    until every doc holds more than 16,384 active slots, then compacted and
    taken 2 windows further: every K7 launch equal to the plain version on
    the same input, all planes; the widest launch timed (CUDA graph and
    eager) beside its bound. (b) ``StringServingEngine(mega_docs=16,
    mega_capacity_per_shard=4096)`` on the card: 16 docs marked mega, then
    per-op submits from 4 clients a doc (lagging refs; inserts, removes,
    annotates) until every doc passes 8,192 active slots; flush, compact,
    texts and sampled properties equal a ``device="cpu"`` twin fed the same
    stream for 2 of the docs; ops/s; the same plan replayed on a second
    card engine with every K7 launch held against the plain version on its
    input (all planes). (c) the engine's summary loaded on the
    card; a small engine's summary with a ``markMega`` in its tail loaded;
    a mega overflow that re-uploads and one that graduates
    (``tests/test_overflow_recovery.py``'s shapes); a mega doc at (b)'s
    shape whose history passes the tier while its text stays inside it,
    recovered through K7 as ``reuploaded``, equal to its shadow text (its
    ``device="cpu"`` twin, 220-300 s of the phase, was cut to keep the
    script inside its limit); every K7 launch of (c) held against the
    plain version.
    ``keep_inputs`` (a path) saves the widest kernel-loop and
    engine launches for ``kernel_timing.py --megadoc-inputs``. Returns the
    ``megadoc_apply`` kernels-line entry."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import megadoc_apply as ma
    from fluidframework_tpu_torch.ops import megadoc_kernel as mgk
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import kernel_timing as kt
    from fluidframework_tpu_torch.testing import synthetic

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    launches = {}
    seconds = {}

    def clone(st):
        return mt.StringState(**{k: v.clone()
                                 for k, v in st.fields().items()})

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    # ------------------------------------------------- (a) the kernel loop
    t0 = time.perf_counter()
    D, n, S, K, O = kt.MEGA_D, kt.MEGA_N, kt.MEGA_S, kt.MEGA_K, kt.MEGA_O
    windows = kt.megadoc_windows(synthetic, D, O, kt.MEGA_WINDOWS)
    st = mgk.create_megadoc_state(D, S, n, K, dev)
    err, widest, compacted_at, rebalances = 0, None, None, 0
    plain_s, kernel_launches = 0.0, 0
    ma.launches = 0   # the kernel loop starts here
    for w, planes in enumerate(windows):
        new = kt.megadoc_rebalance(mgk, st, S)
        rebalances += new is not st
        st = new
        ops = tuple(torch.from_numpy(planes[k]).to(dev)
                    for k in mt.OP_FIELDS)
        before = clone(st)
        torch.cuda.synchronize()
        tp = time.perf_counter()
        ref = mgk.apply_megadoc_plain(st, *ops)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - tp
        mgk.apply_megadoc_batch(st, *ops)
        torch.cuda.synchronize()
        kernel_launches += 1
        for k in mt.FIELDS:
            err = max(err, diff(getattr(st, k), getattr(ref, k)))
        if err:
            raise AssertionError(f"megadoc window {w}: K7 != plain, max abs "
                                 f"err {err}")
        del ref
        if compacted_at is None and \
                int(st.count.sum(dim=1).min()) > kt.MEGA_TARGET:
            widest = (before, ops)
            floor = planes["seq"][:, -1 - MEGA_FLOOR_LAG]
            st = mgk.compact_megadoc(st, torch.from_numpy(
                np.ascontiguousarray(floor)).to(dev))
            compacted_at = w
        elif compacted_at is not None and w >= compacted_at + 2:
            break
    launches["kernel_loop"] = ma.launches   # the kernel loop ends here
    if compacted_at is None or launches["kernel_loop"] != kernel_launches:
        raise AssertionError("megadoc kernel loop: the docs never passed "
                             f"{kt.MEGA_TARGET} active slots, or K7 was not "
                             "launched once a window")
    if st.overflow.any():
        raise AssertionError("megadoc kernel loop: a shard overflowed")
    loop = {"windows": w + 1, "compacted_after_window": compacted_at,
            "rebalances": rebalances,
            "active_slots_min_max_at_compaction": [
                int(widest[0].count.sum(dim=1).min()),
                int(widest[0].count.sum(dim=1).max())],
            "active_slots_after": int(st.count.sum()),
            "plain_s": plain_s}
    del st
    before, ops = widest
    work = clone(before)
    t = kt.time_in_place(lambda s: s.fields(), before, work,
                         lambda x: mgk.apply_megadoc_batch(x, *ops))
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    want = mgk.apply_megadoc_plain(before, *ops)
    z.record()
    torch.cuda.synchronize()
    for k in mt.FIELDS:
        err = max(err, diff(getattr(work, k), getattr(want, k)))
    bound_ms, nbytes = kt.megadoc_bound(D, n, S, O, K)
    timing = {"D": D, "n": n, "S": S, "O": O, "K": K,
              "spec": "widest kernel-loop launch", **t,
              "plain_ms": a.elapsed_time(z), "bound_ms": bound_ms,
              "bound_by": "bytes", "bytes": nbytes}
    keep_loop = widest
    del before, ops, work, want, widest
    torch.cuda.empty_cache()
    seconds["kernel_loop"] = time.perf_counter() - t0

    # ------------------------------------------------------ (b) the engine
    t0 = time.perf_counter()
    docs = [f"mega-{i}" for i in range(MEGA_ENGINE_DOCS)]

    def engine(device, n_mega, window):
        e = StringServingEngine(n_docs=4, capacity=64, batch_window=window,
                                compact_every=4, mega_docs=n_mega,
                                mega_capacity_per_shard=S, device=device)
        return e

    card = engine(dev, MEGA_ENGINE_DOCS, 1024)
    stream = MegaOpStream(docs, MEGA_CLIENTS, seed=11)
    plan = []
    kept = {}   # the input of the engine's last widest K7 launch
    checked = {"launches": 0, "err": 0}   # K7 launches of (b) and (c)
    recorded = []
    launch = ma.launch

    def keep_widest(state, *ops):
        if ops[0].shape[1] >= kept.get("O", 0):
            kept.update(O=ops[0].shape[1], state=clone(state),
                        ops=tuple(o.clone() for o in ops))
        launch(state, *ops)

    def recording_launch(state, *ops):
        # a K7 launch keeps its input and output (device copies), held
        # against the plain version outside the timed parts
        before = clone(state)
        launch(state, *ops)
        recorded.append((before, tuple(o.clone() for o in ops),
                         clone(state)))

    def check_recorded(docs_a_call=512):
        # the plain version is vectorised over docs, and each launch is
        # held against it on its own input: launches of one layout run as
        # the docs of one plain call, their op columns padded with NOOPs
        by_layout = {}
        for rec in recorded:
            by_layout.setdefault(tuple(rec[0].prop_val.shape) +
                                 tuple(rec[0].count.shape), []).append(rec)
        for recs in by_layout.values():
            per_call = max(1, docs_a_call // recs[0][0].count.shape[0])
            for i in range(0, len(recs), per_call):
                part = recs[i:i + per_call]
                width = max(r[1][0].shape[1] for r in part)
                cat = lambda j: mt.StringState(**{
                    k: torch.cat([getattr(r[j], k) for r in part])
                    for k in mt.FIELDS})
                ops = [torch.cat([torch.nn.functional.pad(
                    r[1][f], (0, width - r[1][f].shape[1]),
                    value=NOOP if f == 0 else 0) for r in part])
                    for f in range(7)]
                want = mgk.apply_megadoc_plain(cat(0), *ops)
                got = cat(2)
                checked["err"] = max([checked["err"]] + [
                    diff(getattr(got, k), getattr(want, k))
                    for k in mt.FIELDS])
                checked["launches"] += len(part)
        recorded.clear()
        if checked["err"]:
            raise AssertionError("megadoc: a K7 launch of the engine or "
                                 "recovery paths differs from the plain "
                                 "version")

    ma.launch = keep_widest
    ma.launches = 0   # the engine path starts here
    for d in docs:
        card.mark_mega(d)
        for c in range(1, MEGA_CLIENTS + 1):
            stream.joined(d, c, card.connect(d, c).seq)
    n_ops, per_doc = 0, 0
    while True:
        for _ in range(256):
            for d in docs:
                c = 1 + per_doc % MEGA_CLIENTS
                cs, ref, op = stream.next(d, c, card.deli.doc_seq(d))
                msg, nack = card.submit(d, c, cs, ref, op)
                if nack is not None:
                    raise AssertionError(f"megadoc engine: {d} nacked: "
                                         f"{nack}")
                stream.acked(d, msg.seq)
                plan.append((d, c, cs, ref, op))
                n_ops += 1
            per_doc += 1
        card.flush()
        card.compact()
        active = card.mega_store.slot_usage().sum(axis=1)
        if int(active.min()) > MEGA_ENGINE_TARGET:
            break
        if per_doc >= MEGA_ENGINE_MAX_OPS:
            raise AssertionError(f"megadoc engine: docs hold {active} "
                                 f"active slots after {per_doc} ops a doc")
    torch.cuda.synchronize()
    launches["engine"] = ma.launches   # the engine path ends here
    engine_s = time.perf_counter() - t0
    # the same plan again on a second card engine, every K7 launch kept
    # and held against the plain version (the timed run above copies
    # nothing but its widest input)
    t1 = time.perf_counter()
    ma.launch = recording_launch
    replay = engine(dev, MEGA_ENGINE_DOCS, 1024)
    for d in docs:
        replay.mark_mega(d)
        for c in range(1, MEGA_CLIENTS + 1):
            replay.connect(d, c)
    for i, (d, c, cs, ref, op) in enumerate(plan):
        if replay.submit(d, c, cs, ref, op)[1] is not None:
            raise AssertionError(f"megadoc replay: {d} nacked")
        if (i + 1) % (256 * MEGA_ENGINE_DOCS) == 0:
            replay.flush()
            replay.compact()
    replay.flush()
    replay.compact()
    ma.launch = launch
    if [replay.read_text(d) for d in docs] != \
            [card.read_text(d) for d in docs]:
        raise AssertionError("megadoc replay: texts differ from the engine")
    del replay
    check_recorded()
    seconds["engine_replay_plain_checks"] = time.perf_counter() - t1
    if launches["engine"] <= 0:
        raise AssertionError("megadoc engine never launched K7")
    if card.overflowed_docs():
        raise AssertionError(f"megadoc engine overflowed: "
                             f"{card.overflowed_docs()}")
    t1 = time.perf_counter()
    twin = engine("cpu", MEGA_TWIN_DOCS, 1024 // 8)
    sampled = docs[:MEGA_TWIN_DOCS]
    for d in sampled:
        twin.mark_mega(d)
        for c in range(1, MEGA_CLIENTS + 1):
            twin.connect(d, c)
    for d, c, cs, ref, op in plan:
        if d in sampled:
            msg, nack = twin.submit(d, c, cs, ref, op)
            if nack is not None:
                raise AssertionError(f"megadoc twin: {d} nacked: {nack}")
    twin.flush()
    twin.compact()
    twin_s = time.perf_counter() - t1
    rng = np.random.default_rng(3)
    lengths = {}
    for d in sampled:
        text = card.read_text(d)
        if text != twin.read_text(d):
            raise AssertionError(f"megadoc engine: {d} text differs from "
                                 "the CPU twin")
        lengths[d] = len(text)
        for pos in rng.integers(0, len(text), size=MEGA_PROP_SAMPLES):
            if card.get_properties(d, int(pos)) != \
                    twin.get_properties(d, int(pos)):
                raise AssertionError(f"megadoc engine: {d}@{pos} props "
                                     "differ from the CPU twin")
    before, ops = kept["state"], kept["ops"]
    work = clone(before)
    t = kt.time_in_place(lambda s: s.fields(), before, work,
                         lambda x: mgk.apply_megadoc_batch(x, *ops))
    a.record()
    want = mgk.apply_megadoc_plain(before, *ops)
    z.record()
    torch.cuda.synchronize()
    for k in mt.FIELDS:
        err = max(err, diff(getattr(work, k), getattr(want, k)))
    De, ne = before.count.shape
    bound_ms, nbytes = kt.megadoc_bound(De, ne, S, kept["O"], K)
    timing_engine = {"D": De, "n": ne, "S": S, "O": kept["O"], "K": K,
                     "spec": "widest engine launch", **t,
                     "plain_ms": a.elapsed_time(z), "bound_ms": bound_ms,
                     "bound_by": "bytes", "bytes": nbytes,
                     "active_slots_min": int(before.count.sum(dim=1).min())}
    kept_state, kept_ops = kept.pop("state"), kept.pop("ops")
    del before, ops, work, want, kept
    serve = {"docs": MEGA_ENGINE_DOCS, "clients_a_doc": MEGA_CLIENTS,
             "ops": n_ops, "ops_a_doc": per_doc, "engine_s": engine_s,
             "ops_per_s": n_ops / engine_s, "twin_s": twin_s,
             "active_slots_min_max": [int(active.min()), int(active.max())],
             "twin_docs": sampled, "text_lengths": lengths}
    seconds["engine"] = time.perf_counter() - t0

    # -------------------------------------- (c) summaries and recovery
    t0 = time.perf_counter()
    ma.launch = recording_launch
    ma.launches = 0   # the summary / recovery path starts here
    loaded = StringServingEngine.load(card.summarize(), card.log,
                                      device=dev)
    for d in docs:
        if loaded.read_text(d) != card.read_text(d):
            raise AssertionError(f"megadoc load: {d} text differs")
    del card, twin, loaded
    torch.cuda.empty_cache()

    small = StringServingEngine(n_docs=1, capacity=16, batch_window=4,
                                mega_docs=1, mega_capacity_per_shard=64,
                                n_partitions=4, device=dev)
    small.connect("old", 1)
    small.submit("old", 1, 1, 1, {"mt": "insert", "kind": 0, "pos": 0,
                                  "text": "x"})
    summary = small.summarize()
    small.mark_mega("huge")   # a markMega in the log tail
    small.connect("huge", 5)
    want = ""
    for i in range(30):
        word = f"t{i} "
        small.submit("huge", 5, i + 1, small.deli.doc_seq("huge"),
                     {"mt": "insert", "kind": 0, "pos": len(want),
                      "text": word})
        want += word
    tail = StringServingEngine.load(summary, small.log, device=dev)
    if tail.read_text("huge") != want or tail.read_text("old") != "x" \
            or "huge" not in tail._mega_rows or tail.overflowed_docs():
        raise AssertionError("megadoc: a markMega in the tail did not "
                             "replay onto the mega tier")

    def overflowed(n_churn, n_keep):
        e = StringServingEngine(n_docs=1, capacity=64, batch_window=8,
                                compact_every=10 ** 9, mega_docs=1,
                                mega_capacity_per_shard=16, device=dev)
        e.auto_recover = False
        e.mark_mega("m")
        e.connect("m", 1)
        cs, shadow = 0, ""
        for _ in range(n_churn):
            for op in ({"mt": "insert", "kind": 0, "pos": 0, "text": "ab"},
                       {"mt": "remove", "start": 0, "end": 2}):
                cs += 1
                e.submit("m", 1, cs, e.deli.doc_seq("m"), op)
        for i in range(n_keep):
            cs += 1
            e.submit("m", 1, cs, e.deli.doc_seq("m"),
                     {"mt": "insert", "kind": 0, "pos": 0, "text": f"k{i}"})
            shadow = f"k{i}" + shadow
        e.flush()
        if e.overflowed_docs() != ["m"]:
            raise AssertionError("megadoc: the mega doc did not overflow")
        return e, shadow

    recovery = {}
    for name, churn, keep in (("reuploaded", 150, 10),
                              ("graduated", 0, 200)):
        e, shadow = overflowed(churn, keep)
        report = e.recover_overflowed()
        if report != {"m": name} or e.overflowed_docs() or \
                e.read_text("m") != shadow:
            raise AssertionError(f"megadoc recovery: {report}, want "
                                 f"{{'m': {name!r}}}")
        recovery[name] = report
    torch.cuda.synchronize()
    launches["summary_recovery"] = ma.launches   # the path ends here
    seconds["summary_recovery"] = time.perf_counter() - t0

    # the engine's shape: a history past the tier's 8 × 4,096 slots with
    # live text inside it, recovered through K7 on a wider layout and held
    # against the shadow text
    t0 = time.perf_counter()
    hist_ops, shadow = megadoc_history(MEGA_HISTORY_OPS, seed=21)
    big = {}

    def history(device):
        e = StringServingEngine(n_docs=1, capacity=64, batch_window=1024,
                                compact_every=10 ** 9, mega_docs=1,
                                mega_capacity_per_shard=S, device=device)
        e.auto_recover = False
        e.mark_mega("big")
        e.connect("big", 1)
        for cs, op in enumerate(hist_ops, 1):
            if e.submit("big", 1, cs, e.deli.doc_seq("big"), op)[1]:
                raise AssertionError(f"megadoc history: op {cs} nacked")
        e.flush()
        if e.overflowed_docs() != ["big"]:
            raise AssertionError("megadoc history: the mega doc did not "
                                 "overflow the tier")
        torch.cuda.synchronize()
        ma.launches = 0   # the recovery at the engine's shape starts
        t1 = time.perf_counter()
        report = e.recover_overflowed()
        torch.cuda.synchronize()
        launches["recovery"] = ma.launches   # ... and ends here
        big[device] = {"report": report, "recover_s": time.perf_counter() - t1,
                       "text": e.read_text("big"),
                       "live_slots": int(e.mega_store.slot_usage()[0].sum()),
                       "rebuild": e.last_mega_rebuild}
        if report != {"big": "reuploaded"} or e.overflowed_docs() or \
                big[device]["text"] != shadow:
            raise AssertionError(f"megadoc recovery at the engine's shape "
                                 f"on {device}: {report}")

    try:
        history(dev)
    finally:
        ma.launch = launch
    t1 = time.perf_counter()
    check_recorded()
    seconds["summary_recovery_plain_checks"] = time.perf_counter() - t1
    if launches["recovery"] <= 0:
        raise AssertionError("megadoc recovery at the engine's shape: K7 "
                             "was not launched")
    hist = {"ops": len(hist_ops), "text_chars": len(shadow),
            "launches": launches["recovery"],
            **{f"{k}_card": big[dev][k]
               for k in ("recover_s", "live_slots", "rebuild")},
            "report": big[dev]["report"]}
    recovery["engine_shape"] = hist
    seconds["recovery_engine_shape"] = time.perf_counter() - t0
    err = max(err, checked["err"])

    clusters = {f"{c}x{S}": ma.active_clusters(c, S, K) for c in (8, 16)}
    for row in (timing, timing_engine):
        # cluster waves a launch takes, and the time an op column takes
        # in each wave (the ops of a doc are a serial chain)
        row["waves"] = -(-row["D"] // ma.active_clusters(row["n"], S, K))
        row["us_per_op_wave"] = row["ms"] * 1e3 / (row["O"] * row["waves"])
    if keep_inputs:
        kt.save_inputs(keep_inputs, {
            "widest kernel-loop launch": keep_loop,
            "widest engine launch": (kept_state, kept_ops)})
    del keep_loop, kept_state, kept_ops
    k7 = [k for k in ptxas if "megadoc_apply_kernel" in k.get("entry", "")]
    if not k7:
        raise RuntimeError("no -Xptxas -v report for megadoc_apply")
    emit({"phase": "megadoc", "docs": D, "shards": n, "slots_a_shard": S,
          "K": K, "ops_a_window": O, "kernel_loop": loop,
          "timing": [timing, timing_engine], "engine": serve,
          "summary_recovery": recovery, "launches": launches,
          "launches_checked_against_plain": checked["launches"],
          "max_abs_err": err, "active_clusters": clusters,
          "max_slots_per_shard": ma.max_slots_per_shard(K),
          "slots_a_lane_threads": ma.launch_shape(S),
          "max_shards": ma.max_shards(S, K), "ptxas": k7,
          "seconds": seconds, "total_s": time.perf_counter() - t_phase,
          "card": smi})
    return {"name": "megadoc_apply", "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/megadoc_apply.cu",
            "replaces": "fluidframework_tpu/ops/megadoc_kernel.py:154",
            "launches": launches["kernel_loop"] + launches["engine"],
            "launches_by_path": launches, "max_abs_err": err,
            "ms": timing["ms"], "call_ms": timing["call_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": {k: timing[k] for k in ("D", "n", "S", "O", "K",
                                             "spec")},
            "specialisations": [timing, timing_engine],
            "active_clusters": clusters, "ptxas": k7}


IV_EVERY = 10          # every 10th row holds intervals (1,024 docs)
IV_HEARTBEAT_STEP = 16  # heartbeats on every 16th interval doc (64 docs)
IV_REC_DOCS, IV_REC_CAP = 1024, 128    # the recovery part's engine


def intervals_phase(smi, dev):
    """Phase 11: intervals on the string engine at config #4's width.
    (a) serving with 1,024 interval docs, waves cut into segments, every
    B1 launch of one wave against the plain version, a CPU twin of 64
    sampled docs, beside a second card engine without intervals; (b) a
    1,024-doc engine whose interval docs overflow, re-upload, graduate
    and regrow, against a CPU twin; (c) full and incremental summaries of
    both loaded on the card. Returns (launches of (a)'s path, launches of
    (b)'s, max abs error, the line's summary)."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.ops import string_store
    from fluidframework_tpu_torch.server.ingest_pipeline import (
        PipelinedIngestExecutor,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import synthetic

    t_phase = time.perf_counter()
    docs = [f"iv-{i}" for i in range(D)]
    iv_set = set(range(0, D, IV_EVERY))
    hb_set = set(sorted(iv_set)[::IV_HEARTBEAT_STEP])
    rng = np.random.default_rng(12)
    lengths = np.full(D, len(synthetic.IV_BASE_TEXT), np.int64)
    waves = [synthetic.interval_wave(rng, lengths, O, w)
             for w in range(N_BATCHES + 1)]

    def spans_of(i):
        return [(2 + k, 6 + 3 * k, {"note": k, "doc": i}) for k in range(4)]

    def engine(device, idx, intervals, n_docs=None, capacity=S_SERVE):
        """An engine holding docs ``idx`` in rows 0.. with the base text
        and, if ``intervals``, the interval docs' spans. Returns (engine,
        rows, {row: interval ids})."""
        e = StringServingEngine(n_docs=n_docs or len(idx), capacity=capacity,
                                batch_window=10 ** 9, compact_every=1,
                                sequencer="native", device=device)
        rows = np.arange(len(idx), dtype=np.int32)
        for i in idx:
            e.connect(docs[i], 1)
        if [e.doc_row(docs[i]) for i in idx] != rows.tolist():
            raise AssertionError("rows not allocated in doc order")
        one = np.ones((len(idx), 1), np.int32)
        e.ingest_planes(rows, one, one, 0 * one, 0 * one, 0 * one, 0 * one,
                        text=synthetic.IV_BASE_TEXT)
        ids = {}
        if intervals:
            ids = e.store.add_intervals_bulk(
                {r: spans_of(i) for r, i in enumerate(idx) if i in iv_set})
        return e, rows, ids

    def sub(w, idx):
        return {k: (v[idx] if isinstance(v, np.ndarray) else v)
                for k, v in w.items()}

    def heartbeats(e, idx, wave_next):
        # at the next wave's pinned ref: the floor passes the tombstones of
        # the waves so far outside the op stream (a slide on interval docs)
        for i in idx:
            if i in hb_set:
                e.heartbeat(docs[i], 1, 2 + wave_next * O)

    def drive(e, rows, idx, per_wave=None):
        """The warm-up serially, heartbeats, waves 1-2 pipelined,
        heartbeats, waves 3-4 pipelined. Returns the timed waves' walls."""
        if e.ingest_planes(rows, **sub(waves[0], idx))["nacked"]:
            raise AssertionError("intervals: nacked warm-up ops")
        heartbeats(e, idx, 1)
        walls = []
        with PipelinedIngestExecutor(e, depth=3) as ex:
            for lo, hi in ((1, 3), (3, 5)):
                t0 = time.perf_counter()
                tks = [ex.submit(rows, **sub(w, idx)) for w in waves[lo:hi]]
                ex.drain()
                if any(tk.result()["nacked"] for tk in tks):
                    raise AssertionError("intervals: nacked ops")
                for tk in tks:
                    walls.append(tk.t_done - t0)
                    t0 = tk.t_done
                heartbeats(e, idx, hi)
            busy = ex.stats()["stage_busy_ms"]
        torch.cuda.synchronize()
        return walls, busy

    # (a) serving: the interval engine, its per-wave record, one wave's
    # launches kept to hold against the plain version
    every = list(range(D))
    live, rows, ids = engine(dev, every, True)
    store = live.store
    per_wave, kept, compactions = [], [], []
    fused = string_store.apply_string_batch_fused
    keep_wave = N_BATCHES   # the last wave

    def clone(st):
        return mt.StringState(**{k: v.clone()
                                 for k, v in st.fields().items()})

    def keep(state, *ops, min_seq=None, with_props=False):
        if len(per_wave) != keep_wave:
            return fused(state, *ops, min_seq=min_seq,
                         with_props=with_props)
        before = clone(state)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fused(state, *ops, min_seq=min_seq, with_props=with_props)
        b.record()
        kept.append((before, clone(state), ops, min_seq, with_props, a, b))
        return state

    apply_planes, compact = store.apply_planes, store.compact

    def recording_apply(*a, **kw):
        reads, shapes = store.device_reads, dict(sk.shapes)
        t0 = time.perf_counter()
        apply_planes(*a, **kw)
        host_s = time.perf_counter() - t0
        by_width = {}
        for (d_, s_, o_, k_, c_), n in sk.shapes.items():
            if d_ == D and n > shapes.get((d_, s_, o_, k_, c_), 0):
                by_width[o_] = by_width.get(o_, 0) + \
                    n - shapes.get((d_, s_, o_, k_, c_), 0)
        per_wave.append({**store.last_apply_stats,
                         "slide_gathers": store.device_reads - reads,
                         "launches_by_width": by_width,
                         "apply_planes_host_s": host_s})

    def timed_compact(ms):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        compact(ms)
        b.record()
        compactions.append((a, b, time.perf_counter() - t0))

    store.apply_planes, store.compact = recording_apply, timed_compact
    string_store.apply_string_batch_fused = keep
    reads0 = store.device_reads
    try:
        sk.launches = 0   # the interval path starts here
        walls, busy = drive(live, rows, every)
        iv_launches = sk.launches   # and ends here
    finally:
        string_store.apply_string_batch_fused = fused
    store.apply_planes, store.compact = apply_planes, compact
    heartbeat_reads = store.device_reads - reads0 - sum(
        w["slide_gathers"] for w in per_wave)
    if live.overflowed_docs():
        raise AssertionError("intervals: docs overflowed at S=512")
    if iv_launches <= 0:
        raise AssertionError("the interval path never launched string_apply")
    if max(w["segments"] for w in per_wave) < 2:
        raise AssertionError(f"no wave was cut into segments: {per_wave}")
    if sum(w["segments"] for w in per_wave) != iv_launches:
        raise AssertionError("launches differ from the segments")
    compact_device_ms = [a.elapsed_time(b) for a, b, _ in compactions]
    compact_host_s = [h for _, _, h in compactions]

    # every launch of the kept wave against the plain version, all planes
    max_err = 0
    launch_ms = [{"O": ops[0].shape[1], "ms": a.elapsed_time(b)}
                 for _, _, ops, _, _, a, b in kept]
    for before, after, ops, ms, props, _, _ in kept:
        ref = mt.apply_string_batch(before, *ops, with_props=props)
        if ms is not None:
            ref = mt.compact_string_state(ref, ms, props)
        for k in mt.FIELDS:
            a, b = getattr(after, k), getattr(ref, k)
            err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            max_err = max(max_err, err)
    if max_err or not kept:
        raise AssertionError(f"intervals: kernel != plain on the kept wave "
                             f"({len(kept)} launches, max abs err {max_err})")
    n_kept = len(kept)
    del kept
    torch.cuda.empty_cache()

    # the same waves and heartbeats on a card engine without intervals
    bare, brows, _ = engine(dev, every, False)
    bare_walls, bare_busy = drive(bare, brows, every)
    bare_segments = bare.store.last_apply_stats["segments"]
    del bare
    torch.cuda.empty_cache()

    # a CPU twin of 64 sampled docs: 32 interval docs (half of them
    # heartbeated), 32 without
    ivs = sorted(iv_set)
    sample = sorted(set(ivs[0::64]) | set(ivs[1::64])
                    | set(range(5, D, D // 32)))
    twin, trows, tids = engine("cpu", sample, True)
    drive(twin, trows, sample)

    def canonical(e, rows_):
        """Each row's [0, count) planes with handle_op ranked within the
        row, the payload of each rank, and the digest of the ranked state:
        what two engines that number payloads apart must agree on."""
        st = e.store.state
        idx = torch.as_tensor(np.asarray(rows_, np.int64),
                              device=st.seq.device)
        part = mt.StringState(**{k: getattr(st, k)[idx].clone()
                                 for k in mt.FIELDS})
        hop, cnt = part.handle_op.cpu().numpy(), part.count.cpu().numpy()
        pays = []
        for j, n in enumerate(cnt):
            u, inv = np.unique(hop[j, :n], return_inverse=True)
            hop[j, :n], hop[j, n:] = inv, 0
            pays.append([e.store._payloads[h] for h in u])
        part.handle_op = torch.as_tensor(hop, device=st.seq.device)
        planes = {k: getattr(part, k).cpu().numpy() for k in
                  mt.PLANES + ("prop_val",)}
        return (mt.string_state_digest(part).cpu().numpy(), pays, cnt,
                planes)

    c_live, c_twin = canonical(live, sample), canonical(twin, trows)
    for j, i in enumerate(sample):
        n = c_live[2][j]
        if live.read_text(docs[i]) != twin.read_text(docs[i]) or \
                n != c_twin[2][j] or c_live[1][j] != c_twin[1][j] or \
                c_live[0][j] != c_twin[0][j] or any(
                    not np.array_equal(c_live[3][k][j, :n],
                                       c_twin[3][k][j, :n])
                    for k in c_live[3]):
            raise AssertionError(f"{docs[i]}: differs from the CPU twin")
        if i in iv_set:
            a = live.store.intervals(i)
            b = twin.store.intervals(j)
            if [a[x] for x in ids[i]] != [b[x] for x in tids[j]]:
                raise AssertionError(f"{docs[i]}: intervals differ from "
                                     "the CPU twin")
    del twin

    # (c) on (a)'s engine: a full summary, per-op edits and interval
    # changes, an incremental one; both load on the card
    def summaries(e, edit_doc, cs, rows_):
        """Full summary, 16 per-op removes from ``edit_doc`` on, one
        interval of ``edit_doc``'s row swapped for a late one, incremental
        summary; each loaded on the card and held against ``e``: the
        intervals of ``rows_`` (the full summary's apart from the edited
        row, which changed after it), texts and the next interval id.
        Returns (summarize s, [load s])."""
        t0 = time.perf_counter()
        s_full = e.summarize()
        start = e._doc_rows[edit_doc]
        edited = []
        for d, r in sorted(e._doc_rows.items(), key=lambda x: x[1]):
            if r >= start and len(edited) < 16:
                edited.append(d)
                _, nack = e.submit(d, 1, cs, e.deli.doc_seq(d),
                                   {"mt": "remove", "start": 3, "end": 8})
                if nack is not None:
                    raise AssertionError(f"{d}: edit nacked {nack}")
        e.store.remove_interval(start, next(iter(e.store._intervals[start])))
        e.store.add_interval(start, 1, 5, {"late": True})
        s_inc = e.summarize(incremental=True)
        summarize_s = time.perf_counter() - t0
        load_s = []
        for k, s in enumerate((s_full, s_inc)):
            t0 = time.perf_counter()
            loaded = StringServingEngine.load(s, e.log, device=dev,
                                              sequencer="native")
            torch.cuda.synchronize()
            load_s.append(time.perf_counter() - t0)
            for r in rows_:
                if (k or r != start) and \
                        e.store.intervals(r) != loaded.store.intervals(r):
                    raise AssertionError(f"row {r}: loaded intervals "
                                         "differ")
            for d, st in e._graduated.items():
                if loaded._graduated[d].intervals(0) != st.intervals(0):
                    raise AssertionError(f"{d}: loaded graduated "
                                         "intervals differ")
            for d in edited:
                if loaded.read_text(d) != e.read_text(d):
                    raise AssertionError(f"{d}: loaded text differs")
            # the full summary predates the late interval
            want = e.store._interval_counter + k
            nxt = loaded.store.add_interval(start, 0, 1)
            if nxt != f"iv{want}":
                raise AssertionError(f"the loaded id counter gave {nxt}, "
                                     f"not iv{want}")
            del loaded
        return summarize_s, load_s

    summarize_s, load_s = summaries(live, docs[0], 2 + (N_BATCHES + 1) * O,
                                    sorted(iv_set))
    del live
    torch.cuda.empty_cache()

    # (b) recovery: every doc of a 1,024-doc engine at capacity 128 holds
    # intervals; every 16th takes inserts only (they graduate), the rest
    # churn and are heartbeated past their tombstones before recovery
    rec_idx = list(range(0, D, IV_EVERY))[:IV_REC_DOCS]
    n = len(rec_idx)
    grow = np.zeros(n, bool)
    grow[::16] = True

    def rec_engine(device):
        e = StringServingEngine(n_docs=n, capacity=IV_REC_CAP,
                                batch_window=10 ** 9, compact_every=1,
                                sequencer="native", device=device)
        e.auto_recover = False
        rows_ = np.arange(n, dtype=np.int32)
        for i in rec_idx:
            e.connect(docs[i], 1)
            e.doc_row(docs[i])
        one = np.ones((n, 1), np.int32)
        e.ingest_planes(rows_, one, one, 0 * one, 0 * one, 0 * one,
                        0 * one, text=synthetic.IV_BASE_TEXT)
        e.store.add_intervals_bulk({r: spans_of(i)
                                    for r, i in enumerate(rec_idx)})
        return e, rows_

    (rc, rrows), (rt, _) = rec_engine(dev), rec_engine("cpu")
    rrng = np.random.default_rng(13)
    rlengths = np.full(n, len(synthetic.IV_BASE_TEXT), np.int64)
    t0 = time.perf_counter()
    sk.launches = 0   # the interval recovery path starts here
    for w in range(8):
        wave = synthetic.interval_wave(rrng, rlengths, O, w,
                                       inserts_only=grow)
        for e in (rc, rt):
            if e.ingest_planes(rrows, **wave)["nacked"]:
                raise AssertionError("intervals (b): nacked ops")
        over = set(rc.overflowed_docs())
        if {docs[rec_idx[r]] for r in np.flatnonzero(grow)} <= over and \
                len(over) >= 2 * grow.sum():
            break
    n_waves = w + 1
    for e in (rc, rt):
        for r in np.flatnonzero(~grow):
            e.heartbeat(docs[rec_idx[r]], 1, 2 + n_waves * O)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = rc.recover_overflowed()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    if rep != rt.recover_overflowed() or \
            set(rep.values()) != {"reuploaded", "graduated"}:
        raise AssertionError(f"intervals (b): reports {rep}")
    grown = sorted(rc._graduated)[0]
    cs = 2 + n_waves * O
    while not rc._graduated[grown].overflowed().any():
        for e in (rc, rt):
            _, nack = e.submit(grown, 1, cs, e.deli.doc_seq(grown), {
                "mt": "insert", "kind": 0, "pos": 1, "text": "Q"})
            if nack is not None:
                raise AssertionError(f"{grown}: nacked {nack}")
            e.flush()
        cs += 1
    regrow = [e.recover_overflowed() for e in (rc, rt)]
    if regrow != [{grown: "regrown"}] * 2:
        raise AssertionError(f"intervals (b): regrow {regrow}")
    rec_launches = sk.launches   # and ends here

    def same_engine(a, b):
        if a._doc_rows != b._doc_rows or \
                sorted(a._graduated) != sorted(b._graduated):
            raise AssertionError("intervals (b): rows or tiers differ")
        for d in list(a._doc_rows) + list(a._graduated):
            if a.read_text(d) != b.read_text(d):
                raise AssertionError(f"{d}: text differs")
        if not np.array_equal(a.store.digests(), b.store.digests()):
            raise AssertionError("intervals (b): flat digests differ")
        for d, st in a._graduated.items():
            if st.digests()[0] != b._graduated[d].digests()[0]:
                raise AssertionError(f"{d}: graduated digest differs")
        pairs = [(a.store, b.store, range(n))] + [
            (s, b._graduated[d], [0]) for d, s in a._graduated.items()]
        for x, y, rows_ in pairs:
            if x._intervals != y._intervals or \
                    x._interval_counter != y._interval_counter:
                raise AssertionError("intervals (b): anchors differ")
            for r in rows_:
                if x._intervals[r] and x.intervals(r) != y.intervals(r):
                    raise AssertionError(f"row {r}: intervals differ")

    same_engine(rc, rt)
    del rt
    edit = next(d for d, r in sorted(rc._doc_rows.items(),
                                     key=lambda x: x[1])
                if rc.store._intervals[r])
    rsummarize_s, rload_s = summaries(rc, edit, 2 + n_waves * O, range(n))
    del rc
    torch.cuda.empty_cache()

    line = {"phase": "intervals", "docs": D, "capacity": S_SERVE,
            "interval_docs": len(iv_set), "intervals_a_doc": 4,
            "heartbeat_docs": len(hb_set), "ops_per_wave": D * O,
            "waves": [{"wall_s": wall, **pw} for wall, pw in
                      zip([None] + walls, per_wave)],
            "bare_wave_wall_s": bare_walls,
            "stage_busy_ms": busy, "bare_stage_busy_ms": bare_busy,
            "kept_wave_launch_ms": launch_ms,
            "bare_last_wave_segments": bare_segments,
            "heartbeat_slide_gathers": heartbeat_reads,
            "compaction_device_ms": compact_device_ms,
            "compaction_host_s": compact_host_s,
            "kept_wave_launches_checked": n_kept, "max_abs_err": max_err,
            "kernel_launches": iv_launches,
            "sampled_docs_match_cpu": len(sample),
            "summarize_s": summarize_s, "load_s": load_s,
            "recovery": {"docs": n, "capacity": IV_REC_CAP,
                         "waves": n_waves, "feed_s": feed_s,
                         "recover_s": recover_s,
                         "reuploaded": sum(v == "reuploaded"
                                           for v in rep.values()),
                         "graduated": sum(v == "graduated"
                                          for v in rep.values()),
                         "regrown": grown, "kernel_launches": rec_launches,
                         "summarize_s": rsummarize_s, "load_s": rload_s},
            "total_s": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    return iv_launches, rec_launches, max_err


MESH_SHARDS = 4                 # doc shards of the one-card mesh
MESH_WAVES = 3                  # config #4 waves after a warm-up
MESH_TWIN_D = 512               # the CPU twin's doc count
MESH_REP_S = 384                # the replicated step's slot capacity
MESH_TREE_WAVES = 3             # profile_tree.py waves
MESH_MX_STORMS = 2              # setCell storms of 4,096


def mesh_phase(smi, dev, D=D, O=O, S=S_SERVE, twin_d=MESH_TWIN_D,
               rep_s=MESH_REP_S, map_d=MAP_D, tree_d=TREE_D,
               mx_docs=MX_DOCS):
    """Phase 12: doc-sharded and replicated state (``parallel/``). On a
    mesh of ``MESH_SHARDS`` doc shards all on ``dev`` (a card named
    several times) and on the mesh of every card present: (a) config #4
    served sharded (warm-up + ``MESH_WAVES`` waves), per-doc digests equal
    the unsharded engine's on the card, string_apply launched once a shard
    a wave; a sharded card engine at ``twin_d`` docs equal to a CPU twin
    on CPU shards; the summary loaded sharded and unsharded, digest-equal;
    (b) the replicated step, 2 replicas × 2 doc shards at D docs, S =
    ``rep_s``: ``agree`` 1 and digests equal one B1 apply, and 0 with
    ``inject_divergence``; (c) the map, tree and matrix engines sharded
    against unsharded at their phases' shapes (fewer waves), K1-K5 each
    launched on every shard; (d) the collective-free check. Returns
    {path: {kernel: {shard: launches}}} of (a)-(c)."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.parallel import (
        make_doc_mesh, make_mesh, make_replicated_step, shard_ops,
        shard_state,
    )
    from fluidframework_tpu_torch.parallel import sharded
    from fluidframework_tpu_torch.server.serving import (
        MapServingEngine, MatrixServingEngine, StringServingEngine,
        TreeServingEngine,
    )
    from fluidframework_tpu_torch.testing.synthetic import (
        map_serving_batch, profile_tree_waves, typing_storm,
    )

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    card = make_doc_mesh(devices=[dev] * MESH_SHARDS)
    meshes = {"4_on_one": card}
    if on_card:
        meshes["every_card"] = make_doc_mesh()
    launches: dict = {}

    def sync():
        if on_card:
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)

    def begin():
        sync()
        sharded.reset_shard_launches()

    def end(label, mesh):
        """Launches a shard of the path just driven; every kernel that ran
        must have run on every shard."""
        sync()
        got = sharded.shard_launches()
        path = launches.setdefault(label, {})
        for name, per in got.items():
            if on_card and sorted(per) != list(range(mesh.size)):
                raise AssertionError(f"mesh {label}: {name} launched on "
                                     f"shards {sorted(per)} only")
            tot = path.setdefault(name, {})
            for s, n in per.items():
                tot[s] = tot.get(s, 0) + n
        return got

    def need(got, names, label):
        if on_card:
            for n in names:
                if n not in got:
                    raise AssertionError(f"mesh {label}: {n} never ran")

    # each entry point's calls on a path, bracketed by CUDA events on the
    # called tensors' device: the device ms of every call (one a shard on
    # a sharded path)
    call_ms: dict = {}
    shard_inputs: dict = {}
    watching = [None]

    def watch(module, attr, kernel):
        fn = getattr(module, attr)

        def timed(*a, **k):
            label = watching[0]
            t = next((x for x in a if isinstance(x, torch.Tensor)), None)
            if label is None or not on_card or t is None:
                return fn(*a, **k)
            in_shard = getattr(sharded._TLS, "device", None) is not None
            label += ", a shard" if in_shard else ", the whole state"
            keep = in_shard and (kernel, label) not in shard_inputs
            if keep:   # the path's first shard call, for its bound
                shard_inputs[(kernel, label)] = [attr, _clone_state(a[0]),
                                                 a[1:], k, None]
            stream = torch.cuda.current_stream(t.device)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
            out = fn(*a, **k)
            ev[1].record(stream)
            call_ms.setdefault((kernel, label), []).append(ev)
            if keep:
                shard_inputs[(kernel, label)][4] = _clone_state(a[0])
            return out
        setattr(module, attr, timed)
        return module, attr, fn

    from fluidframework_tpu_torch.ops import (
        axis_kernel, map_kernel, matrix_kernel, string_kernel, string_store,
        tree_kernel, tree_store,
    )
    watched = [watch(string_kernel, "apply_string_batch_fused",
                     "string_apply"),
               watch(string_store, "apply_string_batch_fused",
                     "string_apply"),
               watch(map_kernel, "map_columnar_apply_fused", "map_apply"),
               watch(map_kernel, "apply_map_batch_fused", "map_apply"),
               watch(matrix_kernel, "merge_cells_fused", "cell_merge"),
               watch(axis_kernel, "apply_axis_batch_fused", "axis_apply"),
               watch(axis_kernel, "resolve_axis_fused", "axis_resolve"),
               watch(tree_store, "apply_tree_planes_fused", "tree_apply"),
               watch(tree_kernel, "apply_tree_planes_fused", "tree_apply")]

    # ------------------------------------------- (a) config #4, sharded
    def wave(b, n):
        planes, _ = typing_storm(n, O, seed=b)
        cseq = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                         dtype=np.int32), (n, O))
        return dict(client=np.ones((n, O), np.int32), client_seq=cseq,
                    ref_seq=cseq, kind=planes["kind"], a0=planes["a0"],
                    a1=planes["a1"], text=TEXT)

    def string_engine(n, device, mesh=None):
        e = StringServingEngine(n_docs=n, capacity=S, batch_window=10 ** 9,
                                compact_every=1, sequencer="native",
                                device=device, mesh=mesh)
        docs = [f"doc-{i}" for i in range(n)]
        for d in docs:
            e.connect(d, 1)
        return e, np.array([e.doc_row(d) for d in docs], np.int32)

    waves = [wave(b, D) for b in range(MESH_WAVES + 1)]
    walls, per_wave = {}, {}
    engines = {}
    for label, mesh in [("unsharded", None)] + list(meshes.items()):
        e, rows = string_engine(D, dev, mesh)
        walls[label] = []
        for i, w in enumerate(waves):
            begin()
            watching[0] = f"config #4 wave, {label}" if i == len(waves) - 1 \
                else None
            before = sk.launches
            t0 = time.perf_counter()
            if e.ingest_planes(rows, **w)["nacked"]:
                raise AssertionError(f"mesh {label}: nacks")
            sync()
            walls[label].append(time.perf_counter() - t0)
            watching[0] = None
            n_launch = sk.launches - before
            if mesh is not None:
                got = end(f"string {label}", mesh)
                need(got, ["string_apply"], f"string {label}")
                if on_card and (n_launch != mesh.size or any(
                        v != 1 for v in got["string_apply"].values())):
                    raise AssertionError(
                        f"mesh {label}: {n_launch} string_apply launches "
                        f"in wave {i}, want one a shard ({mesh.size})")
            per_wave.setdefault(label, []).append(n_launch)
        engines[label] = e
    want = engines["unsharded"].store.digests()
    for label, e in engines.items():
        if not np.array_equal(e.store.digests(), want):
            raise AssertionError(f"mesh {label}: digests differ from the "
                                 "unsharded engine")
    summary = engines["4_on_one"].summarize()
    loads = {}
    for label, mesh in (("sharded", card), ("unsharded", None)):
        t0 = time.perf_counter()
        le = StringServingEngine.load(summary, engines["4_on_one"].log,
                                      device=dev, mesh=mesh,
                                      sequencer="native")
        loads[label] = time.perf_counter() - t0
        if not np.array_equal(le.store.digests(),
                              engines["4_on_one"].store.digests()):
            raise AssertionError(f"mesh: {label} load digests differ")
        del le
    del engines, summary
    # the CPU twin: CPU shards, the same waves at twin_d docs
    twins = [string_engine(twin_d, dev, card),
             string_engine(twin_d, "cpu", make_doc_mesh(MESH_SHARDS,
                                                        device="cpu"))]
    for b in range(MESH_WAVES + 1):
        w = wave(b, twin_d)
        for e, rows in twins:
            e.ingest_planes(rows, **w)
    if not np.array_equal(twins[0][0].store.digests(),
                          twins[1][0].store.digests()):
        raise AssertionError("mesh: card shards differ from CPU shards")
    del twins

    # ------------------------------------------- (b) the replicated step
    rep = make_mesh(devices=[dev] * 4, replicas=2)
    planes, _ = typing_storm(D, O, seed=7)
    ops = tuple(np.asarray(planes[k], np.int32) for k in mt.OP_FIELDS)
    single = mt.StringState.create(D, rep_s, device=dev)
    sk.apply_string_batch_fused(single, *(torch.from_numpy(p).to(dev)
                                          for p in ops), with_props=True)
    ref_digest = mt.string_state_digest(single).cpu().numpy()
    del single
    agree = {}
    rep_wall = {}
    for chaos in (False, True):
        state = shard_state(mt.StringState.create(D, rep_s, device="cpu"),
                            rep)
        sharded_ops = shard_ops(rep, *ops)
        begin()
        t0 = time.perf_counter()
        state, digests, ok = make_replicated_step(
            rep, inject_divergence=chaos)(state, *sharded_ops)
        agree[chaos] = int(ok)
        rep_wall[chaos] = time.perf_counter() - t0
        got = end("replicated", make_doc_mesh(devices=[dev] * 2))
        need(got, ["string_apply"], "replicated")
        if not chaos and not np.array_equal(digests.cpu().numpy(),
                                            ref_digest):
            raise AssertionError("replicated step: digests differ from "
                                 "one B1 apply")
        del state, sharded_ops
    if agree != {False: 1, True: 0}:
        raise AssertionError(f"replicated step: agree {agree}")

    # -------------------------------- (c) map, tree, matrix, sharded
    def pair(make):
        return make(None), make(card)

    # map: config #2's serving batches
    mdocs = [f"map-{i}" for i in range(map_d)]

    def map_engine(mesh):
        e = MapServingEngine(n_docs=map_d, n_keys=MAP_K,
                             batch_window=10 ** 9, sequencer="native",
                             device=dev, mesh=mesh)
        for d in mdocs:
            e.connect(d, 1)
        return e, np.array([e.doc_row(d) for d in mdocs], np.int32)
    maps = pair(map_engine)
    begin()
    watching[0] = "engines"
    for b in range(3):
        kind, kidx, keys, vidx, values = map_serving_batch(map_d, MAP_O, b,
                                                           n_keys=MAP_K)
        cs = np.broadcast_to(np.arange(b * MAP_O + 1, (b + 1) * MAP_O + 1,
                                       dtype=np.int32), (map_d, MAP_O))
        for e, rows in maps:
            if e.ingest_planes(rows, np.ones((map_d, MAP_O), np.int32), cs,
                               np.zeros((map_d, MAP_O), np.int32), kind,
                               kidx, keys, values, vidx)["nacked"]:
                raise AssertionError("mesh map: nacks")
    for i, d in enumerate(mdocs[:16]):   # the per-op route: dense planes
        for e, _ in maps:
            if e.submit(d, 1, 3 * MAP_O + 1, 0, {
                    "op": "set", "key": keys[i % len(keys)],
                    "value": i})[1] is not None:
                raise AssertionError("mesh map: per-op nack")
            e.flush()
    need(end("map", card), ["map_apply"], "map")
    if not np.array_equal(maps[0][0].store.digests(),
                          maps[1][0].store.digests()):
        raise AssertionError("mesh map: sharded digests differ")
    del maps

    # tree: profile_tree.py's waves (the sharded store takes the dense
    # records; the unsharded one the compact wire)
    tdocs = [f"tree-{i}" for i in range(tree_d)]

    def tree_engine(mesh):
        e = TreeServingEngine(n_docs=tree_d, capacity=TREE_N,
                              batch_window=10 ** 9, sequencer="native",
                              device=dev, mesh=mesh)
        for d in tdocs:
            e.connect(d, 1)
            e.doc_row(d)
        return e
    trees = pair(tree_engine)
    begin()
    for w in range(MESH_TREE_WAVES):
        ids, tops = profile_tree_waves(tdocs, w)
        for e in trees:
            if e.ingest_batch(ids, [1] * tree_d, [w + 1] * tree_d,
                              [0] * tree_d, tops)["nacked"]:
                raise AssertionError("mesh tree: nacks")
    need(end("tree", card), ["tree_apply"], "tree")
    if not np.array_equal(trees[0].store.digests(),
                          trees[1].store.digests()):
        raise AssertionError("mesh tree: sharded digests differ")
    for d in tdocs[::max(1, tree_d // 8)]:
        if trees[0].to_dict(d) != trees[1].to_dict(d):
            raise AssertionError(f"mesh tree: {d} differs")
    del trees

    # matrix: config #3's serving shape (64 docs of 32 × 32)
    xdocs = [f"mx-{i}" for i in range(mx_docs)]
    G = MX_DOC_GRID

    def mx_engine(mesh):
        e = MatrixServingEngine(n_docs=mx_docs, cell_capacity=MX_CELL_CAP_A,
                                axis_capacity=MX_AXIS_CAP_A,
                                batch_window=10 ** 9, sequencer="native",
                                device=dev, mesh=mesh)
        for d in xdocs:
            e.connect(d, 1)
        return e
    mxs = pair(mx_engine)
    begin()
    for e in mxs:
        for d in xdocs:
            for cs, op in ((1, {"mx": "insRow", "pos": 0, "count": G,
                                "opKey": [1, 0]}),
                           (2, {"mx": "insCol", "pos": 0, "count": G,
                                "opKey": [2, 0]})):
                if e.submit(d, 1, cs, 0, op)[1] is not None:
                    raise AssertionError("mesh matrix: nack")
        e.flush()
    rng = np.random.default_rng(11)
    per_doc = 4096 // mx_docs
    for storm in range(MESH_MX_STORMS):
        r = rng.integers(0, G, size=(mx_docs, per_doc))
        c = rng.integers(0, G, size=(mx_docs, per_doc))
        batch = ([d for d in xdocs for _ in range(per_doc)],
                 [1] * (mx_docs * per_doc),
                 [3 + storm * per_doc + k for _ in xdocs
                  for k in range(per_doc)],
                 [0] * (mx_docs * per_doc), r.reshape(-1).tolist(),
                 c.reshape(-1).tolist(),
                 [int(v) for v in rng.integers(0, 1 << 20,
                                               size=mx_docs * per_doc)])
        for e in mxs:
            if e.ingest_cells(*batch)["nacked"]:
                raise AssertionError("mesh matrix: nacks")
    for e in mxs:
        e.flush()
    need(end("matrix", card), ["cell_merge", "axis_apply", "axis_resolve"],
         "matrix")
    for d in xdocs[::8]:
        if mxs[0].to_lists(d) != mxs[1].to_lists(d):
            raise AssertionError(f"mesh matrix: {d} differs")
    if mxs[0].store.digest() != mxs[1].store.digest():
        raise AssertionError("mesh matrix: cell digests differ")
    del mxs

    watching[0] = None
    for module, attr, fn in watched:
        setattr(module, attr, fn)
    sync()
    per_call = {}
    for (kernel, label), evs in call_ms.items():
        ms = [a.elapsed_time(b) for a, b in evs]
        row = per_call.setdefault(kernel, {})[label] = {
            "calls": len(ms), "mean_ms": sum(ms) / len(ms), "max_ms": max(ms)}
        if (kernel, label) in shard_inputs:
            b_ms, b_by, nbytes = shard_bound(
                kernel, *shard_inputs.pop((kernel, label)))
            row.update(first_call_bound_ms=b_ms, bound_by=b_by,
                       bytes=nbytes, x_bound=row["mean_ms"] / b_ms)
    del shard_inputs

    # ---------------------------------------- (d) the collective-free check
    cf = sharded.assert_collective_free(card, D, S, O)
    emit({"phase": "mesh", "docs": D, "capacity": S, "ops_per_doc": O,
          "meshes": {k: [str(x) for x in m.devices.tolist()]
                     for k, m in meshes.items()},
          "wave_wall_s": walls,
          "string_apply_launches_per_wave": per_wave,
          "load_s": loads, "twin_docs": twin_d,
          "replicated": {"replicas": 2, "doc_shards": 2, "capacity": rep_s,
                         "agree": int(agree[False]),
                         "agree_with_divergence": int(agree[True]),
                         "step_wall_s": rep_wall[False]},
          "launches_per_shard": launches, "call_ms": per_call,
          "collective_free": cf,
          "total_s": time.perf_counter() - t_phase, "card": smi})
    return launches


def _clone_state(st):
    """A copy of a kernel's state dataclass (every tensor cloned); a
    tensor argument is cloned as is."""
    if hasattr(st, "fields"):
        return type(st)(**{k: v.clone() for k, v in st.fields().items()})
    return st.clone()


def shard_bound(kernel, entry, before, args, kwargs, after):
    """The least time for one kernel call, counted as the kernel's own
    phase counts it (``string_bound`` ... ``tree_apply_bound``), on the
    state before and after the call and its arguments. Returns (ms,
    bound_by, bytes)."""
    if kernel == "string_apply":
        ops, ms = args[:7], kwargs.get("min_seq")
        d, S = before.seq.shape
        work = [(int((ops[0] != NOOP).sum()),
                 float(before.count.float().mean()))]
        return string_bound(S, kwargs.get("with_props", False),
                            ms is not None, work, d=d, o=ops[0].shape[1])
    if kernel == "map_apply":
        from fluidframework_tpu_torch.ops import map_kernel as mk
        n_docs, n_keys = before.present.shape
        if entry == "map_columnar_apply_fused":
            buf, R, O_, wide = args[:4]
            kind, a0 = mk.map_unpack(buf, R, O_, n_docs, True, wide)[:2]
            op_bytes = buf.numel() * 4
        else:
            kind, a0 = args[:2]
            op_bytes = 4 * kind.numel() * 4
        b = map_bound(kind, a0, op_bytes, n_keys)
        return b["bound_ms"], b["bound_by"], b["bytes"]
    if kernel == "cell_merge":
        return cell_bound(int(before.count), int(after.count),
                          args[0].numel())
    if kernel == "axis_apply":
        return axis_apply_bound(before, args, after)[:3]
    if kernel == "axis_resolve":
        return axis_resolve_bound(before, *args[:4])[:3]
    (b_ms, b_by), nbytes, _, _ = tree_apply_bound(
        before, args[0], len(args) > 1 and args[1] is not None)
    return b_ms, b_by, nbytes


DURABLE_ROUNDS = 2          # (a): fresh engines and log a round
DURABLE_TIMED = 5           # (a): timed batches a round after a warm-up
DURABLE_SUMMARY_AFTER = 2   # (b): the child summarizes after this batch
DURABLE_KILL_BATCH = 4      # (b): the child is killed in this batch
DURABLE_SUBSET = 512        # (b): the CPU twin's docs; (c): the spill's docs
DURABLE_SPILL_WAVES = 3     # (c): waves on the JSONL spill


def filesystem_of(path):
    """(mount point, type) of the filesystem that holds ``path``."""
    path = os.path.realpath(path)
    best = ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            mnt, typ = line.split()[1:3]
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[0]):
                best = (mnt, typ)
    return best


def durable_phase(smi, dev, D=D, O=O, S=S_SERVE):
    """Phase 13: config #4 on the durable op log (``server/oplog.py``,
    ``server/native_oplog.py`` + ``native/oplog.cpp``). (a) Durable
    serving: ``DURABLE_ROUNDS`` rounds, each a fresh pair of engines (one
    on ``NativePartitionedLog(tmpdir, 8)`` with ``sync()`` after every
    batch, one on the in-memory log), a warm-up batch and
    ``DURABLE_TIMED`` timed batches fed to both in turns; ops/s of each,
    their ratio, the bytes and the sync of every batch. (b) Kill and
    recover: a child process (``testing/durable_drill.py``) serves the
    same config on the card, summarizes after batch
    ``DURABLE_SUMMARY_AFTER`` and is SIGKILLed inside the log append of
    batch ``DURABLE_KILL_BATCH``, as soon as its partition file grows
    (the frame is left torn, or whole if the write won the race); the
    directory is reopened (a torn frame is cut) and the summary
    loaded on the card (the tail replays through string_apply); every
    doc's payload-ranked digest, text of a sample and doc seq equal an
    engine on the card that applied exactly the batches on disk (every
    acked one, the killed one only whole), and ``DURABLE_SUBSET`` docs
    equal a ``device="cpu"`` twin. (c) The JSONL spill at
    ``DURABLE_SUBSET`` docs: recovery verifies the chain, the load on the
    card equals the live engine, one flipped bit is refused at the record
    that holds it, and the summary anchor refuses a truncation at a record
    boundary. Returns {path: string_apply launches}."""
    from fluidframework_tpu_torch.ops import cuda_build
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.server.native_oplog import (
        NativePartitionedLog, encode_columnar,
    )
    from fluidframework_tpu_torch.server.oplog import (
        OplogCorruptionError, PartitionedLog, chain_step,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    from fluidframework_tpu_torch.testing import durable_drill as dd
    from fluidframework_tpu_torch.utils.faultpoints import corrupt_bitflip
    import numpy as np
    import random
    import torch

    def settle():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    dev = torch.device(dev)
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="durable-")
    mount, fstype = filesystem_of(root)
    docs = dd.doc_ids(D)
    waves = [dd.config4_wave(D, O, b) for b in range(DURABLE_TIMED + 1)]
    launches = {"durable_serving": 0, "memory_serving": 0,
                "kill_replay": 0, "spill_replay": 0}

    def disk_bytes(d):
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))

    # (a) durable serving beside the in-memory log, batch by batch
    walls = {"durable": [], "memory": []}
    sync_s, batch_bytes = [], []
    for r in range(DURABLE_ROUNDS):
        ddir = os.path.join(root, f"a{r}")
        dlog = NativePartitionedLog(ddir, dd.N_PARTITIONS)
        engines = {"durable": dd.make_engine(docs, S, dlog, dev),
                   "memory": dd.make_engine(docs, S, PartitionedLog(
                       dd.N_PARTITIONS), dev)}
        dlog.sync()
        for b, w in enumerate(waves):
            order = ("durable", "memory") if b % 2 else ("memory", "durable")
            for name in order:
                eng, rows = engines[name]
                before = disk_bytes(ddir)
                sk.launches = 0
                t0 = time.perf_counter()
                res = eng.ingest_planes(rows, **w)
                if name == "durable":
                    t1 = time.perf_counter()
                    dlog.sync()   # group commit: the ack is durable
                    t_sync = time.perf_counter() - t1
                settle()
                wall = time.perf_counter() - t0
                launches[f"{name}_serving"] += sk.launches
                if res["nacked"]:
                    raise AssertionError(f"durable phase (a): {name} batch "
                                         f"{b} nacked {res['nacked']}")
                if b == 0:
                    continue   # the warm-up
                walls[name].append(wall)
                if name == "durable":
                    sync_s.append(t_sync)
                    batch_bytes.append(disk_bytes(ddir) - before)
        for name, (eng, rows) in engines.items():
            if eng.overflowed_docs():
                raise AssertionError(f"durable phase (a): {name} overflowed")
        digests = [dd.ranked_digests(e, rows_)
                   for e, rows_ in engines.values()]
        if not np.array_equal(*digests):
            raise AssertionError("durable phase (a): the durable engine "
                                 "differs from the in-memory one")
        mem = engines["memory"][0]
        last_rec = mem.log.read((mem._col_part - 1) % dd.N_PARTITIONS)[-1]
        dlog.close()
        del engines, mem
        torch.cuda.empty_cache()
    on_card = dev.type == "cuda"   # the plain version launches nothing
    if on_card and not (launches["durable_serving"]
                        and launches["memory_serving"]):
        raise AssertionError("durable phase (a): string_apply never ran")
    n_timed = D * O * len(walls["durable"])
    ops_s = {k: n_timed / sum(v) for k, v in walls.items()}
    # one batch's append split by part, on the last batch's record: the
    # width-coded encode, the chain word, the whole append (encode, chain
    # word, the C side's frame CRC and write) and the fsync
    split = {"encode_s": [], "chain_word_s": [], "append_s": [],
             "sync_s": []}
    for i in range(3):
        t0 = time.perf_counter()
        data = encode_columnar(last_rec)
        t1 = time.perf_counter()
        chain_step(b"D" + data, 0)
        t2 = time.perf_counter()
        scratch = NativePartitionedLog(os.path.join(root, f"s{i}"), 1)
        t3 = time.perf_counter()
        scratch.append(0, last_rec)
        t4 = time.perf_counter()
        scratch.sync()
        t5 = time.perf_counter()
        scratch.close()
        for k, v in zip(split, (t1 - t0, t2 - t1, t4 - t3, t5 - t4)):
            split[k].append(v)
    del last_rec
    a_s = time.perf_counter() - t_phase

    # (b) a child serves on the card, is killed inside a batch's log
    # append, is recovered
    t0 = time.perf_counter()
    bdir = os.path.join(root, "b")
    ev = dd.kill_drill(bdir, D, S, O, DURABLE_SUMMARY_AFTER,
                       DURABLE_KILL_BATCH, device=str(dev),
                       kernel_libs=cuda_build.libraries())
    child_s = time.perf_counter() - t0
    if not ev["killed_mid_batch"] or ev["rc"] != -9 or \
            ev["last_acked"] < DURABLE_SUMMARY_AFTER + 1:
        raise AssertionError(f"durable phase (b): the kill missed: {ev}")
    sk.launches = 0
    t0 = time.perf_counter()
    rec, rlog, truncated = dd.recover(bdir, ev["summary"], device=dev)
    settle()
    replay_s = time.perf_counter() - t0
    launches["kill_replay"] = sk.launches
    if on_card and not launches["kill_replay"]:
        raise AssertionError("durable phase (b): the replay never launched "
                             "string_apply")
    on_disk = dd.batches_on_disk(rlog, D)
    if on_disk not in (ev["last_acked"] + 1, ev["last_acked"] + 2):
        raise AssertionError(f"durable phase (b): {on_disk} batches on "
                             f"disk after acking 0..{ev['last_acked']}")
    # the kill landed inside the killed batch's append: its frame was
    # left torn (and the reopen cut it) or was already whole
    if not (truncated > 0 or on_disk == ev["last_acked"] + 2):
        raise AssertionError(f"durable phase (b): the kill left neither a "
                             f"torn nor a whole frame: {ev['kill']}")
    ref, rows = dd.make_engine(docs, S, PartitionedLog(dd.N_PARTITIONS), dev)
    if rec._doc_rows != ref._doc_rows:
        raise AssertionError("durable phase (b): doc rows differ")
    for b in range(on_disk):
        ref.ingest_planes(rows, **dd.config4_wave(D, O, b))
    if not np.array_equal(dd.ranked_digests(rec, rows),
                          dd.ranked_digests(ref, rows)):
        raise AssertionError("durable phase (b): recovered digests differ "
                             "from the acked batches'")
    if any(rec.deli.doc_seq(d) != ref.deli.doc_seq(d) for d in docs):
        raise AssertionError("durable phase (b): doc seqs differ")
    sample = list(range(0, D, max(1, D // 64)))
    if any(rec.read_text(docs[i]) != ref.read_text(docs[i])
           for i in sample):
        raise AssertionError("durable phase (b): texts differ")
    sub = list(range(0, D, max(1, D // DURABLE_SUBSET)))[:DURABLE_SUBSET]
    twin, trows = dd.make_engine([docs[i] for i in sub], S,
                                 PartitionedLog(dd.N_PARTITIONS), "cpu")
    for b in range(on_disk):
        twin.ingest_planes(trows, **dd.subset_wave(
            dd.config4_wave(D, O, b), sub))
    if not np.array_equal(dd.ranked_digests(rec, rows[sub]),
                          dd.ranked_digests(twin, trows)) or any(
            rec.read_text(docs[i]) != twin.read_text(docs[i])
            for i in sub[::8]):
        raise AssertionError("durable phase (b): the recovered subset "
                             "differs from the CPU twin")
    rlog.close()
    del rec, ref, twin
    torch.cuda.empty_cache()

    # (c) the JSONL spill at a small size: chain, bit flip, boundary cut
    t0 = time.perf_counter()
    cdir = os.path.join(root, "c")
    n = DURABLE_SUBSET
    cdocs = dd.doc_ids(n)
    clog = PartitionedLog(dd.N_PARTITIONS, cdir, "c")
    live, crows = dd.make_engine(cdocs, S, clog, dev)
    summary = None
    for b in range(DURABLE_SPILL_WAVES):
        live.ingest_planes(crows, **dd.config4_wave(n, O, b))
        if b == 0:
            summary = live.summarize()
    heads = [clog.chain_head(p) for p in range(dd.N_PARTITIONS)]
    clog.close()
    for tag in ("flip", "cut"):
        shutil.copytree(cdir, os.path.join(root, f"c-{tag}"))
    back = PartitionedLog.recover(dd.N_PARTITIONS, cdir, "c")
    if [back.chain_head(p) for p in range(dd.N_PARTITIONS)] != heads:
        raise AssertionError("durable phase (c): chain heads differ")
    sk.launches = 0
    loaded = StringServingEngine.load(summary, back, device=dev,
                                      sequencer="native")
    launches["spill_replay"] = sk.launches
    if (on_card and not launches["spill_replay"]) or not np.array_equal(
            dd.ranked_digests(loaded, crows), dd.ranked_digests(live, crows)):
        raise AssertionError("durable phase (c): the spill's load differs")
    sizes = [back.size(p) for p in range(dd.N_PARTITIONS)]
    back.close()
    big = int(np.argmax(sizes))
    path = os.path.join(root, "c-flip", f"c-p{big}.jsonl")
    flip = corrupt_bitflip(path, random.Random(16))
    with open(path, "rb") as f:
        want_index = f.read()[:flip["offset"]].count(b"\n")
    try:
        PartitionedLog.recover(dd.N_PARTITIONS, os.path.dirname(path), "c")
        raise AssertionError("durable phase (c): a flipped bit recovered")
    except OplogCorruptionError as e:
        flip_refused = {"index": e.index, "reason": e.reason}
    if flip_refused["index"] != want_index:
        raise AssertionError(f"durable phase (c): bit flip at record "
                             f"{want_index} refused at {flip_refused}")
    cut_p = int(np.argmax(summary["log_offsets"]))
    path = os.path.join(root, "c-cut", f"c-p{cut_p}.jsonl")
    with open(path, "rb") as f:
        lines = f.read().splitlines(True)
    with open(path, "wb") as f:
        f.write(b"".join(lines[:summary["log_offsets"][cut_p] - 1]))
    cut = PartitionedLog.recover(dd.N_PARTITIONS, os.path.dirname(path), "c")
    try:
        StringServingEngine.load(summary, cut, device=dev,
                                 sequencer="native")
        raise AssertionError("durable phase (c): a truncated log loaded")
    except OplogCorruptionError as e:
        cut_refused = {"index": e.index, "reason": e.reason}
    if cut_refused["reason"] != "log shorter than summary anchor":
        raise AssertionError(f"durable phase (c): {cut_refused}")
    cut.close()
    c_s = time.perf_counter() - t0
    del live, loaded
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    emit({"phase": "durable", "docs": D, "capacity": S, "ops_per_batch": D * O,
          "tmpdir_filesystem": {"mount": mount, "type": fstype},
          "fsync_is_durable": fstype not in ("tmpfs", "ramfs"),
          "timed_batches": len(walls["durable"]),
          "durable_ops_per_s": ops_s["durable"],
          "memory_ops_per_s": ops_s["memory"],
          "durable_over_memory": ops_s["durable"] / ops_s["memory"],
          "batch_wall_s": walls, "sync_s": sync_s,
          "bytes_per_batch": batch_bytes, "append_split": split,
          "kill": {**ev, "batches_on_disk": on_disk,
                   "torn_bytes_truncated": truncated,
                   "replay_s": replay_s, "child_s": child_s,
                   "replay_launches": launches["kill_replay"],
                   "twin_docs": len(sub)},
          "spill": {"docs": n, "waves": DURABLE_SPILL_WAVES,
                    "records": sizes, "replay_launches":
                    launches["spill_replay"], "bit_flip": flip,
                    "bit_flip_refused": flip_refused,
                    "boundary_cut_refused": cut_refused, "s": c_s},
          "a_s": a_s, "total_s": time.perf_counter() - t_phase,
          "card": smi})
    return launches


DOOR_CLIENTS = 10           # 9 ``B`` clients and one ``R`` client
DOOR_WAVES = 24             # benches/columnar_ingress_storm.py's waves
DOOR_ADM_WAVES = 4          # the admission run's waves
# the admission run's tenant budget, ops/s: well under the storm's rate
# on the card (32,600-44,100 ops/s), so every run sheds ops (at 50,000,
# one run shed none)
DOOR_ADM_RATE = 20_000.0
DOOR_ADM_BURST = 2_000.0


def door_window_work(count_before, count_after, kind, op_bytes, props,
                     compact):
    """The work B1 must do on one door window, for its bound: the op
    planes (``op_bytes``) read once; for each row that carries a real op
    (``kind`` != NOOP), the live extent of its 7 (+K) slot planes read
    before (``count_before``) and written after (``count_after``), its
    count and overflow read and written, and its compaction floor read
    when the launch compacts. A row with no op is left as it was; a
    compaction that would move such a row's slots is not charged, so
    the count errs low. Operations: one pass over the row's live slots
    an op. Returns (bytes, int32 operations)."""
    k = K if props else 0
    real = kind != NOOP
    active = real.any(dim=1)
    c0 = count_before.long()[active]
    c1 = count_after.long()[active]
    n_active = int(active.sum())
    nbytes = (op_bytes + (7 + k) * 4 * int((c0 + c1).sum())
              + 4 * 4 * n_active + (4 * n_active if compact else 0))
    n_ops = int((real.sum(dim=1)[active].long() * (c0 + 1)).sum())
    return nbytes, n_ops


def door_phase(smi, dev, D=D, S=S_SERVE, n_clients=DOOR_CLIENTS,
               waves=DOOR_WAVES, window_rows=None, adm_waves=DOOR_ADM_WAVES,
               adm_rate=DOOR_ADM_RATE, adm_burst=DOOR_ADM_BURST):
    """Phase 14: config #4's docs served from real TCP clients through
    the columnar front door (``server/columnar_ingress.py``, the native
    frame decode ``native/ingress.cpp``), B1 applying every window. (a)
    ``n_clients`` clients of D / n_clients docs each (one ``R`` client of
    inserts, removes and annotates, the rest ``B`` clients of one insert
    of ``"w{k}"`` at 0 a doc a wave) send ``waves`` waves to a door of
    ``window_rows``-row windows at 2 ms, pipeline depth 3, the native
    sequencer, ``decode="native"``: every op acked once with seq > 0, each
    ``B`` doc's text ``"w{waves-1}…w0"``, each ``R`` doc's its client's
    shadow, B1 launched at least once a window, and the door engine's
    planes, payload table and digests equal to a second engine on
    ``dev`` fed the door's windows directly through ``ingest_planes``;
    the first launch of each B1 specialisation the door made is held
    against the plain version on its input; the bound is that of the
    mean work of the specialisation's launches (``door_window_work``). ``window_rows`` None is the storm bench's
    4,096 (``testing/door_storm.py``). (b) ``adm_waves`` waves of
    the same clients through a door with an ``AdmissionController``
    whose tenant budget sheds ops; the clients resubmit the throttled
    cseqs after the hint and every op is acked exactly once. Returns
    {"launches", "max_abs_err", "rows": B1 rows of the door's launch
    shapes}."""
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.ops import string_store
    from fluidframework_tpu_torch.server.admission import (
        AdmissionController,
    )
    from fluidframework_tpu_torch.server.opsd import (
        latency_breakdown, publish_hotdoc_gauges,
    )
    from fluidframework_tpu_torch.testing import door_storm as ds
    from fluidframework_tpu_torch.testing import kernel_timing
    from fluidframework_tpu_torch.utils import capacity, tracing
    from fluidframework_tpu_torch.utils.telemetry import MetricsRegistry
    import torch

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    per = D // n_clients

    if window_rows is None:
        window_rows = ds.WINDOW_ROWS
    clone = _clone_state

    # every B1 launch the door makes: CUDA events around it, and the
    # first input of each specialisation kept for the plain version
    fused = string_store.apply_string_batch_fused
    events, kept, launched = [], {}, []

    def watched(state, *ops, min_seq=None, with_props=False):
        key = (with_props, min_seq is not None)
        if key not in kept:
            kept[key] = (clone(state), ops, min_seq)
        c0 = state.count.clone()
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        out = fused(state, *ops, min_seq=min_seq, with_props=with_props)
        if on_card:
            b.record()
            events.append((a, b, key, ops[0].shape[1]))
        # each launch's work, read after the phase: counts and kinds
        launched.append((key, c0, out.count.clone(), ops[0].clone(),
                         sum(t.numel() * t.element_size() for t in ops)))
        return out

    # (a) the storm
    eng = ds.storm_engine(D, dev, capacity=S)
    seen = ds.record_windows(eng)
    capacity.LEDGER.register_store("door engine", eng.store)
    door = ds.open_door(eng, window_rows)
    string_store.apply_string_batch_fused = watched
    try:
        sk.launches = 0      # the door's path starts here
        clients, wall = ds.storm(door, n_clients, waves)
        pipe = door.pipeline_stats()
    finally:
        door.stop()
        string_store.apply_string_batch_fused = fused
    launches = sk.launches   # and ends here (every window has logged)
    if on_card:
        torch.cuda.synchronize()
    n_ops = n_clients * per * waves
    windows = door.windows_flushed
    if windows != len(seen) or door.ops_ingested != n_ops:
        raise AssertionError(f"door phase: {windows} windows, "
                             f"{len(seen)} recorded, "
                             f"{door.ops_ingested} ops")
    if on_card and launches < windows:
        raise AssertionError(f"door phase: {launches} B1 launches for "
                             f"{windows} windows")
    drain = door.drain_stats()
    if drain["tier"] != "native":
        raise AssertionError(f"door phase: decode tier {drain['tier']}")
    device_ms = sum(a.elapsed_time(b) for a, b, *_ in events)
    lat = latency_breakdown(door.metrics)
    # the slowest sampled window's trace: its rx → ack span in the ring
    worst = door.metrics.histograms["stage_e2e_ack_ms"].worst_exemplar
    spans = [] if worst is None else tracing.TRACER.events(worst[1])
    hot = MetricsRegistry()
    publish_hotdoc_gauges([door.hotdocs], registry=hot)
    census = capacity.LEDGER.census(top_k=4)

    # the door's engine against one fed its windows directly
    t0 = time.perf_counter()
    direct = ds.storm_engine(D, dev, capacity=S)
    ds.seat_like(direct, eng)
    nacked = ds.replay(direct, seen)
    diff = ds.state_diff(eng, direct)
    if nacked or diff:
        raise AssertionError(f"door phase: the direct engine nacked "
                             f"{nacked}, differs in {diff}")
    direct_s = time.perf_counter() - t0
    del direct, seen

    # each B1 specialisation the door launched, on its first input,
    # against the plain version
    max_err, rows = 0, []
    for (props, compact), (st0, ops, ms) in sorted(kept.items()):
        work = clone(st0)
        sk.apply_string_batch_fused(work, *ops, min_seq=ms,
                                    with_props=props)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = mt.apply_string_batch(st0, *ops, with_props=props)
        if compact:
            ref = mt.compact_string_state(ref, ms, props)
        if on_card:
            torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = kernel_timing.max_abs_err(mt, work, ref, props, compact)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"door phase: kernel != plain (props="
                                 f"{props}, compact={compact}): {err}")
        d_, o_ = ops[0].shape
        mine = [x[1:] for x in launched if x[0] == (props, compact)]
        spec = [door_window_work(*x, props, compact) for x in mine]
        nbytes = sum(b for b, _ in spec) / len(spec)
        b_ms, b_by = work_bound(nbytes, sum(n for _, n in spec) / len(spec))
        real_ops = sum(int((x[2] != NOOP).sum()) for x in mine) / len(mine)
        spec_ms = [a.elapsed_time(b) for a, b, k, _ in events
                   if k == (props, compact)]
        # CUDA events around each eager call on the executor's thread:
        # call ms, not the CUDA-graph kernel time of the other rows' ms
        rows.append({"spec": ("props" if props else "no-props")
                     + ("+compact" if compact else ""),
                     "D": d_, "S": S, "O": o_, "state": "door window",
                     "ms": None,
                     "call_ms": (sum(spec_ms) / len(spec_ms) if spec_ms
                                 else None),
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "library_ms": None,
                     "real_ops_mean": real_ops, "max_abs_err": err,
                     "launches": len(spec_ms)})
    del kept, launched

    emit({"phase": "door", "docs": D, "capacity": S, "clients": n_clients,
          "docs_a_client": per, "waves": waves, "ops": n_ops,
          "ops_per_s": n_ops / wall, "wall_s": wall, "windows": windows,
          "ops_per_window": n_ops / windows,
          "window_rows": window_rows, "pipeline_depth": ds.DEPTH,
          "drain": drain, "pipeline": pipe,
          "stages": {k: {"p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"],
                         "mean_ms": v["mean_ms"]}
                     for k, v in lat["stages"].items()},
          "stage_e2e_ack_p99_ms": lat["e2e_p99_ms"],
          "stage_e2e_ack_mean_ms": lat["e2e_mean_ms"],
          "e2e_worst_exemplar": worst,
          "worst_trace_spans": [{"name": e["name"], "dur_us": e["dur"]}
                                for e in spans],
          "b1_launches": launches, "b1_device_ms": device_ms,
          "b1_op_widths": sorted({o for *_, o in events}),
          "direct_engine_equal": True, "direct_replay_s": direct_s,
          "hotdoc_gauges": hot.gauges,
          "census": {"device": census["device"],
                     "docs": census["docs"]["resident"],
                     "idle": census["idle"],
                     "coldest": census["coldest"],
                     "census_ms": census["census_ms"]},
          "card": smi})
    del door, eng, clients
    if on_card:
        torch.cuda.empty_cache()

    # (b) admission: a tenant budget sheds ops, clients resubmit
    adm = AdmissionController()
    adm.register_tenant("storm", adm_rate, burst=adm_burst)
    eng = ds.storm_engine(D, dev, capacity=S)
    door = ds.open_door(eng, window_rows, admission=adm)
    try:
        sk.launches = 0
        clients, adm_wall = ds.storm(door, n_clients, adm_waves,
                                     tenant="storm", seed=1)
    finally:
        door.stop()
    adm_launches = sk.launches
    throttled = sum(c.throttled for c in clients)
    if not throttled or throttled != door.throttled_ops:
        raise AssertionError(f"door phase (b): {throttled} throttled by "
                             f"the clients, {door.throttled_ops} by the door")
    if on_card and adm_launches < door.windows_flushed:
        raise AssertionError("door phase (b): a window without B1")
    snap = adm.snapshot()
    emit({"phase": "door_admission", "waves": adm_waves,
          "ops": n_clients * per * adm_waves,
          "tenant_rate": adm_rate, "burst": adm_burst,
          "throttled_ops": throttled, "admitted": snap["admitted_total"],
          "shed": snap["shed_total"], "windows": door.windows_flushed,
          "wall_s": adm_wall, "b1_launches": adm_launches,
          "total_s": time.perf_counter() - t_phase, "card": smi})
    del door, eng
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": launches + adm_launches, "storm_launches": launches,
            "admission_launches": adm_launches, "max_abs_err": max_err,
            "rows": rows}


RP_TAIL = 2                 # waves after the second generation: the tail
RP_OBSERVERS = 3            # ResilientObservers over TCP
RP_TEARS = (3, 15)          # waves in which every observer's socket dies
                            # inside a window run
RP_KILLS = (9,)             # waves before which every idle socket dies
RP_SINKS = 64               # in-process no-op subscribers
RP_TRIALS = 3               # catch-up timing trials (median)
RP_REPS = 3                 # encode / publish passes over the windows
RP_WAIT_S = 300.0           # seconds an observer may take to catch up
RP_RING = 4096              # windows the hub keeps (more than a storm makes)


def _frames(payload):
    """(type, payload) of each frame of a window run."""
    import struct
    out, off = [], 0
    while off < len(payload):
        ftype, n = struct.unpack_from("<BI", payload, off)
        out.append((ftype, payload[off + 5:off + 5 + n]))
        off += 5 + n + 4
    return out


def readplane_phase(smi, dev, D=D, S=S_SERVE, n_clients=DOOR_CLIENTS,
                    waves=DOOR_WAVES, tail=RP_TAIL, tears=RP_TEARS,
                    kills=RP_KILLS,
                    n_observers=RP_OBSERVERS, n_sinks=RP_SINKS,
                    window_rows=None, trials=RP_TRIALS):
    """Phase 15: the read plane behind config #4's columnar door. The
    door storm of the door phase (``n_clients`` TCP clients of D /
    n_clients docs, windows of 4,096 rows at 2 ms, depth 3, the native
    sequencer and decode), ``waves`` + ``tail`` waves, with a
    ``ReadPlane`` on the door's engine (one window encoded a log append,
    on the executor's log thread) and an ``ObserverHub`` (a ring of every
    window) behind an ``ObserverDoor``. Readers: ``n_observers``
    ``ResilientObserver``s over TCP, every socket lost inside a window
    run of each wave of ``tears`` (``tear_window``: right after a frame
    with more of the run to come) and killed before each wave of
    ``kills`` once the observer has applied everything published;
    ``n_sinks`` in-process sinks; a ``ReadReplica`` on ``dev`` anchored on
    a summary taken after the joins and polled before every wave; a
    ``SummaryGenerationStore`` in a temporary directory holding a
    generation after wave ``waves // 2`` and one after wave ``waves``.
    Checks: every observer applied every acked op once (no gap, no
    duplicate, its doc seqs the sequencer's, one torn window a wave of
    ``tears`` and a reconnect after each tear or kill);
    every sink got the same bytes object a window; no string window fell
    back to a JSON ``rec`` frame; the replica equals the leader after a
    last poll (``door_storm.state_diff``, payload handles ranked by
    text); the generation diff on ``dev`` plus the tail reads as a full
    load of the second generation and as the live engine; the catch-up
    rung answers ``diff_ok``; B1 launched in the replica's flushes and in
    the catch-up's tail replay, the first launch of each held against the
    plain version. Timed: the encode of a window and the hub's publish at
    1 and ``n_sinks`` subscribers (host clock, ``RP_REPS`` passes; best
    of 3), the hub's delivery p99 and the replica's drain-lag p99 (one
    tracker each), the replica's polls, the diff catch-up against
    a full replay from the first generation (host clock after a sync,
    ``trials`` trials, median). Returns {"launches", "storm_launches",
    "replica_launches", "catchup_launches", "max_abs_err"}."""
    import random
    import socket
    import statistics

    from fluidframework_tpu_torch.drivers.resilient import ResilientObserver
    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.ops import string_store
    from fluidframework_tpu_torch.runtime.summarizer import (
        SummaryGenerationStore,
    )
    from fluidframework_tpu_torch.server import read_plane as rp
    from fluidframework_tpu_torch.server.columnar_ingress import (
        encode_json, read_frame,
    )
    from fluidframework_tpu_torch.server.observer import (
        ObserverDoor, ObserverHub,
    )
    from fluidframework_tpu_torch.testing import door_storm as ds
    from fluidframework_tpu_torch.testing import kernel_timing
    from fluidframework_tpu_torch.testing.chaos import digest, engine_class
    import torch

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    per = D // n_clients
    n_waves = waves + tail
    gen_waves = (waves // 2, waves)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # B1 launches by path: the replica's (its store's state), the rest of
    # the storm's (the door's windows), the catch-up's; the first input of
    # the replica's and of the catch-up's kept for the plain version
    fused = string_store.apply_string_batch_fused
    mode = {"path": "storm"}
    counts = {"door": 0, "replica": 0, "catchup": 0, "full_load": 0}
    kept = {}
    rep = None

    def watched(state, *ops, min_seq=None, with_props=False):
        path = mode["path"]
        if path == "storm" and rep is not None and \
                state is rep.engine.store._state:
            path = "replica"
        elif path == "storm":
            path = "door"
        counts[path] += 1
        if path in ("replica", "catchup") and path not in kept:
            kept[path] = (_clone_state(state), tuple(o.clone() for o in ops),
                          min_seq, with_props)
        return fused(state, *ops, min_seq=min_seq, with_props=with_props)

    # every window the plane encodes: its records, for the timing passes
    encode = rp.encode_window
    window_records = []

    def encode_kept(records, wid):
        window_records.append((records, wid))
        return encode(records, wid)

    eng = ds.storm_engine(D, dev, capacity=S)
    hub_lag = rp.StalenessTracker()     # the hub's delivery delay
    drain_lag = rp.StalenessTracker()   # the replica's drain lag
    hub = ObserverHub(ring=RP_RING, tracker=hub_lag)
    plane = rp.ReadPlane(eng, hub)
    eng.attach_read_plane(plane)
    tmp = tempfile.mkdtemp(prefix="readplane-")
    gens = SummaryGenerationStore(os.path.join(tmp, "gens"))
    odoor = ObserverDoor(hub, gen_store=gens).start_in_thread()
    sinks = [[] for _ in range(n_sinks)]
    for s in sinks:
        hub.subscribe(s.append, name="sink")
    observers = [ResilientObserver("127.0.0.1", odoor.port, name=f"o{i}",
                                   rng=random.Random(i), base_delay=0.01)
                 for i in range(n_observers)]
    deadline = time.monotonic() + 30
    while hub.stats()["subscribers"] < n_sinks + n_observers:
        if time.monotonic() > deadline:
            raise AssertionError("readplane phase: observers did not "
                                 "subscribe")
        time.sleep(0.005)
    gen_ids, poll_s, summary_s = [], [], []

    def between(k):
        nonlocal rep
        if k == 0:     # every client has joined: anchor the replica
            # the replica runs its leader's compaction cadence
            rep = rp.ReadReplica(eng, summary=eng.summarize(),
                                 tracker=drain_lag, device=dev,
                                 compact_every=1)
        else:
            t0 = time.perf_counter()
            rep.poll()
            sync()
            poll_s.append(time.perf_counter() - t0)
        if k in gen_waves:
            t0 = time.perf_counter()
            gen_ids.append(gens.save(eng.summarize(),
                                     seq=sum(eng.log.size(p) for p in
                                             range(eng.log.n_partitions))))
            summary_s.append(time.perf_counter() - t0)
        if k in tears:
            # the socket dies inside one of this wave's window runs
            for o in observers:
                o.tear_window()
        if k in kills:
            # an idle socket: the observer holds everything published
            published = hub.ops_published
            for o in observers:
                if not o.wait_ops(published, RP_WAIT_S):
                    raise AssertionError(f"readplane phase: {o.name} "
                                         f"stuck at {o.ops_applied}")
                o.kill_socket()

    door = ds.open_door(eng, window_rows or ds.WINDOW_ROWS)
    string_store.apply_string_batch_fused = watched
    rp.encode_window = encode_kept
    try:
        sk.launches = 0        # the storm's path starts here
        clients, wall = ds.storm(door, n_clients, n_waves, between=between)
        t0 = time.perf_counter()
        rep.poll()             # the last waves
        sync()
        poll_s.append(time.perf_counter() - t0)
        storm_launches = sk.launches   # and ends here
    finally:
        door.stop()
        string_store.apply_string_batch_fused = fused
        rp.encode_window = encode
    n_ops = n_clients * per * n_waves
    if plane.windows > RP_RING:
        raise AssertionError(f"readplane phase: {plane.windows} windows "
                             f"outgrew the ring of {RP_RING}")
    if plane.ops_published != n_ops:
        raise AssertionError(f"readplane phase: {plane.ops_published} ops "
                             f"published, {n_ops} acked")
    t0 = time.perf_counter()
    for o in observers:
        if not o.wait_ops(n_ops, RP_WAIT_S):
            raise AssertionError(f"readplane phase: {o.name} applied "
                                 f"{o.ops_applied} of {n_ops}")
    drain_s = time.perf_counter() - t0
    seqs = {d: eng.deli.doc_seq(d) for d in eng._doc_rows}
    obs_rows = []
    for o in observers:
        row = {"name": o.name, "ops_applied": o.ops_applied,
               "windows": o.windows_applied, "gaps": o.gaps,
               "op_gaps": o.op_gaps, "dups": o.dups,
               "window_dups": o.window_dups, "reconnects": o.reconnects,
               "torn_windows": o.torn_windows, "gave_up": o.gave_up}
        obs_rows.append(row)
        if (o.ops_applied != n_ops or o.gaps or o.op_gaps or o.dups
                or o.window_dups or o.gave_up
                or o.torn_windows != len(tears)
                or o.reconnects < len(tears) + len(kills)
                or o.doc_seqs != seqs):
            raise AssertionError(f"readplane phase: observer {row}")
    # encode once: each sink holds the same bytes object a window
    windows = plane.windows
    if any(len(s) != windows for s in sinks) or any(
            s[i] is not sinks[0][i] for s in sinks[1:]
            for i in range(windows)):
        raise AssertionError("readplane phase: a sink got other bytes")
    json_recs = sum(1 for w in sinks[0] for t, p in _frames(w)
                    if t == ord("J") and json.loads(bytes(p)).get("fmt")
                    == "json")
    if json_recs:
        raise AssertionError(f"readplane phase: {json_recs} JSON rec "
                             "frames for the string family")

    # the catch-up rung, over the observer door
    with socket.create_connection(("127.0.0.1", odoor.port),
                                  timeout=30) as s:
        s.sendall(encode_json({"t": "subscribe", "name": "joiner"}))
        read_frame(s)
        s.sendall(encode_json({"t": "catchup", "from_gen": gen_ids[0]}))
        rung = json.loads(read_frame(s)[1])
        s.sendall(encode_json({"t": "close"}))
    if not rung.get("diff_ok"):
        raise AssertionError(f"readplane phase: catch-up rung {rung}")
    for o in observers:
        o.close()
    odoor.stop()

    # the replica against the leader
    diff = ds.state_diff(eng, rep.engine, ranked=True)
    if diff:
        raise AssertionError(f"readplane phase: the replica differs from "
                             f"the leader in {diff}")
    if on_card and not counts["replica"]:
        raise AssertionError("readplane phase: the replica never launched "
                             "B1")
    # encode and publish, timed apart from the storm
    t0 = time.perf_counter()
    for _ in range(RP_REPS):
        encoded = [encode(r, w) for r, w in window_records]
    encode_ms = (time.perf_counter() - t0) * 1e3 / (RP_REPS * windows)
    if [p for p, _ in encoded] != sinks[0]:
        raise AssertionError("readplane phase: a re-encode differs")

    def publish_ms(n_subs):
        best = None
        for _ in range(3):
            h = ObserverHub(ring=8, tracker=rp.StalenessTracker())
            for _ in range(n_subs):
                h.subscribe(lambda _b: None)
            t0 = time.perf_counter()
            for _ in range(RP_REPS):
                for p, n in encoded:
                    h.publish(h.next_wid(), p, n)
            t = (time.perf_counter() - t0) * 1e3 / (RP_REPS * windows)
            best = t if best is None else min(best, t)
        return best

    pub_ms = {str(n): publish_ms(n) for n in (1, n_sinks)}
    del sinks, encoded, window_records

    # catch-up: the generation diff against a full load
    (g0, _), (g1, _) = (gens.load_generation(g) for g in gen_ids)
    live = digest(eng, "string", list(eng._doc_rows))
    string_store.apply_string_batch_fused = watched
    try:
        mode["path"] = "catchup"
        diff_ms, build_ms = [], []
        sk.launches = 0        # the catch-up's path starts here
        for _ in range(trials):
            t0 = time.perf_counter()
            d01 = rp.build_generation_diff("string", g0, g1, device=dev)
            sync()
            build_ms.append((time.perf_counter() - t0) * 1e3)
            caught = rp.apply_generation_diff("string", d01, g0, eng.log,
                                              device=dev)
            sync()
            diff_ms.append((time.perf_counter() - t0) * 1e3)
        catchup_launches = sk.launches   # and ends here
        mode["path"] = "full_load"
        full_ms = []
        for _ in range(trials):
            t0 = time.perf_counter()
            full = engine_class("string").load(g0, eng.log, device=dev)
            sync()
            full_ms.append((time.perf_counter() - t0) * 1e3)
        del full
        t0 = time.perf_counter()
        newest = engine_class("string").load(g1, eng.log, device=dev)
        sync()
        newest_ms = (time.perf_counter() - t0) * 1e3
    finally:
        string_store.apply_string_batch_fused = fused
        mode["path"] = "storm"
    if on_card and not catchup_launches:
        raise AssertionError("readplane phase: the catch-up's tail replay "
                             "never launched B1")
    docs = list(eng._doc_rows)
    if not (digest(caught, "string", docs) == digest(newest, "string", docs)
            == live):
        raise AssertionError("readplane phase: the diff catch-up, the load "
                             "of the newest generation and the live engine "
                             "read differently")
    dirty_rows = len(d01["store_delta"]["rows"])
    del caught, newest, d01, g0, g1

    # the first B1 launch of the replica and of the catch-up against the
    # plain version on the same input
    max_err = 0
    for path in ("replica", "catchup"):
        if path not in kept:
            continue
        st0, ops, ms, props = kept.pop(path)
        work = _clone_state(st0)
        sk.apply_string_batch_fused(work, *ops, min_seq=ms,
                                    with_props=props)
        ref = mt.apply_string_batch(st0, *ops, with_props=props)
        if ms is not None:
            ref = mt.compact_string_state(ref, ms, props)
        sync()
        err = kernel_timing.max_abs_err(mt, work, ref, props,
                                        ms is not None)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"readplane phase: B1 != plain on the "
                                 f"{path}'s first launch: {err}")
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "readplane", "docs": D, "capacity": S,
          "clients": n_clients, "waves": n_waves, "ops": n_ops,
          "storm_wall_s": wall, "ops_per_s": n_ops / wall,
          "gate_summary_s": summary_s,
          "windows": windows, "ops_published": plane.ops_published,
          "encode_ms_per_window": encode_ms,
          "publish_ms_per_window": pub_ms,
          "hub_delivery_p99_s": hub_lag.p99(),
          "replica_drain_lag_p99_s": drain_lag.p99(),
          "observers": obs_rows,
          "observer_drain_s": drain_s,
          "observer_reconnects": sum(o.reconnects for o in observers),
          "observer_torn_windows": sum(o.torn_windows for o in observers),
          "sinks": n_sinks, "ring": hub._ring.maxlen,
          "replica": {"polls": rep.polls, "ops": rep.ops_applied,
                      "poll_s_total": sum(poll_s),
                      "ops_per_s": rep.ops_applied / sum(poll_s),
                      "b1_launches": counts["replica"]},
          "door_b1_launches": counts["door"],
          "generations": gen_ids, "generation_waves": list(gen_waves),
          "tail_waves": tail, "dirty_rows": dirty_rows,
          "catchup_diff_ms": statistics.median(diff_ms),
          "catchup_diff_ms_trials": diff_ms,
          "diff_build_ms_trials": build_ms,
          "full_replay_ms": statistics.median(full_ms),
          "full_replay_ms_trials": full_ms,
          "newest_load_ms": newest_ms,
          "catchup_b1_launches": catchup_launches,
          "full_load_b1_launches": counts["full_load"],
          "catchup_rung": rung.get("diff_ok"),
          "max_abs_err": max_err,
          "total_s": time.perf_counter() - t_phase, "card": smi})
    del rep, eng, plane, hub
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": storm_launches + catchup_launches,
            "storm_launches": storm_launches,
            "replica_launches": counts["replica"],
            "catchup_launches": catchup_launches, "max_abs_err": max_err}


SVC_ROUNDS = 4              # rounds of the container session
SVC_SEED = 19               # its random.Random seed
SVC_PASTE_ROUND = 2         # the round of the pastes
SVC_PASTE_EVERY = 64        # one doc in 64 pastes 6,000 chars (compressed)
SVC_CHUNK_EVERY = 1024      # one doc in 1,024 pastes 20,000 (chunked)
SVC_TWIN_DOCS = 256         # the card / CPU twin's docs
SVC_PROP_DOCS = 1024        # docs whose properties are probed
SVC_PROP_PROBES = 4         # positions probed a doc


class _HostParts:
    """Self-time of nested host parts: each second goes to the innermost
    part entered (the rest to ``base``)."""

    def __init__(self, base):
        self.s = {base: 0.0}
        self._stack = [base]
        self._t = time.perf_counter()

    def _charge(self):
        now = time.perf_counter()
        top = self._stack[-1]
        self.s[top] = self.s.get(top, 0.0) + now - self._t
        self._t = now

    def wrap(self, part, fn):
        def timed(*a, **kw):
            self._charge()
            self._stack.append(part)
            try:
                return fn(*a, **kw)
            finally:
                self._charge()
                self._stack.pop()
        return timed

    def reset(self):
        """Start the count again (outside any part)."""
        self.s = dict.fromkeys(self.s, 0.0)
        self._t = time.perf_counter()

    def close(self):
        self._charge()
        return dict(self.s)


def _envelope_census(svc, docs):
    """Wire ops (client OP messages), the runtime ops they carry, and the
    compressed and chunked envelopes among them, from the service's
    op store."""
    from fluidframework_tpu_torch.core.protocol import MessageType
    from fluidframework_tpu_torch.runtime.remote_message_processor import (
        RemoteMessageProcessor,
    )
    out = {"wire_ops": 0, "runtime_ops": 0, "compressed": 0, "chunks": 0,
           "chunked_envelopes": 0, "grouped": 0}
    for d in docs:
        rmp = RemoteMessageProcessor()
        for m in svc.get_deltas(d):
            if m.type != MessageType.OP or m.client_id < 0:
                continue
            out["wire_ops"] += 1
            c = m.contents
            if isinstance(c, dict) and c.get("type") == "withMeta":
                c = c["contents"]
            kind = c.get("type") if isinstance(c, dict) else None
            if kind == "compressed":
                out["compressed"] += 1
            elif kind == "chunkedOp":
                out["chunks"] += 1
                if c["chunkIndex"] == c["totalChunks"] - 1:
                    out["chunked_envelopes"] += 1
            elif kind == "groupedBatch":
                out["grouped"] += 1
            out["runtime_ops"] += len(rmp.process(m))
    return out


def service_phase(smi, dev, D=D, S=S_SERVE, rounds=SVC_ROUNDS,
                  seed=SVC_SEED, twin_docs=SVC_TWIN_DOCS,
                  prop_docs=SVC_PROP_DOCS, paste_every=SVC_PASTE_EVERY,
                  chunk_every=SVC_CHUNK_EVERY):
    """Phase 16: the in-process Tinylicious service with its device
    replica. ``ServingLocalService(n_docs=D, capacity=S, n_props=8,
    batch_window=64, compact_every=16, n_partitions=4)`` on ``dev`` serves
    D docs (ids ``svc00000`` ...) to container clients
    (``testing/service_session.py``: an editor in ``flush_mode="turn"``
    and an ``"immediate"`` viewer a doc, schema ``{"text":
    "sharedString", "meta": "map"}``), ``rounds`` seeded rounds with a
    compressed paste in one doc of ``paste_every`` and a chunked one in
    one of ``chunk_every``; every ``flush_replica`` merges the string
    channels through B1 (``TensorStringStore.apply_messages``) and every
    16th compacts. Checks: every doc's server read equals both clients'
    text; ``get_properties`` at 4 seeded positions of ``prop_docs`` docs
    equals the editor's; one served channel a doc, nothing dropped or
    nacked, no op left pending; the store lies on the card and B1
    launched once an op window of every flush, in both its no-props and
    its props mode, the first launch of each held against the plain
    version. Then the same session on the first ``twin_docs`` docs
    through a service on ``dev`` and one with ``device="cpu"``: their
    stores' fingerprints (``service_session.store_fingerprint``) are equal after every
    apply and every compaction, and so are their reads. Returns
    {"launches", "twin_launches", "max_abs_err"}."""
    import random

    from fluidframework_tpu_torch.ops import merge_tree as mt
    from fluidframework_tpu_torch.ops import string_kernel as sk
    from fluidframework_tpu_torch.ops import string_store
    from fluidframework_tpu_torch.server.serving_service import (
        ServingLocalService,
    )
    from fluidframework_tpu_torch.testing import kernel_timing
    from fluidframework_tpu_torch.testing.service_session import (
        ServiceSession, doc_ids, fingerprinted,
    )
    import torch

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def service(device, n):
        return ServingLocalService(
            n_docs=n, capacity=S, n_props=8, batch_window=64,
            compact_every=16, n_partitions=4, device=device)

    # B1 as the store calls it: counted, timed with CUDA events, and the
    # first input of each mode kept for the plain version
    fused = string_store.apply_string_batch_fused
    events, modes, kept = [], [], {}

    def watched(state, *ops, min_seq=None, with_props=False):
        modes.append(with_props)
        if with_props not in kept:
            kept[with_props] = (_clone_state(state),
                                tuple(o.clone() for o in ops), min_seq)
        if not on_card:
            return fused(state, *ops, min_seq=min_seq,
                         with_props=with_props)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fused(state, *ops, min_seq=min_seq, with_props=with_props)
        b.record()
        events.append((a, b))
        return out

    # ------------------------------------------------- (a) config #4 served
    docs = doc_ids(D)
    t0 = time.perf_counter()
    svc = service(dev, D)
    if svc.store.device.type != dev.type:
        raise AssertionError(f"service phase: the store is on "
                             f"{svc.store.device}")
    parts = _HostParts("client stack")
    # Deli, the parent's lambdas and the replica's consumer are bound as
    # the log subscribers at construction: each partition must hold
    # exactly those bound methods, which are replaced in place by their
    # timed wrappers
    deli, lambdas, replica = (svc._deli_consume, svc._deltas_consume,
                              svc._replica_consume)
    timed_deli = parts.wrap("sequencing", deli)
    timed_subs = [parts.wrap("lambdas", lambdas),
                  parts.wrap("replica decode", replica)]
    for p in range(svc.deltas_log.n_partitions):
        subs, raw = svc.deltas_log._subs[p], svc.raw_log._subs[p]
        if subs != [lambdas, replica] or raw != [deli]:
            raise AssertionError(f"service phase: partition {p} has "
                                 f"subscribers {subs} / {raw}, not the "
                                 "lambdas, the replica and Deli")
        subs[:] = timed_subs
        raw[:] = [timed_deli]
    svc._deli_consume = timed_deli
    base_deliver_to = svc._deliver_to

    def deliver_to(conn):
        inner = parts.wrap("client stack", base_deliver_to(conn))
        conn._deliver = inner
        return inner

    svc._deliver_to = deliver_to
    store = svc.store
    apply_messages, compact = store.apply_messages, store.compact
    windows = []

    def applied(msgs):
        apply_messages(msgs)
        windows.append(len(store.last_op_windows))

    compactions = []

    def compacted(ms):
        t = time.perf_counter()
        compact(ms)
        sync()
        compactions.append(time.perf_counter() - t)

    store.apply_messages = parts.wrap("replica flush", applied)
    store.compact = parts.wrap("replica compaction", compacted)
    session = ServiceSession(svc, docs)
    sync()
    open_s = time.perf_counter() - t0
    string_store.apply_string_batch_fused = watched
    try:
        sk.launches = 0      # the main path starts here
        parts.reset()
        t0 = time.perf_counter()
        session.run(rounds, seed, paste_round=SVC_PASTE_ROUND,
                    paste_every=paste_every, chunk_every=chunk_every)
        svc.flush_replica()
        sync()
        wall = time.perf_counter() - t0
        launches = sk.launches   # and ends here
    finally:
        string_store.apply_string_batch_fused = fused
    host = parts.close()
    t0 = time.perf_counter()
    bad = [d for d, (ta, tb, _) in zip(docs, session.texts)
           if not (svc.read_text(d, "text") == ta.get_text()
                   == tb.get_text())]
    read_s = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"service phase: {len(bad)} docs read "
                             f"differently on the server, e.g. {bad[:4]}")
    rng = random.Random(seed + 1)
    probes = 0
    t0 = time.perf_counter()
    for i in rng.sample(range(D), min(prop_docs, D)):
        ta = session.texts[i][0]
        n = ta.get_length()
        for pos in rng.sample(range(n), min(SVC_PROP_PROBES, n)):
            probes += 1
            if svc.get_properties(docs[i], "text", pos) != \
                    ta.get_properties(pos):
                raise AssertionError(f"service phase: {docs[i]} props at "
                                     f"{pos} differ from the editor's")
    probe_s = time.perf_counter() - t0
    served = [d for d in docs if svc.served_channels(d) !=
              [("default", "text")]]
    if served or svc.dropped_channels() or svc.nacks:
        raise AssertionError(f"service phase: channels {served[:4]}, "
                             f"dropped {svc.dropped_channels()[:4]}, "
                             f"nacks {svc.nacks[:4]}")
    pending = sum(c.container.runtime.pending.has_pending
                  for pair in session.containers for c in pair)
    if pending:
        raise AssertionError(f"service phase: {pending} containers hold "
                             "unacked ops")
    counters = dict(svc.metrics.counters)
    flushes = int(counters.get("replica_flushes", 0))
    if flushes != len(windows) or 0 in windows:
        raise AssertionError(f"service phase: {flushes} flushes, "
                             f"windows {windows[:8]}")
    if on_card and launches != sum(windows):
        raise AssertionError(f"service phase: B1 launched {launches} "
                             f"times for {sum(windows)} op windows")
    if not (False in modes and True in modes):
        raise AssertionError("service phase: B1 did not run both its "
                             "no-props and its props mode")
    ms = sorted(a.elapsed_time(b) for a, b in events) if events else []
    census = _envelope_census(svc, docs)
    if census["compressed"] < D // paste_every - D // chunk_every or \
            census["chunked_envelopes"] < D // chunk_every:
        raise AssertionError(f"service phase: envelopes {census}")
    summaries = session.summaries_acked()
    string_ops = int(counters.get("replica_ops_applied", 0))
    edits = dict(session.edits)
    round_s = list(session.round_s)
    del session
    svc.close()
    del svc, store

    # the first launch of each mode against the plain version
    max_err = 0
    for props, (st0, ops, m) in sorted(kept.items()):
        work = _clone_state(st0)
        fused(work, *ops, min_seq=m, with_props=props)
        ref = mt.apply_string_batch(st0, *ops, with_props=props)
        sync()
        err = kernel_timing.max_abs_err(mt, work, ref, props, False)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"service phase: B1 != plain on the "
                                 f"first {'props' if props else 'no-props'}"
                                 f" launch: {err}")
    kept.clear()

    # ------------------------------------------------ (b) card / CPU twin
    prints, reads = [], []
    sk.launches = 0
    t0 = time.perf_counter()
    for device in (dev, torch.device("cpu")):
        tsvc = service(device, twin_docs)
        prints.append(fingerprinted(tsvc))
        ts = ServiceSession(tsvc, docs[:twin_docs])
        ts.run(rounds, seed, paste_round=SVC_PASTE_ROUND,
               paste_every=paste_every, chunk_every=chunk_every)
        tsvc.flush_replica()
        reads.append([tsvc.read_text(d, "text") for d in ts.docs])
        if reads[-1] != [t[0].get_text() for t in ts.texts]:
            raise AssertionError(f"service phase: the {device.type} twin "
                                 "reads differ from its clients")
        tsvc.close()
    twin_launches = sk.launches
    twin_s = time.perf_counter() - t0
    if prints[0] != prints[1] or reads[0] != reads[1]:
        first = next((i for i, (a, b) in enumerate(zip(*prints)) if a != b),
                     min(map(len, prints)))
        raise AssertionError(f"service phase: the card and CPU twins differ "
                             f"at store step {first} of {len(prints[0])}")
    kinds = [(k, props) for k, props, _ in prints[0]]
    if on_card and not (("compact", True) in kinds
                        and ("apply", False) in kinds):
        raise AssertionError("service phase: the twin crossed no "
                             "compaction or no props switch")
    emit({"phase": "service", "docs": D, "capacity": S, "n_props": 8,
          "batch_window": 64, "compact_every": 16, "rounds": rounds,
          "containers": 2 * D, "open_s": open_s, "wall_s": wall,
          "round_s": round_s, "string_ops": string_ops,
          "string_ops_per_s": string_ops / wall, "edits": edits,
          "envelopes": census, "replica_flushes": flushes,
          "op_windows": sum(windows), "b1_launches": launches,
          "b1_props_launches": sum(modes),
          "b1_call_ms_mean": sum(ms) / len(ms) if ms else None,
          "b1_call_ms_p99": ms[int(0.99 * (len(ms) - 1))] if ms else None,
          "b1_call_ms_total": sum(ms),
          "compactions": len(compactions),
          "compaction_s_total": sum(compactions),
          "summaries_acked": summaries,
          "host_s": {**host, "reads": read_s, "property_probes": probe_s},
          "property_probes": probes, "served_channels_per_doc": 1,
          "dropped_channels": 0, "nacks": 0,
          "twin": {"docs": twin_docs, "store_steps": len(prints[0]),
                   "compactions": sum(1 for p in prints[0]
                                      if p[0] == "compact"),
                   "props_switch_at_step": next(
                       (i for i, p in enumerate(prints[0]) if p[1]), None),
                   "b1_launches": twin_launches, "seconds": twin_s,
                   "fingerprints_equal": True},
          "max_abs_err": max_err,
          "total_s": time.perf_counter() - t_phase, "card": smi})
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": launches, "twin_launches": twin_launches,
            "max_abs_err": max_err}


def parent_timing(parent, tree_inputs=None, axis_inputs=None,
                  mega_inputs=None):
    """K1-K7 of ``parent`` (another checkout, e.g. an archive
    of the parent commit) and of this checkout, timed by
    ``testing/kernel_timing.py`` in turns: parent, change, change, parent,
    at its shapes, at the K5 inputs saved in ``tree_inputs`` (the tree
    phase's widest launches of the per-op, recovery and load paths), at
    the K3 / K4 inputs saved in ``axis_inputs`` (the matrix engine's
    widest launch of each path) and at the K7 inputs saved in
    ``mega_inputs`` (the megadoc phase's widest kernel-loop and engine
    launches).
    Returns {(kernel, spec): {"parent": [ms, ms], "change": [ms, ms], and
    each label's first per-kernel device split}} and raises when a run
    fails or disagrees with its plain version."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "fluidframework_tpu_torch", "testing",
                          "kernel_timing.py")
    out = {}
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        kernels = "map_apply,cell_merge,tree_apply,tree_expand" + (
            ",axis_apply,axis_resolve" if axis_inputs else "") + (
            ",megadoc_apply" if mega_inputs else "")
        proc = subprocess.run(
            [sys.executable, script, "--kernel", kernels,
             "--profile", "--root", os.path.abspath(root)]
            + (["--tree-inputs", tree_inputs] if tree_inputs else [])
            + (["--axis-inputs", axis_inputs] if axis_inputs else [])
            + (["--megadoc-inputs", mega_inputs] if mega_inputs else []),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"kernel_timing --root {root} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        for line in proc.stdout.splitlines():
            row = json.loads(line)
            rec = out.setdefault((row["kernel"], row["spec"]), {})
            rec.setdefault(label, []).append(row["ms"])
            rec.setdefault(label + "_device_ms_by_kernel",
                           row["device_ms_by_kernel"])
    emit({"phase": "parent_timing", "parent": os.path.abspath(parent),
          "rows": [{"kernel": k, "spec": sp, **v}
                   for (k, sp), v in sorted(out.items())]})
    return out


def add_parent_ms(entry, kernel, timing):
    """``parent_ms`` (mean of the parent's runs) beside each of the entry's
    rows whose spec begins with a kernel_timing spec (the longest such),
    and on the entry (its main row); None where the helper did not run."""
    for row in entry.get("specialisations", []) + [entry]:
        spec = str(row.get("spec") or row.get("shape", {}).get("spec", ""))
        hits = [(len(sp), v["parent"]) for (k, sp), v in (timing or {})
                .items() if k == kernel and spec.startswith(sp)]
        ms = max(hits, key=lambda h: h[0])[1] if hits else None
        row["parent_ms"] = sum(ms) / len(ms) if ms else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose K1 - K7 are timed in "
                         "turns with this one's (parent_ms)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from fluidframework_tpu_torch.ops import cuda_build
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
    # one nvcc per kernel source and the g++ sequencer, all in parallel
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    reports = {n: ptxas_report(cuda_build.build_info[n]["ptxas"])
               for n in cuda_build.SOURCES}
    ptxas = reports["string_apply"]
    for n, rep in reports.items():
        if not rep or any("registers" not in k for k in rep):
            raise RuntimeError(f"no -Xptxas -v report for {n}")
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "kernel_build_s": {n: cuda_build.build_info[n]["seconds"]
                             for n in cuda_build.SOURCES},
          "native_build_s": {t: cuda_build.build_info[t]["seconds"]
                             for t in ("libdeli.so", "liboplog.so",
                                       "libingress.so")},
          "spill_store_bytes_max": max(k["spill_stores"]
                                       for r in reports.values() for k in r),
          "stack_frame_bytes_max": max(k["stack_frame"]
                                       for r in reports.values() for k in r),
          "instantiations": reports})

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
    bound = string_bound

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
    torch.cuda.empty_cache()
    map_entry = map_phase(smi, dev)
    torch.cuda.empty_cache()
    cell_entry = matrix_phase(smi, dev)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp() if args.parent else None
    keep_axis = os.path.join(tmp, "axis_inputs.pt") if tmp else None
    keep_tree = os.path.join(tmp, "tree_inputs.pt") if tmp else None
    axis_entries = matrix_engine_phase(smi, dev, keep_inputs=keep_axis)
    for entry in axis_entries:   # ptxas: registers, spills per function
        entry["ptxas"] = [k for k in reports["axis_apply"]
                          if entry["name"] + "_kernel" in k.get("entry", "")]
        if not entry["ptxas"]:
            raise RuntimeError(f"no -Xptxas -v report for {entry['name']}")
    torch.cuda.empty_cache()
    tree_entries = tree_phase(smi, dev, keep_tree)
    torch.cuda.empty_cache()
    keep_mega = os.path.join(tmp, "megadoc_inputs.pt") if tmp else None
    mega_entry = megadoc_phase(smi, dev, reports["megadoc_apply"], keep_mega)
    torch.cuda.empty_cache()
    iv_launches, iv_rec_launches, iv_err = intervals_phase(smi, dev)
    max_err = max(max_err, iv_err)
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase(smi, dev)
    torch.cuda.empty_cache()
    durable_launches = durable_phase(smi, dev)
    torch.cuda.empty_cache()
    door = door_phase(smi, dev)
    max_err = max(max_err, door["max_abs_err"])
    torch.cuda.empty_cache()
    readplane = readplane_phase(smi, dev)
    max_err = max(max_err, readplane["max_abs_err"])
    torch.cuda.empty_cache()
    service = service_phase(smi, dev)
    max_err = max(max_err, service["max_abs_err"])
    torch.cuda.empty_cache()
    timing_pc = parent_timing(args.parent, keep_tree, keep_axis,
                              keep_mega) if args.parent else None
    if tmp:
        shutil.rmtree(tmp)
    add_parent_ms(cell_entry, "cell_merge", timing_pc)
    add_parent_ms(axis_entries[0], "axis_apply", timing_pc)
    add_parent_ms(axis_entries[1], "axis_resolve", timing_pc)
    add_parent_ms(tree_entries[0], "tree_apply", timing_pc)
    add_parent_ms(map_entry, "map_apply", timing_pc)
    add_parent_ms(tree_entries[1], "tree_expand", timing_pc)
    add_parent_ms(mega_entry, "megadoc_apply", timing_pc)

    main_t = timing[("no-props+compact", S_SERVE, "chained")]
    entries = [{
        "name": "string_apply",
        "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/string_apply.cu",
        "replaces": "fluidframework_tpu/ops/pallas_string_kernel.py:208",
        "launches": launches + door["launches"] + readplane["launches"]
        + service["launches"],
        "max_abs_err": max_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,
        "shape": {"D": D, "S": S_SERVE, "O": O,
                  "spec": "no-props+compact (the serving path)"},
        "recovery_launches": phase_launches,
        "interval_launches": iv_launches,
        "interval_recovery_launches": iv_rec_launches,
        "durable_launches": durable_launches,
        "serving_launches": launches,
        "door_launches": {k: door[k] for k in ("storm_launches",
                                               "admission_launches")},
        "readplane_launches": {k: readplane[k] for k in (
            "storm_launches", "replica_launches", "catchup_launches")},
        "service_launches": {"service": service["launches"],
                             "card_twin": service["twin_launches"]},
        "specialisations": [
            {"spec": name, "S": S, "state": state, **t}
            for (name, S, state), t in timing.items()]
        + rebuild_rows + door["rows"],
        "total_s": time.perf_counter() - t_start,
    }, map_entry, cell_entry, *axis_entries, *tree_entries, mega_entry]
    for entry in entries:   # the mesh phase's launches, shard by shard
        entry["mesh_launches_per_shard"] = {
            path: per[entry["name"]] for path, per in mesh_launches.items()
            if entry["name"] in per}
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
