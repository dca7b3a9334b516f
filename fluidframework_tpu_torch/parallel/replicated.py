"""The replicated merge step over a (replica, docs) mesh.

Counterpart of ``fluidframework_tpu/parallel/replicated.py``:

- the doc axis is sharded over the ``docs`` mesh axis;
- each replica ingests a disjoint 1/R slice of every doc's op batch (its
  "front door" share); the step gathers the full batch on every replica
  by copying each replica's slice to every replica's device (the
  Broadcaster fan-out; peer to peer where the host has NVLink);
- every replica applies the same ops to its copy of the doc shard (B1 on
  a CUDA shard, the plain version on a CPU shard), and
- a cross-replica digest check (max == min of each doc's digest over the
  replicas) asserts bit-identical convergence.

The host tier of replication is :class:`OplogFollower`: a second engine
that trails a leader through its durable log (the read plane's replicas
ride it, ``server/read_plane.py``).

The state is a ``ReplicatedState``: a (replica, docs) grid of
``StringState`` blocks, block (r, d) on device (r, d) of the mesh.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.protocol import MessageType
from ..ops.merge_tree import StringState, string_state_digest
from ..ops.string_kernel import apply_string_batch_fused
from .mesh import DOC_AXIS, REPLICA_AXIS, Mesh
from .sharded import concat_state, shard_bounds, shard_scope, split_state


def _grid(mesh: Mesh):
    if mesh.axis_names != (REPLICA_AXIS, DOC_AXIS):
        raise ValueError("the replicated step runs on a (replica, docs) "
                         "mesh (make_mesh)")
    return mesh.devices.shape


class ReplicatedState:
    """``blocks[r][d]``: replica r's copy of doc shard d."""

    def __init__(self, blocks: List[List[StringState]]):
        self.blocks = blocks

    def full(self, replica: int = 0, device="cpu") -> StringState:
        """Replica ``replica``'s whole state (doc shards in row order)."""
        return concat_state(self.blocks[replica], device)


def shard_state(state: StringState, mesh: Mesh) -> ReplicatedState:
    """Place a whole state on the mesh: each replica gets a copy of every
    doc shard's rows on its own device."""
    n_rep, n_doc = _grid(mesh)
    shard_bounds(state.seq.shape[0], n_doc)
    return ReplicatedState([split_state(state, list(mesh.devices[r]))
                            for r in range(n_rep)])


def shard_ops(mesh: Mesh, *planes) -> tuple:
    """(D, O) op planes as ingested, one grid each: ``out[i][r][d]`` is
    replica r's slice of the op axis (O / R columns) of plane i over doc
    shard d's rows, on device (r, d)."""
    n_rep, n_doc = _grid(mesh)
    arrs = [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p,
                       np.int32) for p in planes]
    D, O = arrs[0].shape
    rows = shard_bounds(D, n_doc)
    if O % n_rep:
        raise ValueError(f"op axis {O} not divisible by {n_rep} replicas")
    cols = O // n_rep
    return tuple([[torch.from_numpy(np.ascontiguousarray(
                       a[lo:hi, r * cols:(r + 1) * cols])).to(
                           mesh.devices[r, d])
                   for d, (lo, hi) in enumerate(rows)]
                  for r in range(n_rep)] for a in arrs)


def make_replicated_step(mesh: Mesh, with_props: bool = True,
                         inject_divergence: bool = False):
    """The multi-device step: ``step(state, *planes)`` with ``state`` a
    ``ReplicatedState`` and the 7 op planes from ``shard_ops`` → (state,
    digests, agree). The state is updated in place; ``digests`` is replica 0's
    (D,) per-doc digest on the mesh's first device, ``agree`` a 0-d int32
    tensor there (1 when every replica holds bit-identical state).

    ``inject_divergence`` is the chaos hook: it skews each replica's digest
    by its replica index before the agreement check, so the detector
    itself has to notice."""
    n_rep, n_doc = _grid(mesh)
    home = mesh.devices[0, 0]

    def step(state: ReplicatedState, *planes):
        digests = [[None] * n_doc for _ in range(n_rep)]
        for d in range(n_doc):
            for r in range(n_rep):
                dev = mesh.devices[r, d]
                # all-gather over the replica axis, tiled on the op axis:
                # every replica's ingest slice copied to this device
                full = tuple(torch.cat([p[q][d].to(dev, non_blocking=True)
                                        for q in range(n_rep)], dim=1)
                             for p in planes)
                with shard_scope(d, dev):
                    apply_string_batch_fused(state.blocks[r][d], *full,
                                             with_props=with_props)
                dig = string_state_digest(state.blocks[r][d])
                if inject_divergence:
                    dig = dig + r
                digests[r][d] = dig
        agree = torch.ones((), dtype=torch.int32, device=home)
        for d in range(n_doc):
            dev = mesh.devices[0, d]
            stack = torch.stack([digests[r][d].to(dev, non_blocking=True)
                                 for r in range(n_rep)])
            same = torch.all(stack.max(dim=0).values
                             == stack.min(dim=0).values)
            agree = agree & same.to(home).to(torch.int32)
        out = torch.cat([digests[0][d].to(home) for d in range(n_doc)])
        return state, out, agree

    return step


class OplogFollower:
    """A warm standby trailing a leader engine through its durable log.

    The follower owns a second engine of the same family, loaded on
    ``device`` from a leader summary (``summary``, else a fresh one) over
    the leader's log (both replicas consume one stream; ``engine_kw`` go
    to the engine's ``load``). :meth:`catch_up` reads every partition's
    records past the follower's offsets (only those below the
    partition's size at read time), expands columnar records to per-op
    messages, sorts them by (doc, seq) (a partition scan is not in the
    order of events) and replays them: the sequencer, the member set and
    dedup ledger, then the device apply queue, in one flush. A per-doc
    applied-seq cursor makes the replay idempotent: a record read twice
    is skipped by its seq."""

    def __init__(self, leader, summary: Optional[dict] = None,
                 device="cuda", **engine_kw):
        self.log = leader.log
        summary = summary if summary is not None else leader.summarize()
        self.engine = type(leader).load(summary, self.log, device=device,
                                        **engine_kw)
        # everything up to the summary's sequencer state was replayed by
        # the load; new records land past these cursors
        self._offsets = [self.log.size(p)
                         for p in range(self.log.n_partitions)]
        self._applied: dict = {}
        for doc_id in list(self.engine._doc_rows):
            self._applied[doc_id] = self.engine.deli.doc_seq(doc_id)
        self.caught_up_ops = 0

    def catch_up(self) -> int:
        """Drain the leader's log tail into the follower; returns the
        number of messages newly applied. Idempotent per (doc, seq)."""
        tail = []
        for p in range(self.log.n_partitions):
            size = self.log.size(p)
            if size <= self._offsets[p]:
                continue
            for rec in self.log.read(p, from_offset=self._offsets[p],
                                     to_offset=size):
                tail.extend(rec.expand() if hasattr(rec, "expand")
                            else (rec,))
            self._offsets[p] = size
        tail.sort(key=lambda m: (m.doc_id, m.seq))
        eng = self.engine
        n = 0
        for msg in tail:
            if msg.seq <= self._applied.get(msg.doc_id, 0):
                continue    # raced an already-replayed record: skip
            eng.deli.replay(msg)
            eng._absorb_resilience(msg)
            if msg.type == MessageType.OP:
                eng._enqueue(msg.doc_id, msg)
                eng._min_seq[msg.doc_id] = max(
                    eng._min_seq.get(msg.doc_id, 0), msg.min_seq)
            self._applied[msg.doc_id] = msg.seq
            n += 1
        if n:
            eng._queue.sort(key=lambda dm: dm[1].seq)
            eng.flush()
        self.caught_up_ops += n
        return n
