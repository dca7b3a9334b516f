"""Synthetic op corpora (seeded numpy) for tests and the chip smoke run.

Every doc follows the same op-kind cadence, so per-op visible lengths are a
known sequence and position draws vectorise; per-doc randomness lives in
the positions (and, for the conflict storm, in clients and perspectives).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.merge_tree import MAX_CLIENTS, PROP_HANDLE_BITS
from ..ops.schema import OpKind

INS_LEN = 4
RM_LEN = 2


def typing_storm(n_docs: int, n_ops: int, seed: int = 0,
                 start_seq: int = 1) -> Tuple[dict, int]:
    """Dense (D, O) op planes for a synthetic multi-doc typing storm.

    Cadence per doc: 3 inserts of INS_LEN chars, then one remove of RM_LEN.
    Returns (planes dict, next_seq). Sequence numbers are assigned
    round-robin across docs in op-index order, matching a fair sequencer.
    """
    rng = np.random.default_rng(seed)
    D, O = n_docs, n_ops

    lengths = np.zeros(O + 1, dtype=np.int64)
    kinds = np.zeros(O, dtype=np.int32)
    for k in range(O):
        if k % 4 < 3 or lengths[k] < RM_LEN:
            kinds[k] = OpKind.STR_INSERT
            lengths[k + 1] = lengths[k] + INS_LEN
        else:
            kinds[k] = OpKind.STR_REMOVE
            lengths[k + 1] = lengths[k] - RM_LEN

    kind = np.broadcast_to(kinds, (D, O)).copy()
    a0 = np.zeros((D, O), np.int32)
    a1 = np.zeros((D, O), np.int32)
    a2 = np.zeros((D, O), np.int32)
    for k in range(O):
        if kinds[k] == OpKind.STR_INSERT:
            a0[:, k] = rng.integers(0, lengths[k] + 1, size=D)
            a1[:, k] = INS_LEN
            a2[:, k] = k + 1  # payload handle (synthetic)
        else:
            a0[:, k] = rng.integers(0, lengths[k] - RM_LEN + 1, size=D)
            a1[:, k] = a0[:, k] + RM_LEN

    # global seq: op k of doc d -> start + k*D + d (round-robin sequencer)
    d_idx = np.arange(D, dtype=np.int64)[:, None]
    k_idx = np.arange(O, dtype=np.int64)[None, :]
    seq = (start_seq + k_idx * D + d_idx).astype(np.int32)
    ref_seq = np.maximum(seq - D, 0).astype(np.int32)  # saw own previous op
    client = np.zeros((D, O), np.int32)
    planes = dict(kind=kind, a0=a0, a1=a1, a2=a2, seq=seq, client=client,
                  ref_seq=ref_seq)
    return planes, int(start_seq + D * O)


def conflict_storm(n_docs: int, n_ops: int, seed: int = 0,
                   start_seq: int = 1, n_clients: int = 4, lag: int = 8,
                   n_keys: int = 4, n_values: int = 8,
                   warmup: int = 16) -> Tuple[dict, int]:
    """The CONFLICT-HEAVY multi-client corpus (the typing storm is
    single-writer, annotate-free and fully caught up — none of the hot
    path's hard part). Here every (doc, op) draws a random client
    and a perspective that LAGS the sequenced stream by up to ``lag`` of
    the doc's own ops (divergent ref_seq → real concurrent-insert
    tie-breaks and remove-vs-insert visibility work), removes overlap by
    construction (random ranges from stale perspectives), and ~1/8 of ops
    are annotates (packed key<<20 | value, value 0 deletes the key) so the
    props planes are exercised.

    Position validity: positions are drawn below a CONSERVATIVE visible-
    length bound — the doc's length ``lag`` ops ago minus every remove
    issued inside the lag window — so any perspective in the window sees
    at least that much text.

    Cadence per op index k: k < warmup → insert; else k%8 in {3, 7} →
    remove, k%8 == 5 → annotate, else insert.
    """
    rng = np.random.default_rng(seed)
    D, O = n_docs, n_ops

    kinds = np.zeros(O, np.int32)
    lengths = np.zeros(O + 1, np.int64)
    for k in range(O):
        r = k % 8
        if k >= warmup and r in (3, 7) and lengths[k] >= 3 * RM_LEN:
            kinds[k] = OpKind.STR_REMOVE
            lengths[k + 1] = lengths[k] - RM_LEN
        elif k >= warmup and r == 5:
            kinds[k] = OpKind.STR_ANNOTATE
            lengths[k + 1] = lengths[k]
        else:
            kinds[k] = OpKind.STR_INSERT
            lengths[k + 1] = lengths[k] + INS_LEN

    # conservative visible length at op k for ANY perspective in the window
    rm_in_window = np.array(
        [sum(1 for j in range(max(k - lag, 0), k)
             if kinds[j] == OpKind.STR_REMOVE) for k in range(O)], np.int64)
    bound = np.maximum(lengths[np.maximum(np.arange(O) - lag, 0)]
                       - RM_LEN * rm_in_window, 0)

    kind = np.broadcast_to(kinds, (D, O)).copy()
    a0 = np.zeros((D, O), np.int32)
    a1 = np.zeros((D, O), np.int32)
    a2 = np.zeros((D, O), np.int32)
    for k in range(O):
        b = int(bound[k])
        if kinds[k] == OpKind.STR_INSERT:
            a0[:, k] = rng.integers(0, b + 1, size=D)
            a1[:, k] = INS_LEN
            a2[:, k] = k + 1
        elif kinds[k] == OpKind.STR_REMOVE:
            a0[:, k] = rng.integers(0, b - RM_LEN + 1, size=D)
            a1[:, k] = a0[:, k] + RM_LEN
        else:  # annotate: ranges up to 6 chars, overlapping freely
            a0[:, k] = rng.integers(0, max(b - 1, 1), size=D)
            span = rng.integers(1, 7, size=D)
            a1[:, k] = np.minimum(a0[:, k] + span, max(b, 1))
            key = rng.integers(0, n_keys, size=D).astype(np.int64)
            val = rng.integers(0, n_values + 1, size=D).astype(np.int64)
            a2[:, k] = ((key << PROP_HANDLE_BITS) | val).astype(np.int32)

    d_idx = np.arange(D, dtype=np.int64)[:, None]
    k_idx = np.arange(O, dtype=np.int64)[None, :]
    seq = (start_seq + k_idx * D + d_idx).astype(np.int32)
    client = rng.integers(0, n_clients, size=(D, O)).astype(np.int32)
    # divergent perspectives: op k of doc d saw the doc's op (k-1-lag_dk)
    lag_dk = rng.integers(0, lag + 1, size=(D, O))
    vis = np.maximum(k_idx - 1 - lag_dk, -1)
    ref_seq = np.where(vis >= 0, start_seq + vis * D + d_idx, 0) \
        .astype(np.int32)
    planes = dict(kind=kind, a0=a0, a1=a1, a2=a2, seq=seq, client=client,
                  ref_seq=ref_seq)
    return planes, int(start_seq + D * O)


def megadoc_storm(n_docs: int, n_ops: int, seed: int = 0) -> dict:
    """Dense (D, n_ops) op planes for long (mega) documents: the first
    half of the docs take a ``typing_storm`` (one writer, caught up), the
    rest a ``conflict_storm`` (4 clients, lagging perspectives,
    annotates). Seqs rise along each doc's row; a window of columns
    continues the docs the earlier windows built."""
    h = n_docs // 2
    a, _ = typing_storm(h, n_ops, seed=seed)
    b, _ = conflict_storm(n_docs - h, n_ops, seed=seed + 1)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def edge_storm(n_docs: int, n_ops: int, seed: int = 0,
               start_seq: int = 1) -> Tuple[dict, int]:
    """conflict_storm with client indexes drawn from {-1, 0, 30, 31} (bit
    31 of the remover mask is the int32 sign bit; index -1 sees no remover
    bit; four clients and a short insert-only warm-up keep concurrent
    removes frequent),
    annotate keys 0..5 (with K=4 property planes keys 4 and 5 must touch
    no plane) and ~5% of slots carrying kinds outside {insert, remove,
    annotate}, which must leave the doc untouched — the edges of the
    kernel's integer handling."""
    planes, nxt = conflict_storm(n_docs, n_ops, seed=seed,
                                 start_seq=start_seq, n_keys=6, warmup=8)
    rng = np.random.default_rng(seed + 1000)
    shape = (n_docs, n_ops)
    planes["client"] = rng.choice(
        [-1, 0, MAX_CLIENTS - 2, MAX_CLIENTS - 1], size=shape).astype(np.int32)
    bad = rng.random(shape) < 0.05
    planes["kind"] = np.where(bad, rng.choice([-3, 3, 12, 99], size=shape),
                              planes["kind"]).astype(np.int32)
    return planes, nxt


#: the interval docs' base text, insert payload table and annotate props
#: (``tests/test_interval_columnar.py``'s)
IV_BASE_TEXT = "the quick brown fox jumps over the dazed dog"
IV_TEXTS = ["XY"]
IV_PROPS = [{"bold": True}, {"bold": False}]


def interval_wave(rng: np.random.Generator, lengths: np.ndarray, n_ops: int,
                  w: int, inserts_only=None) -> dict:
    """Wave ``w`` of ``tests/test_interval_columnar.py``'s rich-text mix for
    one writer a doc, vectorised over docs: each op an annotate of 2 chars
    (50 %, when the doc has 6+ chars), an insert of ``IV_TEXTS[0]`` (30 %,
    or when shorter than 16) or a remove of 2 (20 %). ``lengths`` (D,)
    holds each doc's visible length and is updated. Rows in
    ``inserts_only`` (a (D,) mask) take inserts only. ClientSeqs run
    2 + w·O .. 1 + (w+1)·O and every ref is pinned at the wave's first, so
    the window floor crosses the previous wave's tombstones at the wave's
    first op. Returns ``ingest_planes`` keywords (client 1)."""
    D, O = len(lengths), n_ops
    kind = np.zeros((D, O), np.int32)
    a0 = np.zeros((D, O), np.int32)
    a1 = np.zeros((D, O), np.int32)
    tidx = np.zeros((D, O), np.int32)
    for c in range(O):
        roll = rng.random(D)
        ann = (roll < 0.5) & (lengths >= 6)
        ins = ~ann & ((roll < 0.8) | (lengths < 16))
        if inserts_only is not None:
            ann &= ~inserts_only
            ins |= inserts_only
        rem = ~ann & ~ins
        pick = rng.random(D)
        kind[:, c] = np.where(ann, int(OpKind.STR_ANNOTATE),
                              np.where(ins, int(OpKind.STR_INSERT),
                                       int(OpKind.STR_REMOVE)))
        start = np.where(ann, pick * (lengths - 4),
                         np.where(ins, pick * (lengths + 1),
                                  pick * (lengths - 3))).astype(np.int32)
        a0[:, c] = start
        a1[:, c] = np.where(ins, 2, start + 2)
        tidx[:, c] = np.where(ann, rng.integers(0, 2, D), 0)
        lengths += np.where(ins, 2, np.where(rem, -2, 0))
    cseq = np.broadcast_to(np.arange(2 + w * O, 2 + (w + 1) * O,
                                     dtype=np.int32), (D, O))
    return dict(client=np.ones((D, O), np.int32), client_seq=cseq,
                ref_seq=np.full((D, O), 2 + w * O, np.int32), kind=kind,
                a0=a0, a1=a1, texts=IV_TEXTS, tidx=tidx, props=IV_PROPS)


# ------------------------------------------------------------ SharedMap

#: config #2's op mix, set : delete : clear = 8 : 2 : 1
MAP_MIX = [int(OpKind.MAP_SET)] * 8 + [int(OpKind.MAP_DELETE)] * 2 \
    + [int(OpKind.MAP_CLEAR)]


def map_raw_batches(n_docs: int, n_keys: int, n_ops: int, n_batches: int,
                    seed: int = 0) -> list:
    """BASELINE config #2's raw kernel batches
    (``benches/config2_map_storm.py:33-42``): a list of dense (D, O) int32
    (kind, key slot, value handle, seq) planes, seqs round-robin across
    docs and chained from 1."""
    rng = np.random.default_rng(seed)
    D, O = n_docs, n_ops
    out, seq0 = [], 1
    for _ in range(n_batches):
        kind = rng.choice(MAP_MIX, size=(D, O)).astype(np.int32)
        a0 = rng.integers(0, n_keys, size=(D, O), dtype=np.int32)
        a1 = rng.integers(1, 1 << 20, size=(D, O), dtype=np.int32)
        seq = (seq0 + np.arange(O, dtype=np.int32)[None, :] * D
               + np.arange(D, dtype=np.int32)[:, None]).astype(np.int32)
        seq0 += D * O
        out.append((kind, a0, a1, seq))
    return out


def map_serving_batch(n_docs: int, n_ops: int, b: int, n_keys: int = 64,
                      n_values: int = 64):
    """Columnar serving batch ``b`` (seed b) of config #2
    (``config2_map_storm.py:77-85``): (kind, kidx, keys, vidx, values) for
    ``MapServingEngine.ingest_planes``; the clientSeqs of batch b are
    b·O+1 .. (b+1)·O."""
    rng = np.random.default_rng(b)
    shape = (n_docs, n_ops)
    kind = rng.choice(MAP_MIX, size=shape).astype(np.int32)
    kidx = rng.integers(0, n_keys, size=shape, dtype=np.int32)
    vidx = rng.integers(0, n_values, size=shape, dtype=np.int32)
    keys = [f"k{j}" for j in range(n_keys)]
    values = [f"v{j}" for j in range(n_values)]
    return kind, kidx, keys, vidx, values


# ---------------------------------------------------- SharedMatrix cells

def cell_storm(n_rows: int, n_cols: int, n_ops: int, n_batches: int,
               seed: int = 0) -> list:
    """BASELINE config #3's set-cell storm
    (``benches/config3_matrix_storm.py:30-36``): a list of (O,) int32
    (cell key = row·cols + col, seq, value) batches, seqs chained from 1."""
    rng = np.random.default_rng(seed)
    O = n_ops
    out = []
    for b in range(n_batches):
        key = (rng.integers(0, n_rows, O) * n_cols
               + rng.integers(0, n_cols, O)).astype(np.int32)
        seq = (b * O + np.arange(1, O + 1)).astype(np.int32)
        val = rng.integers(1, 1 << 30, O, dtype=np.int32)
        out.append((key, seq, val))
    return out


def cell_records(seed: int, n_ops: int, n_rows: int = 16, n_cols: int = 16,
                 n_values: int = 40, seq0: int = 1) -> list:
    """A small set-cell record stream, (row, col, value, seq) with seq
    ascending: many writes per cell, for the LWW / FWW / overflow cases."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n_rows, n_ops).tolist()
    c = rng.integers(0, n_cols, n_ops).tolist()
    v = rng.integers(0, n_values, n_ops).tolist()
    return [(r[i], c[i], f"v{v[i]}", seq0 + i) for i in range(n_ops)]


def axis_window(rng, lengths, n_ops: int, start_seq: int = 1,
                n_clients: int = 4, max_lag: int = 16,
                mix=(0.4, 0.2, 0.3, 0.1)) -> Tuple[dict, int]:
    """One dense (D, O) window of permutation-axis ops, D = len(lengths):
    insert / remove / resolve / NOOP in proportions ``mix``, from
    ``n_clients`` clients whose ref_seq lags the op's seq by up to
    ``max_lag``; a fifth of the resolves are latest-view reads (client -1,
    ref_seq 1 << 30). Positions are drawn from [0, L + 2], L the row's
    visible length ``lengths`` plus half the window's earlier insert
    counts (some inserts are dropped), so some inserts fall past the
    visible length at their perspective (dropped) and some resolves out of
    range. Inserts take 1-4 slots of a random run handle; removes span 1-4
    positions. Seqs run per row from ``start_seq``. Returns (planes keyed
    by OP_FIELDS, next seq)."""
    D, O = len(lengths), n_ops
    kinds = np.array([OpKind.STR_INSERT, OpKind.STR_REMOVE,
                      OpKind.AXIS_RESOLVE, OpKind.NOOP], np.int32)
    kind = rng.choice(kinds, size=(D, O), p=mix).astype(np.int32)
    count = rng.integers(1, 5, size=(D, O)).astype(np.int32)
    grown = np.cumsum(np.where(kind == OpKind.STR_INSERT, count, 0), axis=1)
    est = np.asarray(lengths, np.int64)[:, None] + (grown - count) // 2
    a0 = (rng.random((D, O)) * (est + 3)).astype(np.int32)
    a1 = np.where(kind == OpKind.STR_REMOVE, a0 + count, count)
    a2 = rng.integers(1, 1 << 16, size=(D, O)).astype(np.int32)
    seq = np.broadcast_to(np.arange(start_seq, start_seq + O, dtype=np.int32),
                          (D, O)).copy()
    client = rng.integers(0, n_clients, size=(D, O)).astype(np.int32)
    ref_seq = np.maximum(seq - rng.integers(0, max_lag + 1, size=(D, O)),
                         0).astype(np.int32)
    read = (kind == OpKind.AXIS_RESOLVE) & (rng.random((D, O)) < 0.2)
    client[read] = -1
    ref_seq[read] = 1 << 30
    planes = {"kind": kind, "a0": a0, "a1": a1.astype(np.int32), "a2": a2,
              "seq": seq, "client": client, "ref_seq": ref_seq}
    return planes, start_seq + O


# ------------------------------------------------------------- SharedTree

#: record kinds of ``ops.tree_kernel.TreeOpKind`` (kept as ints here)
_T_NOOP, _T_INS_BEGIN, _T_GUARD_ABSENT, _T_TXN_BEGIN, _T_GUARD_EXISTS = \
    0, 1, 2, 3, 4
_T_INSERT, _T_REMOVE, _T_MOVE, _T_SET = 5, 6, 7, 8
_T_TXN_BEGIN_EXISTS = 13
# kind draw weights: NOOP holes, the flag records, the four edits and
# their solo forms
_T_KINDS = np.arange(14)
_T_WEIGHTS = np.array([6, 3, 4, 3, 4, 18, 5, 6, 6, 14, 4, 4, 6, 4], float)


def tree_record_storm(n_docs: int, n_ops: int, seed: int = 0,
                      capacity: int = 128, start_seq: int = 1) -> np.ndarray:
    """Dense (9, D, O) int32 tree record planes (``apply_tree_planes``
    order: kind, node, parent, after, field, value, type_, meta, seq) that
    exercise every record kind 1-13 and NOOP holes: guards that fail,
    anchors that are dead or under another parent, nested inserts whose
    parent came from the previous record (same op, or another seq), removes
    of inner nodes, moves under the node's own descendant, solo kinds. Ids
    are handles 2 .. ~1.5 N (1 is the root), so inserts collide and
    lookups miss; every 8th doc inserts only fresh ids and outgrows a
    capacity-N doc in a few batches. Per doc, a record continues the
    previous record's op (same seq) 40% of the time, so op seqs are
    consecutive per doc from ``start_seq``: the same records ride the wire
    with base = start_seq."""
    rng = np.random.default_rng(seed)
    D, O = n_docs, n_ops
    space = max(capacity * 3 // 2, 4)
    kind = rng.choice(_T_KINDS, size=(D, O),
                      p=_T_WEIGHTS / _T_WEIGHTS.sum()).astype(np.int32)
    node = rng.integers(2, space + 2, size=(D, O))
    parent = np.where(rng.random((D, O)) < 0.3, 1,
                      rng.integers(2, space + 2, size=(D, O)))
    after = np.where(rng.random((D, O)) < 0.3, 0,
                     rng.integers(2, space + 2, size=(D, O)))
    field = rng.integers(1, 4, size=(D, O))
    value = rng.integers(0, 50, size=(D, O))
    type_ = rng.integers(0, 4, size=(D, O))
    meta = np.zeros((D, O), np.int64)
    is_ins = (kind == _T_INSERT) | (kind == _T_INSERT + 4)
    nested = is_ins & (rng.random((D, O)) < 0.35)
    meta[nested] = 1
    prev_node = np.roll(node, 1, axis=1)
    prev_prev = np.roll(node, 2, axis=1)
    # a nested insert hangs off the previous record's node; a move under
    # the previous record's node whose parent is the one before (a
    # cycle when that chain was inserted)
    parent = np.where(nested & (rng.random((D, O)) < 0.75), prev_node,
                      parent)
    is_mov = (kind == _T_MOVE) | (kind == _T_MOVE + 4)
    cyc = is_mov & (rng.random((D, O)) < 0.35)
    node = np.where(cyc, prev_prev, node)
    parent = np.where(cyc, prev_node, parent)
    # growth docs: fresh ids only, inserts at the root or under the
    # previous record's (fresh) node
    grow = (np.arange(D) % 8 == 0)[:, None] & np.ones((1, O), bool)
    fresh = (2 + space + seed * O + np.arange(O))[None, :] + \
        np.zeros((D, 1), np.int64)
    kind = np.where(grow, np.where(rng.random((D, O)) < 0.5, _T_INSERT + 4,
                                   _T_INSERT), kind)
    node = np.where(grow, fresh, node)
    parent = np.where(grow, np.where(rng.random((D, O)) < 0.5, 1,
                                     np.roll(fresh, 1, axis=1)), parent)
    meta = np.where(grow, 0, meta)
    # per-doc op seqs: a record continues its predecessor's op 40% of the
    # time; NOOP holes carry no op
    real = kind != _T_NOOP
    starts = real & ~((rng.random((D, O)) < 0.4) &
                      np.roll(real, 1, axis=1))
    starts[:, 0] = real[:, 0]
    # a doc's first real record always opens an op
    first_real = np.argmax(real, axis=1)
    starts[np.arange(D), first_real] |= real[np.arange(D), first_real]
    seq = np.where(real, start_seq + np.cumsum(starts, axis=1) - 1, 0)
    planes = np.stack([kind, node, parent, after, field, value, type_, meta,
                       seq]).astype(np.int32)
    planes[1:, ~real] = 0
    return planes


def tree_path_mix(n_docs: int, n_ops: int, seed: int = 0,
                  capacity: int = 128, start_seq: int = 1) -> np.ndarray:
    """A ``tree_record_storm`` batch whose docs take the record scan's two
    paths side by side, by doc index mod 5: 0 keeps every record (removes
    and moves: the staged path), 1 drops its removes and moves to NOOP
    (many inserts: the staged path too), 2 also keeps no more than its
    first 4 inserts (the sparse path, inserts, setValues and guards), 3
    keeps only its setValues, 4 is all NOOP."""
    p = tree_record_storm(n_docs, n_ops, seed=seed, capacity=capacity,
                          start_seq=start_seq)
    kind = p[0]
    cls = (np.arange(n_docs) % 5)[:, None]
    structural = np.isin(kind, (6, 7, 10, 11))
    inserts = np.isin(kind, (5, 9))
    late = inserts & (np.cumsum(inserts, axis=1) > 4)
    sets = np.isin(kind, (8, 12))
    drop = (((cls == 1) | (cls == 2)) & structural) | ((cls == 2) & late) \
        | ((cls == 3) & ~sets) | (cls == 4)
    p[:, drop] = 0
    return p


def tree_storm_flat(planes: np.ndarray):
    """The non-NOOP records of ``tree_record_storm`` planes in doc-major,
    column order, as the wire packer takes them: (recs (R, 8) int32 in
    kind, node, parent, after, field, value, type_, meta order, rec_op
    (R,) a global op index, rows (R,) the doc row)."""
    kind = planes[0]
    D, O = kind.shape
    real = kind != _T_NOOP
    rows, cols = np.nonzero(real)          # row-major: doc-major order
    recs = planes[:8, rows, cols].T.astype(np.int32)
    seq = planes[8, rows, cols].astype(np.int64)
    rec_op = rows.astype(np.int64) * (1 << 32) + seq
    # rec_op only needs to change exactly where an op starts
    change = np.r_[True, rec_op[1:] != rec_op[:-1]]
    return recs, np.cumsum(change) - 1, rows.astype(np.int64)


def tree_op_storm(doc_ids, n_ops: int, seed: int = 0, pools=None):
    """``n_ops`` SharedTree op dicts per doc (doc-interleaved; returns a
    list of (doc_id, op)): inserts (one node, several top-level nodes, or a
    node with nested children), removes, moves, setValues and
    transactions with ``nodeExists`` constraints, over a per-doc pool of
    the ids it inserted. Removals are not tracked, so some ops target dead
    nodes and degrade or drop. ``pools`` ({doc: [ids]}) carries the pools
    across calls."""
    rng = np.random.default_rng(seed)
    pools = pools if pools is not None else {}
    counter = {d: len(pools.get(d, ())) for d in doc_ids}
    out = []

    def fresh(d):
        counter[d] += 1
        return f"{d}/s{seed}n{counter[d]}"

    def pick(d):
        pool = pools.setdefault(d, [])
        return "root" if not pool or rng.random() < 0.2 else \
            pool[int(rng.integers(len(pool)))]

    def spec(d, depth):
        nid = fresh(d)
        pools.setdefault(d, []).append(nid)
        s = {"id": nid, "type": ["item", None][int(rng.integers(2))],
             "value": int(rng.integers(100))}
        if depth < 2 and rng.random() < 0.3:
            s["children"] = {"sub": [spec(d, depth + 1)
                                     for _ in range(int(rng.integers(1,
                                                                     3)))]}
        return s

    def insert(d):
        parent = pick(d)
        after = pick(d) if rng.random() < 0.5 else None
        n = 1 if rng.random() < 0.7 else int(rng.integers(2, 4))
        return {"op": "insert", "parent": parent,
                "field": ["kids", "meta"][int(rng.integers(2))],
                "after": None if after == "root" else after,
                "nodes": [spec(d, 0) for _ in range(n)]}

    def edit(d):
        roll = rng.random()
        if roll < 0.4:
            return insert(d)
        if roll < 0.55:
            return {"op": "remove", "id": pick(d)}
        if roll < 0.75:
            return {"op": "move", "id": pick(d), "parent": pick(d),
                    "field": "kids", "after": None}
        return {"op": "setValue", "id": pick(d),
                "value": int(rng.integers(1000))}

    for _ in range(n_ops):
        for d in doc_ids:
            if rng.random() < 0.2:
                op = {"op": "transaction",
                      "edits": [edit(d) for _ in range(int(rng.integers(
                          1, 4)))]}
                if rng.random() < 0.7:
                    op["constraints"] = [{"nodeExists": pick(d)}
                                         for _ in range(int(rng.integers(
                                             1, 3)))]
                out.append((d, op))
            else:
                out.append((d, edit(d)))
    return out


def profile_tree_waves(doc_ids, wave: int):
    """The waves of ``benches/profile_tree.py``: wave 0 inserts node 0 of
    every doc at its root; wave w > 0 is a transaction guarded by
    ``nodeExists(node w-1)`` that inserts node w after node w-1 and sets
    node w-1's value to 10 w. Returns (doc ids, ops)."""
    ids, ops = [], []
    for d in doc_ids:
        ids.append(d)
        if wave == 0:
            ops.append({"op": "insert", "parent": "root", "field": "kids",
                        "after": None,
                        "nodes": [{"id": f"{d}-n0", "type": "item",
                                   "value": 0}]})
        else:
            prev = f"{d}-n{wave - 1}"
            ops.append({"op": "transaction",
                        "constraints": [{"nodeExists": prev}],
                        "edits": [
                            {"op": "insert", "parent": "root",
                             "field": "kids", "after": prev,
                             "nodes": [{"id": f"{d}-n{wave}",
                                        "type": "item", "value": wave}]},
                            {"op": "setValue", "id": prev,
                             "value": wave * 10}]})
    return ids, ops
