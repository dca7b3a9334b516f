"""Seeded client storms for the columnar front door
(``server/columnar_ingress.py``), shared by ``chip_smoke.py``'s door
phase and the door's tests.

- :func:`b_wave` — the storm bench's ``B`` frame: one insert of
  ``"w{k}"`` at 0 a doc in wave ``k``, so a doc's text after ``n`` waves
  is ``"w{n-1}…w1w0"`` (:func:`b_text`).
- :class:`RichPlan` — ``R`` frames mixing inserts, removes of the doc's
  own earlier text and annotates with a one-key props table, with a
  shadow text a doc. The client is a doc's only writer, so its positions
  are those of its own view and the doc's text must equal the shadow.
- :class:`StormClient` — one TCP client: joins its docs, sends its
  frames (all at once, or ``lockstep``: each frame after the previous
  one's acks), resubmits throttled ops with the same cseqs after the
  door's hint, and checks that every op is acked exactly once with
  seq > 0.
- :func:`storm_engine`, :func:`open_door` and :func:`storm` — the door
  storm of ``chip_smoke.py``'s door and readplane phases (and of
  ``testing/door_drain_split.py``): config #4's engine shape, the storm
  bench's door settings (``benches/columnar_ingress_storm.py``: windows
  of 4,096 rows at 2 ms, pipeline depth 3, native decode and sequencer),
  ``B`` clients and one ``R`` client, every op, text and shadow checked;
  with ``between`` a :class:`WaveGate` holds the clients at every wave
  boundary while a hook runs.
- :func:`record_windows` / :func:`replay` — capture the windows a door
  hands its engine and feed them to a second engine directly through
  ``ingest_planes``; :func:`state_diff` compares the two engines' planes,
  payload tables and digests (``ranked``: an engine that replayed the
  log op by op against one fed columnar windows).
"""

from __future__ import annotations

import heapq
import json
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..server.columnar_ingress import (
    _OP_DTYPE, ColumnarAlfred, ColumnarClient,
)
from ..ops import merge_tree as mt
from ..server.serving import StringServingEngine

#: wire kind codes (``core.protocol.ColumnarWireKind``)
INSERT, REMOVE, ANNOTATE = 0, 1, 2

#: the rich plan's props table (one key, three values)
PROPS = [{"color": c} for c in ("red", "green", "blue")]

#: the storm bench's door: windows of this many rows at WINDOW_MS,
#: pipeline depth DEPTH
WINDOW_ROWS = 4096
WINDOW_MS = 2.0
DEPTH = 3
#: config #4's serving capacity (slots a doc)
CAPACITY = 512
#: seconds a storm's clients may take
TIMEOUT = 300.0


def records(rows, kind, a0, a1, tidx, cseq, ref=0) -> np.ndarray:
    """``_OP_DTYPE`` records from equal-length (or scalar) columns."""
    rows = np.asarray(rows)
    ops = np.zeros(rows.size, _OP_DTYPE)
    ops["row"], ops["kind"] = rows, kind
    ops["a0"], ops["a1"], ops["tidx"] = a0, a1, tidx
    ops["cseq"], ops["ref"] = cseq, ref
    return ops


def b_wave(rows, k: int):
    """Wave ``k`` of a ``B`` client: (texts, ops, props=None)."""
    return [f"w{k}"], records(rows, INSERT, 0, 0, 0, k + 1), None


def b_text(n_waves: int) -> str:
    return "".join(f"w{k}" for k in reversed(range(n_waves)))


class RichPlan:
    """One op a doc a wave, seeded: an insert of one of the wave's four
    words at a random position (always on an empty doc), else a remove
    of 1-3 characters or an annotate of 1-4 with ``PROPS[i]``, each
    a third of the time."""

    def __init__(self, n_docs: int, seed: int):
        self.rng = random.Random(seed)
        self.shadow = [""] * n_docs

    def wave(self, rows, k: int):
        """Wave ``k`` over the plan's docs (``rows[i]`` is doc i's row):
        (texts, ops, props)."""
        texts = [f"r{k}{c}" for c in "abcd"]
        n = len(rows)
        kind = np.zeros(n, np.int32)
        a0 = np.zeros(n, np.int32)
        a1 = np.zeros(n, np.int32)
        tidx = np.zeros(n, np.int32)
        rng = self.rng
        for i in range(n):
            text = self.shadow[i]
            pick = rng.randrange(3) if text else 0
            if pick == 0:
                t = rng.randrange(len(texts))
                p = rng.randrange(len(text) + 1)
                kind[i], a0[i], tidx[i] = INSERT, p, t
                self.shadow[i] = text[:p] + texts[t] + text[p:]
                continue
            start = rng.randrange(len(text))
            width = rng.randint(1, 3 if pick == 1 else 4)
            end = min(len(text), start + width)
            kind[i], a0[i], a1[i] = (REMOVE if pick == 1 else ANNOTATE,
                                     start, end)
            if pick == 1:
                self.shadow[i] = text[:start] + text[end:]
            else:
                tidx[i] = rng.randrange(len(PROPS))
        return texts, records(rows, kind, a0, a1, tidx, k + 1), PROPS


class WaveGate:
    """Holds a storm's clients at every wave boundary: once every client
    has joined and has its ops of waves < k acked, ``hook(k)`` runs once
    (on the last client to arrive) before any client sends wave k, for k
    = 0 .. n_waves - 1. A hook that raises breaks the gate for every
    client; :attr:`error` keeps its exception."""

    def __init__(self, n_clients: int, hook: Callable[[int], None],
                 timeout: float = TIMEOUT):
        self.hook = hook
        self.error: Optional[BaseException] = None
        self._k = -1
        self._barrier = threading.Barrier(n_clients, action=self._action,
                                          timeout=timeout)

    def _action(self) -> None:
        self._k += 1
        try:
            self.hook(self._k)
        except BaseException as e:  # noqa: BLE001 — re-raised by storm()
            self.error = e
            raise

    def wait(self) -> None:
        self._barrier.wait()

    def abort(self) -> None:
        self._barrier.abort()


class StormClient:
    """One client of a storm. ``waves(rows, k)`` builds wave ``k``'s
    (texts, ops, props) once the join has given the docs' rows.
    ``run()`` (on a thread of its own) joins, sends every wave, resends
    throttled ops after the door's ``retry_after_ms``, and returns once
    every op is acked; ``error`` holds the first failure, ``acks`` maps
    (row, cseq) → seq. With a ``gate`` the client waits for its acks of
    every earlier wave, then at the gate, before each wave."""

    def __init__(self, port: int, docs: List[str], n_waves: int,
                 waves: Callable, host: str = "127.0.0.1",
                 tenant: Optional[str] = None, lockstep: bool = False,
                 timeout: float = 60.0, gate: Optional[WaveGate] = None):
        self.port, self.host = port, host
        self.docs, self.n_waves, self.waves = docs, n_waves, waves
        self.tenant, self.lockstep, self.timeout = tenant, lockstep, timeout
        self.gate = gate
        self.acks: Dict[Tuple[int, int], int] = {}
        self.throttled = 0
        self.rows: Dict[str, int] = {}
        self.error: Optional[BaseException] = None
        # (row, cseq) → (kind, a0, a1, text or None, prop or None) of
        # every op not acked yet: what a resend rebuilds its frame from
        self._sent: Dict[Tuple[int, int], tuple] = {}
        self._resend: List[Tuple[float, int, int]] = []   # (due, row, cseq)
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._acked_all = threading.Event()
        self._acked_frame = threading.Event()
        self._cl: Optional[ColumnarClient] = None

    def _send(self, texts, ops, props) -> None:
        with self._send_lock:
            self._cl.send_ops(texts, ops, props)

    def _remember(self, texts, ops, props) -> None:
        with self._lock:
            for r in ops:
                k = int(r["kind"])
                self._sent[(int(r["row"]), int(r["cseq"]))] = (
                    k, int(r["a0"]), int(r["a1"]),
                    texts[r["tidx"]] if k == INSERT else None,
                    props[r["tidx"]] if k == ANNOTATE else None)

    def _resend_due(self) -> None:
        """One frame of every throttled op whose hint has passed, in
        (row, cseq) order: a doc's resubmits keep their order."""
        now = time.monotonic()
        due = []
        with self._lock:
            while self._resend and self._resend[0][0] <= now:
                _, row, cseq = heapq.heappop(self._resend)
                due.append((row, cseq, self._sent[(row, cseq)]))
        if not due:
            return
        due.sort(key=lambda d: (d[0], d[1]))
        texts = sorted({op[3] for _, _, op in due if op[3] is not None})
        props = [p for p in PROPS
                 if any(op[4] == p for _, _, op in due)]
        tix = {t: i for i, t in enumerate(texts)}
        pix = {str(p): i for i, p in enumerate(props)}
        tidx = [tix[op[3]] if op[0] == INSERT else
                pix[str(op[4])] if op[0] == ANNOTATE else 0
                for _, _, op in due]
        ops = records([d[0] for d in due], [d[2][0] for d in due],
                      [d[2][1] for d in due], [d[2][2] for d in due],
                      tidx, [d[1] for d in due])
        self._send(texts, ops, props if props else None)

    def _sender(self) -> None:
        try:
            rows = np.array([self.rows[d] for d in self.docs], np.int32)
            for k in range(self.n_waves):
                if self.gate is not None:
                    while len(self.acks) < k * len(self.docs):
                        if self._acked_all.wait(0.002):
                            raise RuntimeError("storm client stopped")
                        self._resend_due()
                    self.gate.wait()
                frame = self.waves(rows, k)
                self._remember(*frame)
                self._acked_frame.clear()
                self._send(*frame)
                self._resend_due()
                if self.lockstep:
                    while not self._acked_frame.wait(0.002):
                        self._resend_due()
            while not self._acked_all.wait(0.002):
                self._resend_due()
        except BaseException as e:  # noqa: BLE001 — reported by run()
            self.error = self.error or e
            self._acked_all.set()
            if self.gate is not None:
                self.gate.abort()

    def run(self) -> None:
        try:
            self._cl = ColumnarClient(self.host, self.port,
                                      timeout=self.timeout)
            self.rows = self._cl.join(self.docs, tenant=self.tenant)
            total = len(self.docs) * self.n_waves
            sender = threading.Thread(target=self._sender, daemon=True)
            sender.start()
            while len(self.acks) < total and self.error is None:
                resp = self._cl.recv_json()
                if resp["t"] == "throttled":
                    due = time.monotonic() + resp["retry_after_ms"] / 1e3
                    with self._lock:
                        for row, cseq in zip(resp["rows"], resp["cseqs"]):
                            heapq.heappush(self._resend, (due, row, cseq))
                    self.throttled += len(resp["cseqs"])
                    continue
                if resp["t"] != "acks":
                    raise AssertionError(f"door answered {resp}")
                for (cseq, seq), row in zip(resp["acks"], resp["rows"]):
                    if seq <= 0:
                        raise AssertionError(f"nack {seq} for row {row} "
                                             f"cseq {cseq}")
                    if (row, cseq) in self.acks:
                        raise AssertionError(f"row {row} cseq {cseq} "
                                             "acked twice")
                    self.acks[(row, cseq)] = seq
                    with self._lock:
                        del self._sent[(row, cseq)]
                        if self.lockstep and not self._sent:
                            self._acked_frame.set()
            self._acked_all.set()
            sender.join(timeout=self.timeout)
            self._cl.close()
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            self.error = self.error or e
            self._acked_all.set()
            if self.gate is not None:
                self.gate.abort()


def run_clients(clients: List[StormClient], timeout: float) -> float:
    """Run the clients on threads of their own; raise the first error.
    Returns the wall seconds from the first join to the last ack."""
    threads = [threading.Thread(target=c.run, daemon=True)
               for c in clients]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    wall = time.perf_counter() - t0
    for c in clients:
        if c.error is not None:
            raise c.error
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"storm clients still running after {timeout} s")
    return wall


def record_windows(engine) -> List[tuple]:
    """Record every wave ``engine`` is given through its first stage
    (``_ingest_prepare``: the serial ``ingest_planes`` and the pipelined
    executor's pack worker alike), in sequencing order, as the
    (args, kwargs) of ``ingest_planes``."""
    seen: List[tuple] = []
    inner = engine._ingest_prepare

    def prepare(*args, prepack=False, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, prepack=prepack, **kwargs)

    engine._ingest_prepare = prepare
    return seen


def replay(engine, windows: List[tuple]) -> int:
    """Feed recorded windows to ``engine`` through ``ingest_planes``, in
    order; returns the nacked ops."""
    return sum(engine.ingest_planes(*a, **kw)["nacked"] for a, kw in windows)


def seat_like(engine, door_engine) -> None:
    """Join ``engine``'s docs as ``door_engine``'s clients did, in row
    order, so every doc gets the same row and join seq."""
    members = sorted(door_engine._members,
                     key=lambda m: door_engine._doc_rows[m[0]])
    for doc, client in members:
        engine.connect(doc, client)
        if engine.doc_row(doc) != door_engine._doc_rows[doc]:
            raise AssertionError(f"{doc}: rows differ")


def state_diff(a, b, ranked: bool = False) -> List[str]:
    """Where two string engines' flat stores differ: state planes, the
    payload table, digests (empty when identical).

    ``ranked`` compares an engine that replayed the log op by op (a log
    follower, a tail replay) with one fed columnar windows: the first
    interns a text once an op, and a property key and value at first use,
    where the second interns a window's tables whole, and each compacts
    on its own cadence. So each payload handle is compared by the (kind,
    text) it names and each property plane by its key and values (ranks
    among both engines' distinct entries), only the slots in ``[0,
    count)`` of each row are compared, and the digests are taken over the
    ranked handles."""
    if not ranked:
        out = [k for k, v in a.store.state.fields().items()
               if not torch.equal(v.cpu(), getattr(b.store.state, k).cpu())]
        if a.store._payloads != b.store._payloads:
            out.append("payloads")
        if not np.array_equal(a.store.digests(), b.store.digests()):
            out.append("digests")
        return out
    sa, sb = a.store.state, b.store.state
    count = sa.count.cpu()
    if not torch.equal(count, sb.count.cpu()):
        return ["count"]
    rank = {p: i for i, p in enumerate(sorted(
        set(a.store._payloads) | set(b.store._payloads)))}
    keys = sorted(set(a.store._prop_planes) | set(b.store._prop_planes))
    enc = [[json.dumps(v, sort_keys=True)
            for v in e.store._prop_values.export()[1:]] for e in (a, b)]
    vrank = {v: i + 1 for i, v in enumerate(sorted(set(enc[0] + enc[1])))}
    S = sa.seq.shape[1]
    live = torch.arange(S)[None, :] < count[:, None]
    ranked_states, out = [], []
    for eng, st, e in ((a, sa, enc[0]), (b, sb, enc[1])):
        ranks = torch.tensor([rank[p] for p in eng.store._payloads],
                             dtype=torch.int32)
        f = {k: v.cpu() for k, v in st.fields().items()}
        f["handle_op"] = torch.where(
            live, ranks[f["handle_op"].long().clamp(0, len(ranks) - 1)], 0)
        vmap = torch.tensor([0] + [vrank[v] for v in e], dtype=torch.int32)
        pv = f["prop_val"].long().clamp(0, len(vmap) - 1)
        planes = eng.store._prop_planes
        f["prop_val"] = torch.stack(
            [vmap[pv[:, :, planes[k]]] if k in planes
             else torch.zeros(pv.shape[:2], dtype=torch.int32)
             for k in keys], dim=2) if keys else pv[:, :, :0].int()
        ranked_states.append(mt.StringState(**f))
    fa, fb = (s.fields() for s in ranked_states)
    for k, x in fa.items():
        y = fb[k]
        if x.dim() >= 2 and x.shape[1] == S:
            m = live if x.dim() == 2 else live[:, :, None].expand_as(x)
            same = torch.equal(x[m], y[m])
        else:
            same = torch.equal(x, y)
        if not same:
            out.append(k)
    if not torch.equal(*(mt.string_state_digest(s)
                         for s in ranked_states)):
        out.append("digests")
    return out


def storm_engine(n_docs: int, device, capacity: int = CAPACITY):
    """The door storm's engine: config #4's shape (compaction every
    flush, the native sequencer) on ``device``."""
    return StringServingEngine(n_docs=n_docs, capacity=capacity,
                               batch_window=10 ** 9, compact_every=1,
                               sequencer="native", device=device)


def open_door(engine, window_rows: int = WINDOW_ROWS,
              admission=None) -> ColumnarAlfred:
    """A started door over ``engine`` at the storm bench's settings and
    the native decode."""
    return ColumnarAlfred(engine, window_min_rows=window_rows,
                          window_ms=WINDOW_MS, pipeline_depth=DEPTH,
                          decode="native",
                          admission=admission).start_in_thread()


def storm(door, n_clients: int, n_waves: int, tenant: Optional[str] = None,
          seed: int = 0, timeout: float = TIMEOUT,
          between: Optional[Callable[[int], None]] = None):
    """``n_clients`` clients of ``door.engine.n_docs // n_clients`` docs
    each send ``n_waves`` waves: the last an ``R`` client
    (:class:`RichPlan` seeded with ``seed``), the others ``B`` clients.
    ``between(k)`` (optional) runs before each wave k, once every client
    has joined and every op of the waves before it is acked
    (:class:`WaveGate`). Raises unless every op is acked once, each ``B``
    doc reads :func:`b_text` and each ``R`` doc its plan's shadow.
    Returns (clients, wall seconds)."""
    eng = door.engine
    per = eng.n_docs // n_clients
    plan = RichPlan(per, seed=seed)
    gate = WaveGate(n_clients, between, timeout) if between else None
    clients = [StormClient(
        door.port, [f"c{c}-d{j}" for j in range(per)], n_waves,
        plan.wave if c == n_clients - 1 else b_wave,
        tenant=tenant, timeout=timeout, gate=gate)
        for c in range(n_clients)]
    try:
        wall = run_clients(clients, timeout=timeout)
    except BaseException:
        if gate is not None and gate.error is not None:
            raise gate.error from None
        raise
    acked = sum(len(c.acks) for c in clients)
    if acked != n_clients * per * n_waves:
        raise AssertionError(f"door storm: {acked} ops acked")
    for c in clients[:-1]:
        for d in c.docs:
            if eng.read_text(d) != b_text(n_waves):
                raise AssertionError(f"door storm: {d} reads "
                                     f"{eng.read_text(d)!r}")
    for d, want in zip(clients[-1].docs, plan.shadow):
        if eng.read_text(d) != want:
            raise AssertionError(f"door storm: {d} differs from its "
                                 "client's shadow")
    return clients, wall
