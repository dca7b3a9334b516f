"""The port's columnar front door over a CPU engine, against the JAX
package: real client sockets aggregate into ``ingest_planes`` windows.

Mirrors ``tests/test_columnar_ingress.py`` (composition with log-oracle
parity, mixed inserts and removes on one doc, whole-frame rejects, bad
rows and CRCs, the pipelined door against the serial one), then:

- the same seeded frames (a ``B`` client and an ``R`` client) through the
  JAX door on the JAX engine and the port's door on a CPU engine, at
  pipeline depth 0 and 2: identical acks (doc, cseq → seq) and texts;
- one client that awaits each frame's acks: the two engines' planes and
  payload tables bit-identical (the parity contract of
  ``tests/test_pallas_kernel.py``);
- the door's engine equal to a second engine fed its windows directly
  through ``ingest_planes`` (the card check of ``chip_smoke.py``'s door
  phase);
- admission: throttled ops resubmitted with the same cseqs are acked
  exactly once (``tests/test_overload.py``'s columnar case);
- the drain pass's idle-age clock and the stage-latency timeline.

Every blocking receive has a timeout; assertions wait for the acks they
read. Tolerance: exact."""

import random
import time

import numpy as np
import pytest

from fluidframework_tpu.models.shared_string import SharedString
from fluidframework_tpu.server.columnar_ingress import (
    ColumnarAlfred as JDoor,
)
from fluidframework_tpu.server.serving import StringServingEngine as JEngine
from fluidframework_tpu_torch.server.admission import AdmissionController
from fluidframework_tpu_torch.server.columnar_ingress import (
    ColumnarAlfred, ColumnarClient, encode_frame,
)
from fluidframework_tpu_torch.server.opsd import STAGES, latency_breakdown
from fluidframework_tpu_torch.server.serving import StringServingEngine
from fluidframework_tpu_torch.testing import door_storm as ds
from fluidframework_tpu_torch.utils import capacity

TIMEOUT = 60.0


def _engine(n_docs=32, cls=StringServingEngine, **kw):
    kw = dict(n_docs=n_docs, capacity=256, batch_window=10 ** 9,
              sequencer="native", **kw)
    return cls(**kw, device="cpu") if cls is StringServingEngine \
        else cls(**kw)


def _mk(n_docs=32, window_min_rows=8, window_ms=5.0, **kw):
    eng = _engine(n_docs)
    srv = ColumnarAlfred(eng, window_min_rows=window_min_rows,
                         window_ms=window_ms, **kw).start_in_thread()
    return eng, srv


def _client(srv):
    return ColumnarClient("127.0.0.1", srv.port, timeout=TIMEOUT)


def _oracle_text(eng, doc):
    oracle = SharedString(doc, 999)
    for m in eng._docs_log_messages([doc])[doc]:
        oracle.process_core(m, local=False)
    return oracle.get_text()


def test_sockets_compose_into_columnar_windows():
    eng, srv = _mk()
    try:
        n_clients, docs_per, waves = 3, 4, 6
        clients = []
        for c in range(n_clients):
            cl = _client(srv)
            docs = [f"c{c}-d{j}" for j in range(docs_per)]
            cl.join(docs)
            clients.append((cl, docs))
        for w in range(waves):
            for cl, docs in clients:
                rows = [cl.rows[d] for d in docs]
                cl.send_ops([f"t{w}."], ds.records(rows, 0, 0, 0, 0, w + 1))
        for cl, docs in clients:
            acked = 0
            while acked < docs_per * waves:
                resp = cl.recv_json()
                assert resp["t"] == "acks", resp
                for cs, seq in resp["acks"]:
                    assert seq > 0, (cs, seq)
                    acked += 1
        assert srv.ops_ingested == n_clients * docs_per * waves
        # aggregation happened: far fewer windows than ops
        assert srv.windows_flushed <= waves * n_clients
        for cl, docs in clients[:2]:
            d = docs[1]
            assert eng.read_text(d) == _oracle_text(eng, d), d
        for cl, _ in clients:
            cl.close()
    finally:
        srv.stop()


def test_mixed_inserts_and_removes_share_one_doc():
    eng, srv = _mk(window_min_rows=1, window_ms=2.0)
    try:
        a, b = _client(srv), _client(srv)
        a.join(["shared"])
        b.join(["shared"])
        row = a.rows["shared"]
        a.send_ops(["hello"], ds.records([row], 0, 0, 0, 0, 1))
        s1 = a.recv_json()["acks"][0][1]
        assert s1 > 0
        # b inserts at pos 2 AT THE PERSPECTIVE of a's op (ref = its seq)
        b.send_ops(["XY"], ds.records([row], 0, 2, 0, 0, 1, s1))
        s2 = b.recv_json()["acks"][0][1]
        assert s2 > 0
        a.send_ops([], ds.records([row], 1, 0, 1, 0, 2, s2))
        assert a.recv_json()["acks"][0][1] > 0
        assert eng.read_text("shared") == _oracle_text(eng, "shared") \
            == "eXYllo"
        a.close()
        b.close()
    finally:
        srv.stop()


def test_malformed_op_frames_rejected_whole():
    """tidx out of table range / ragged record sections reject the WHOLE
    frame with an error frame (no half-enqueued batch)."""
    eng, srv = _mk()
    try:
        cl = _client(srv)
        cl.join(["d0"])
        row = cl.rows["d0"]
        cl.send_ops(["only-one"], ds.records([row, row], 0, 0, 0, [0, 7],
                                             [1, 2]))
        resp = cl.recv_json()
        assert resp["t"] == "error" and "tidx" in resp["message"]
        cl.close()
        c2 = _client(srv)
        c2.join(["d1"])
        c2.sock.sendall(encode_frame(b"B", bytes([0]) + b"\x01" * 17))
        resp = c2.recv_json()
        assert resp["t"] == "error" and "record" in resp["message"]
        c2.close()
        assert srv.ops_ingested == 0 and srv._pending_ops == 0
    finally:
        srv.stop()


def test_bad_row_and_bad_crc_handling():
    eng, srv = _mk()
    try:
        cl = _client(srv)
        cl.join(["d0"])
        cl.send_ops(["x"], ds.records([999], 0, 0, 0, 0, 1))
        resp = cl.recv_json()
        assert resp["t"] == "error" and "out of range" in resp["message"]
        cl.close()
        c2 = _client(srv)
        c2.join(["d1"])
        row = c2.rows["d1"]
        c2.send_ops(["ok"], ds.records([row], 0, 0, 0, 0, 1))
        while True:
            resp = c2.recv_json()
            if resp["t"] == "acks":
                break
        assert resp["acks"][0][1] > 0
        c2.close()
    finally:
        srv.stop()


def test_row_without_a_document_errors_and_the_door_keeps_serving():
    """An op on a row inside the engine that no join allocated is answered
    with an error frame and dropped; the rest of its frame stands and the
    door keeps serving (the JAX door fails its pipeline here: ROADMAP
    C11)."""
    eng, srv = _mk(n_docs=8)
    try:
        cl = _client(srv)
        row = cl.join(["d0"])["d0"]
        cl.send_ops(["x"], ds.records([5, row], 0, 0, 0, 0, [1, 1]))
        got = [cl.recv_json(), cl.recv_json()]
        assert {g["t"] for g in got} == {"error", "acks"}
        err = next(g for g in got if g["t"] == "error")
        assert err["message"] == "row 5 has no document"
        assert next(g for g in got if g["t"] == "acks")["rows"] == [row]
        c2 = _client(srv)
        row2 = c2.join(["d1"])["d1"]
        c2.send_ops(["y"], ds.records([row2], 0, 0, 0, 0, 1))
        assert c2.recv_json()["acks"][0][1] > 0
        assert eng.read_text("d0") == "x" and eng.read_text("d1") == "y"
        cl.close()
        c2.close()
    finally:
        srv.stop()


def test_pipelined_front_door_parity_and_stats():
    """The depth-3 pipelined door gives the same texts as the serial
    (depth 0) door on the same stream, through the executor."""
    def _run_stream(pipeline_depth):
        eng = _engine()
        srv = ColumnarAlfred(eng, window_min_rows=4, window_ms=1.0,
                             pipeline_depth=pipeline_depth
                             ).start_in_thread()
        texts = {}
        try:
            n_clients, docs_per, waves = 2, 3, 12
            clients = []
            for c in range(n_clients):
                cl = _client(srv)
                docs = [f"c{c}-d{j}" for j in range(docs_per)]
                cl.join(docs)
                clients.append((cl, docs))
            for w in range(waves):
                for ci, (cl, docs) in enumerate(clients):
                    rows = [cl.rows[d] for d in docs]
                    cl.send_ops([f"w{w}c{ci}."],
                                ds.records(rows, 0, 0, 0, 0, w + 1))
            for cl, docs in clients:
                acked = 0
                while acked < docs_per * waves:
                    resp = cl.recv_json()
                    assert resp["t"] == "acks", resp
                    for _cs, seq in resp["acks"]:
                        assert seq > 0
                        acked += 1
            stats = srv.pipeline_stats()
            windows = srv.windows_flushed
            for cl, docs in clients:
                for d in docs:
                    texts[d] = eng.read_text(d)
                cl.close()
        finally:
            srv.stop()
        return texts, stats, windows

    serial_texts, serial_stats, _ = _run_stream(0)
    pipe_texts, pipe_stats, pipe_windows = _run_stream(3)
    assert serial_stats is None           # depth 0 = no executor
    assert pipe_texts == serial_texts
    assert pipe_stats["depth"] == 3
    assert pipe_stats["waves"] == pipe_windows > 0
    assert pipe_stats["max_inflight"] >= 1


# ------------------------------------------------- against the JAX door

N_DOCS, N_WAVES = 6, 5


def _storm(door, n_waves=N_WAVES, lockstep=False, rich_only=False):
    """A ``B`` client and an ``R`` client (or one lockstep ``R`` client)
    of N_DOCS docs each against ``door``; returns the clients and the
    rich plan."""
    plan = ds.RichPlan(N_DOCS, seed=7)
    clients = []
    if not rich_only:
        clients.append(ds.StormClient(door.port,
                                      [f"b{i}" for i in range(N_DOCS)],
                                      n_waves, ds.b_wave, timeout=TIMEOUT))
    clients.append(ds.StormClient(door.port,
                                  [f"r{i}" for i in range(N_DOCS)],
                                  n_waves, plan.wave, lockstep=lockstep,
                                  timeout=TIMEOUT))
    ds.run_clients(clients, timeout=TIMEOUT)
    return clients, plan


def _acks_by_doc(clients):
    out = {}
    for c in clients:
        doc_of = {r: d for d, r in c.rows.items()}
        out.update({(doc_of[r], cs): s for (r, cs), s in c.acks.items()})
    return out


@pytest.mark.parametrize("depth", [0, 2])
def test_same_frames_same_acks_and_text_as_jax_door(depth):
    results = []
    for door_cls, eng in ((JDoor, _engine(2 * N_DOCS, JEngine)),
                          (ColumnarAlfred, _engine(2 * N_DOCS))):
        door = door_cls(eng, window_min_rows=4, window_ms=1.0,
                        pipeline_depth=depth).start_in_thread()
        try:
            clients, plan = _storm(door)
        finally:
            door.stop()
        texts = {d: eng.read_text(d) for c in clients for d in c.docs}
        results.append((_acks_by_doc(clients), texts))
        assert len(results[-1][0]) == 2 * N_DOCS * N_WAVES
        for i in range(N_DOCS):
            assert texts[f"b{i}"] == ds.b_text(N_WAVES)
            assert texts[f"r{i}"] == plan.shadow[i]
    assert results[0] == results[1]


def test_single_client_planes_bit_identical_to_jax():
    """One client awaiting each frame's acks: every frame is one drain
    pass, so both doors carve the same windows and the engines' planes,
    counts and payload / props tables are bit-identical."""
    snaps = []
    for door_cls, eng in ((JDoor, _engine(N_DOCS, JEngine)),
                          (ColumnarAlfred, _engine(N_DOCS))):
        door = door_cls(eng, window_min_rows=4, window_ms=1.0,
                        pipeline_depth=2).start_in_thread()
        try:
            clients, plan = _storm(door, n_waves=8, lockstep=True,
                                   rich_only=True)
        finally:
            door.stop()
        assert [eng.read_text(f"r{i}") for i in range(N_DOCS)] == \
            plan.shadow
        snaps.append((eng.store.snapshot(), eng.store.digests(),
                      door.windows_flushed))
    (sj, dj, wj), (st, dt, wt) = snaps
    assert wj == wt == 8 * 2   # 6 rows a frame, windows of 4
    for k, v in st["planes"].items():
        assert np.array_equal(np.asarray(sj["planes"][k]), v), k
    for k in ("count", "overflow"):
        assert np.array_equal(sj[k], st[k]), k
    for k in ("payloads", "client_idx", "prop_planes", "prop_values",
              "has_props"):
        assert sj[k] == st[k], k
    assert np.array_equal(dj, dt)


def test_door_engine_equals_direct_replay():
    """The door's engine equals a second engine fed the windows the door
    built, directly through ``ingest_planes``."""
    eng = _engine(2 * N_DOCS)
    seen = ds.record_windows(eng)
    door = ColumnarAlfred(eng, window_min_rows=4, window_ms=1.0,
                          pipeline_depth=3).start_in_thread()
    try:
        _storm(door)
    finally:
        door.stop()
    assert len(seen) == door.windows_flushed
    direct = _engine(2 * N_DOCS)
    ds.seat_like(direct, eng)
    assert ds.replay(direct, seen) == 0
    assert ds.state_diff(eng, direct) == []


# ------------------------------------------------------------ admission

def test_throttled_ops_resubmit_exactly_once():
    """A tenant budget of 80 ops/s (burst 8) sheds most of a 30-op burst
    on one doc; the client resubmits the throttled cseqs after the hint
    and every op is acked exactly once, in order."""
    adm = AdmissionController()
    adm.register_tenant("t", 80.0, burst=8.0)
    eng, srv = _mk(n_docs=4, window_min_rows=1, window_ms=2.0,
                   admission=adm)
    try:
        n = 30
        cl = ds.StormClient(srv.port, ["d0"], n, ds.b_wave, tenant="t",
                            timeout=TIMEOUT)
        ds.run_clients([cl], timeout=TIMEOUT)
        assert cl.throttled > 0 and srv.throttled_ops == cl.throttled
        assert sorted(cs for _, cs in cl.acks) == list(range(1, n + 1))
        assert eng.read_text("d0") == ds.b_text(n)
        snap = adm.snapshot()
        assert snap["tenants"]["t"]["admitted"] == n
        assert snap["tenants"]["t"]["shed"] == cl.throttled
    finally:
        srv.stop()


# ------------------------------------------ idle ages, latency timeline

def test_columnar_zipf_storm_cold_docs_surface_in_census():
    """Cold docs written once, then abandoned while hot docs storm: the
    drain pass's idle tracker ranks the cold rows coldest, stamped before
    the storm, and the census resolves them to doc ids."""
    eng, srv = _mk(window_min_rows=1, window_ms=2.0)
    try:
        rng = random.Random(7)
        cold = [f"cold-{i}" for i in range(4)]
        hot = [f"hot-{i}" for i in range(8)]
        cl = _client(srv)
        rows = cl.join(cold + hot)
        cseq = {d: 0 for d in cold + hot}

        def send(docs):
            for d in docs:
                cseq[d] += 1
            cl.send_ops(["m"], ds.records([rows[d] for d in docs], 0, 0, 0,
                                          0, [cseq[d] for d in docs]))
            n = 0
            while n < len(docs):
                fr = cl.recv_json()
                assert fr["t"] == "acks", fr
                n += len(fr["acks"])

        send(cold + hot)
        t_mark = time.monotonic()
        weights = [1.0 / (i + 1) for i in range(len(hot))]
        for _ in range(6):
            send(sorted(set(rng.choices(hot, weights=weights, k=6))))
        coldest = srv.idle_ages.coldest(len(cold))
        assert {r["row"] for r in coldest} == {rows[d] for d in cold}
        assert all(r["last_touch"] <= t_mark for r in coldest)
        # this door's tracker: earlier doors of the process may still be
        # registered, and their rows idle longer
        key, = [k for k, ref in capacity.LEDGER._idle.items()
                if ref() is srv.idle_ages]
        c = capacity.LEDGER.census(top_k=1 << 20)
        resolved = {e.get("doc") for e in c["coldest"] if e["owner"] == key}
        assert set(cold) <= resolved
        assert c["idle"][key]["resident_rows"] == len(cold + hot)
        top = srv.hotdocs.top(1)[0]
        assert top[0][0].startswith("hot-") and top[0][1] == "client-1"
        cl.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("depth", [0, 2])
def test_stage_timeline_covers_every_window(depth):
    """Every window's rx → ack latency is split into the eight stages,
    whose means sum to the end-to-end mean."""
    eng = _engine(2 * N_DOCS)
    door = ColumnarAlfred(eng, window_min_rows=4, window_ms=1.0,
                          pipeline_depth=depth).start_in_thread()
    try:
        _storm(door)
    finally:
        door.stop()
    lb = latency_breakdown(door.metrics)
    assert lb["windows"] == door.windows_flushed
    assert set(lb["stages"]) == set(STAGES)
    assert all(s["count"] == door.windows_flushed
               for s in lb["stages"].values())
    assert lb["stage_sum_ms"] == pytest.approx(lb["e2e_mean_ms"],
                                               rel=1e-9, abs=1e-9)
    assert lb["e2e_p99_ms"] > 0


# ------------------------------------------------ the chip phase, small

def test_door_window_work_counts_only_rows_with_an_op():
    """``chip_smoke.door_window_work``: the op planes once, and for each
    row with a real op its live extent in and out, count / overflow and
    (compacting) its floor; idle rows cost nothing."""
    import torch

    import chip_smoke
    kind = torch.full((4, 1), chip_smoke.NOOP, dtype=torch.int32)
    kind[1, 0] = kind[3, 0] = 0
    c0 = torch.tensor([9, 2, 9, 5], dtype=torch.int32)
    c1 = torch.tensor([9, 3, 1, 6], dtype=torch.int32)
    op_bytes = 7 * kind.numel() * 4
    nbytes, n_ops = chip_smoke.door_window_work(c0, c1, kind, op_bytes,
                                                props=False, compact=True)
    assert nbytes == op_bytes + 7 * 4 * (2 + 3 + 5 + 6) + 16 * 2 + 4 * 2
    assert n_ops == (2 + 1) + (5 + 1)
    with_props, _ = chip_smoke.door_window_work(c0, c1, kind, op_bytes,
                                                props=True, compact=False)
    assert with_props == op_bytes + 11 * 4 * 16 + 16 * 2


def test_chip_door_phase_at_small_size():
    """``chip_smoke.py``'s door phase on the CPU at a small size: the
    storm and admission run pass their checks, and each B1 row carries
    its call time under ``call_ms`` (``ms`` null) and a bound from its
    launches' own work."""
    import chip_smoke
    out = chip_smoke.door_phase("cpu", "cpu", D=64, n_clients=4, waves=6,
                                window_rows=16, adm_waves=3, adm_rate=200.0,
                                adm_burst=20.0)
    assert out["max_abs_err"] == 0
    assert {r["spec"] for r in out["rows"]} == {"no-props+compact",
                                                "props+compact"}
    for r in out["rows"]:
        assert r["ms"] is None and "call_ms" in r
        assert r["bound_ms"] > 0 and r["bytes"] > 7 * 64 * 4
