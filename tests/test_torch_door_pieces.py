"""The pieces the port's columnar front door calls, against the JAX
package where both have them: admission (``TokenBucket``,
``AdmissionController``), ``Backoff``, the client's frame read, the
metrics registry (``Histogram``, gauges), the tracer, the idle-age
tracker and capacity ledger, and the door's stage timeline and
hot-doc sketch. Mirrors the unit cases of ``tests/test_overload.py``,
``tests/test_observability.py`` and ``tests/test_capacity.py`` that need
no engine; where both packages run the same seeded inputs, their outputs
must be identical. Tolerance: exact."""

import gc
import random
import socket

import numpy as np
import pytest

from fluidframework_tpu.server import admission as jadm
from fluidframework_tpu.server import opsd as jopsd
from fluidframework_tpu.utils import backoff as jbackoff
from fluidframework_tpu.utils import capacity as jcap
from fluidframework_tpu.utils import telemetry as jtel
from fluidframework_tpu_torch.server.admission import (
    Admission, AdmissionController, TokenBucket,
)
from fluidframework_tpu_torch.server.columnar_ingress import (
    encode_json, read_frame,
)
from fluidframework_tpu_torch.server.opsd import (
    STAGES, SpaceSaving, latency_breakdown, observe_window_timeline,
    publish_hotdoc_gauges,
)
from fluidframework_tpu_torch.server.wire import (
    BufferedSocketReader, WireError,
)
from fluidframework_tpu_torch.utils import capacity, tracing
from fluidframework_tpu_torch.utils.backoff import Backoff, retry
from fluidframework_tpu_torch.utils.telemetry import (
    Histogram, MetricsRegistry,
)

# ------------------------------------------------------------ token bucket


class TestTokenBucket:
    def test_prefix_grant_consumes_exactly_what_it_grants(self):
        tb = TokenBucket(10.0, burst=5.0)
        assert tb.grant(3, now=0.0) == 3          # burst covers it
        assert tb.grant(4, now=0.0) == 2          # prefix of the rest
        assert tb.grant(1, now=0.0) == 0          # empty
        assert tb.grant(5, now=1.0) == 5          # 10/s refill for 1s

    def test_refill_caps_at_burst(self):
        tb = TokenBucket(100.0, burst=4.0)
        tb.grant(4, now=0.0)
        assert tb.grant(100, now=10.0) == 4       # never past burst

    def test_retry_after_math_floor_and_cap(self):
        tb = TokenBucket(10.0, burst=2.0)
        assert tb.retry_after_ms(1, now=0.0) == 5.0        # have tokens
        tb.grant(2, now=0.0)
        assert tb.retry_after_ms(1, now=0.0) == pytest.approx(100.0)
        assert tb.retry_after_ms(1000, now=0.0) == 2000.0  # ceiling

    def test_rejects_nonpositive_rate(self):
        with pytest.raises(ValueError):
            TokenBucket(0.0)

    def test_seeded_grants_match_jax(self):
        rng = np.random.default_rng(3)
        t, j = TokenBucket(50.0, burst=20.0), jadm.TokenBucket(50.0, 20.0)
        now = 0.0
        for n, dt in zip(rng.integers(0, 40, 200), rng.random(200) * 0.3):
            now += float(dt)
            assert t.grant(int(n), now) == j.grant(int(n), now)
            assert t.retry_after_ms(int(n), now) == \
                j.retry_after_ms(int(n), now)


# ----------------------------------------------------- admission controller


class TestAdmissionController:
    def test_prefix_grant_and_retry_hint(self):
        adm = AdmissionController(tenants={"t": 10.0})
        adm.bind("c1", "t")
        res = adm.admit("c1", 14, now=0.0)
        assert isinstance(res, Admission)
        assert res.admitted == 10 and res.reason == "budget"
        assert res.retry_after_ms >= 5.0
        assert adm.snapshot()["tenants"]["t"] == \
            {"admitted": 10, "shed": 4}

    def test_unknown_tenant_is_unbudgeted(self):
        adm = AdmissionController()
        assert adm.admit("nobody", 1000, now=0.0).admitted == 1000
        assert adm.tenant_of("nobody") == "client-nobody"

    def test_retry_after_ms_is_pure(self):
        adm = AdmissionController(tenants={"t": 10.0})
        adm.bind("c1", "t")
        before = adm._tenant_bucket["t"].tokens
        hint = adm.retry_after_ms("c1", n=100, now=0.0)
        assert hint > 5.0
        assert adm._tenant_bucket["t"].tokens == before
        assert adm.snapshot()["shed_total"] == 0

    def test_rebind_keeps_tenant_and_register_resets_budget(self):
        adm = AdmissionController(tenants={"t": 10.0})
        assert adm.bind("c1", "t") == "t"
        assert adm.bind("c1") == "t"          # None keeps the binding
        assert adm.admit("c1", 10, now=0.0).admitted == 10
        adm.register_tenant("t", 100.0, burst=50.0)
        assert adm.admit("c1", 60, now=0.0).admitted == 50

    def test_counters_match_jax(self):
        """Both packages count the same admitted and shed ops into their
        registries for the same offers."""
        t_reg, j_reg = MetricsRegistry(), jtel.MetricsRegistry()
        t = AdmissionController(tenants={"a": 20.0}, registry=t_reg)
        j = jadm.AdmissionController(tenants={"a": 20.0},
                                     registry=j_reg)
        for adm in (t, j):
            adm.bind(1, "a")
        for step in range(30):
            t.admit(1, 7, now=step * 0.1)
            j.admit(1, "d", 7, now=step * 0.1)
        assert t_reg.counters == j_reg.counters
        assert t_reg.counters["admission_shed_budget_total"] > 0

    def test_seeded_verdicts_match_jax(self):
        """The same seeded offers get the same verdicts and totals in
        both packages (tenant buckets: the gates the port keeps)."""
        kw = dict(tenants={"a": 40.0, "b": 400.0})
        t = AdmissionController(registry=MetricsRegistry(), **kw)
        j = jadm.AdmissionController(registry=jtel.MetricsRegistry(), **kw)
        rng = random.Random(11)
        for adm in (t, j):
            adm.bind(1, "a")
            adm.bind(2, "b")
            adm.bind(3, None)
        now = 0.0
        for _ in range(400):
            now += rng.random() * 0.05
            cid, doc = rng.choice([1, 2, 3]), rng.choice(["x", "y"])
            n = rng.randint(1, 30)
            rt = t.admit(cid, n, now=now)
            rj = j.admit(cid, doc, n, now=now)
            assert (rt.admitted, rt.retry_after_ms, rt.reason) == \
                (rj.admitted, rj.retry_after_ms, rj.reason)
            assert t.retry_after_ms(cid, n, now=now) == \
                j.retry_after_ms(cid, doc, n, now=now)
        js = j.snapshot()
        assert t.snapshot() == {k: js[k] for k in
                                ("admitted_total", "shed_total", "tenants")}


# ------------------------------------------------------- backoff and wire


class TestBackoffJitter:
    def test_delay_bounds_decorrelated(self):
        bo = Backoff(base=0.01, cap=0.8, rng=random.Random(9))
        prev = bo.base
        for _ in range(200):
            d = bo.next_delay()
            assert 0.01 <= d <= 0.8
            assert d <= max(prev * 3, 0.01) + 1e-12
            prev = max(0.01, d)

    def test_seeded_schedule_replays_and_matches_jax(self):
        a = Backoff(base=0.02, cap=1.0, rng=random.Random(4))
        b = jbackoff.Backoff(base=0.02, cap=1.0, rng=random.Random(4))
        assert [a.next_delay() for _ in range(16)] == \
            [b.next_delay() for _ in range(16)]
        a.reset()
        assert a.next_delay() <= 0.06          # episode forgot growth

    def test_retry_counts_and_gives_up(self):
        reg = MetricsRegistry()
        bo = Backoff(base=0.01, cap=0.02, rng=random.Random(1),
                     metric="tries", registry=reg)
        calls, slept = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("refused")
            return "up"

        assert retry(flaky, attempts=5, backoff=bo,
                     sleep=slept.append) == "up"
        assert len(slept) == 2 and reg.counters["tries"] == 2
        with pytest.raises(OSError):
            retry(lambda: (_ for _ in ()).throw(OSError("down")),
                  attempts=3, backoff=bo, sleep=slept.append)


class TestClientFrameRead:
    def test_buffered_reader_serves_frames_and_timeouts(self):
        a, b = socket.socketpair()
        try:
            a.settimeout(5.0)
            frames = [encode_json({"t": "acks", "i": i}) for i in range(3)]
            b.sendall(b"".join(frames))
            rd = BufferedSocketReader(a, chunk=64)
            for i in range(3):
                assert read_frame(rd) == (ord("J"),
                                          frames[i][5:-4])
            a.settimeout(0.1)
            with pytest.raises(socket.timeout):
                read_frame(rd)            # nothing sent: the timeout fires
        finally:
            a.close()
            b.close()

    def test_corrupt_and_torn_frames_raise_wire_error(self):
        a, b = socket.socketpair()
        try:
            a.settimeout(5.0)
            bad = bytearray(encode_json({"t": "x"}))
            bad[6] ^= 1
            b.sendall(bytes(bad))
            with pytest.raises(WireError, match="CRC"):
                read_frame(BufferedSocketReader(a))
            frame = encode_json({"t": "y"})
            b.sendall(frame[:len(frame) // 2])
            b.close()
            with pytest.raises(WireError, match="closed"):
                read_frame(BufferedSocketReader(a))
            assert issubclass(WireError, ConnectionError)
        finally:
            a.close()


# ---------------------------------------------------------- metrics registry


def test_histogram_matches_jax_on_seeded_samples():
    rng = np.random.default_rng(2)
    vals = np.concatenate([rng.lognormal(0, 2, 500), [1e9, 0.0]])
    t, j = Histogram(), jtel.Histogram()
    for v in vals.tolist():
        t.observe(v)
        j.observe(v)
    assert t.counts == j.counts and t.n == j.n
    assert t.sum_ms == j.sum_ms and t.mean == j.mean
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert t.percentile(p) == j.percentile(p)
    assert t.overflow == j.overflow == 1


def test_histogram_overflow_in_snapshot():
    reg = MetricsRegistry()
    reg.observe("lat_ms", 1.0)
    reg.observe("lat_ms", 1e9)        # past the last bucket bound
    snap = reg.snapshot()
    assert snap["lat_ms_count"] == 2
    assert snap["lat_ms_overflow"] == 1
    assert snap["lat_ms_p99_ms"] == float("inf")
    assert Histogram().overflow == 0
    # stage_ histograms get the fine attribution grid
    reg.observe("stage_rx_ms", 0.1)
    assert reg.histograms["stage_rx_ms"].bounds == \
        jtel.MetricsRegistry().histograms.setdefault(
            "x", jtel.Histogram(jtel._buckets_for("stage_rx_ms"))).bounds


def test_histogram_exemplar_keeps_worst():
    h = Histogram()
    ctx = tracing.TraceContext("t1", 3)
    for v in (5.0, 50.0, 7.0):
        h.observe(v, exemplar=ctx)
    assert h.worst_exemplar == (50.0, "t1", 3)
    h.observe(900.0)                  # no exemplar: not a candidate
    assert h.worst_exemplar == (50.0, "t1", 3)
    tracer = tracing.Tracer()
    with tracer.span("outer") as sp:
        h.observe(60.0, exemplar=tracer.current())
    assert h.worst_exemplar == (60.0, sp.ctx.trace_id, sp.ctx.span_id)


def test_registry_counters_gauges_snapshot():
    reg = MetricsRegistry()
    reg.inc("ops")
    reg.inc("ops", 2)
    reg.set_gauge("queue_depth", 7)
    reg.observe("apply_ms", 0.5)
    snap = reg.snapshot()
    assert snap["ops"] == 3 and snap["queue_depth"] == 7
    assert snap["apply_ms_count"] == 1


# ------------------------------------------------------------------ tracing


def test_span_nesting_and_explicit_parent():
    tracer = tracing.Tracer()
    with tracer.span("outer", ops=2) as outer:
        with tracer.span("inner") as inner:
            assert inner.ctx.trace_id == outer.ctx.trace_id
            assert tracer.current() is inner.ctx
    assert tracer.current() is None
    by_name = {e["name"]: e for e in tracer.events(outer.ctx.trace_id)}
    assert by_name["inner"]["parent_id"] == outer.ctx.span_id
    assert by_name["outer"]["parent_id"] is None
    assert by_name["outer"]["args"] == {"ops": 2}
    # a context handed to another thread parents a span there
    with tracer.span("far", parent=outer.ctx) as far:
        assert far.parent_id == outer.ctx.span_id


def test_span_error_recorded_and_stack_unwound():
    tracer = tracing.Tracer()
    with pytest.raises(RuntimeError):
        with tracer.span("doomed"):
            raise RuntimeError("dead")
    e, = tracer.events()
    assert "dead" in e["error"]
    assert tracer.current() is None


def test_record_complete_and_maybe_root_sampling():
    tracer = tracing.Tracer()
    ctx = tracer.record_complete("hot.batch", 12.5, ops=64)
    e, = tracer.events(ctx.trace_id)
    assert e["dur"] == pytest.approx(12.5e3)  # µs
    assert e["args"]["ops"] == 64
    for _ in range(8):
        with tracer.maybe_root_span("srv", every=4):
            pass
    assert len([e for e in tracer.events() if e["name"] == "srv"]) == 2
    # under a current span every call is sampled, as a child
    with tracer.span("root") as root:
        with tracer.maybe_root_span("srv", every=4) as child:
            assert child.parent_id == root.ctx.span_id
    with tracer.maybe_root_span("srv", every=4) as ninth:
        assert ninth.ctx is not None
    with tracer.maybe_root_span("srv", every=4) as tenth:  # unsampled
        assert tenth.ctx is None


# ------------------------------------------------------ idle-age tracking


class TestIdleAgeTracker:
    def test_zipf_storm_coldest_rows_provably_untouched(self):
        """Seeded Zipf storm against a fake clock: the coldest rows carry
        the EXACT stamp of their last touch, and the tracker equals the
        JAX package's on the same scatters."""
        clock = {"t": 0.0}
        tr = capacity.IdleAgeTracker(clock=lambda: clock["t"])
        jt = jcap.IdleAgeTracker(clock=lambda: clock["t"])
        rng = random.Random(19)
        n_rows = 256
        oracle = {}
        for t_ in (tr, jt):
            t_.touch(np.arange(n_rows))
        oracle.update({r: 0.0 for r in range(n_rows)})
        weights = [1.0 / (i + 1) for i in range(n_rows)]
        for w in range(1, 160):
            clock["t"] = float(w)
            sel = sorted(set(rng.choices(range(n_rows),
                                         weights=weights, k=32)))
            for t_ in (tr, jt):
                t_.touch(np.asarray(sel, dtype=np.int64))
            for r in sel:
                oracle[r] = float(w)
        clock["t"] = 500.0
        cold = tr.coldest(10)
        assert cold == jt.coldest(10)
        for row in cold:
            assert row["last_touch"] == oracle[row["row"]]
            assert row["idle_s"] == 500.0 - row["last_touch"]
        assert sorted(r["last_touch"] for r in cold) == \
            sorted(oracle.values())[:10]
        snap = tr.snapshot()
        assert snap == jt.snapshot()
        assert snap["resident_rows"] == n_rows
        assert snap["touch_windows"] == 160
        assert snap["idle_max_s"] == 500.0 - min(oracle.values())

    def test_grows_on_demand_and_untouched_rows_not_resident(self):
        tr = capacity.IdleAgeTracker(clock=lambda: 7.0)
        tr.touch(np.array([900]))
        assert list(tr.resident_rows()) == [900]
        assert tr.coldest(4) == [{"row": 900, "last_touch": 7.0,
                                  "idle_s": 0.0}]
        assert tr.snapshot()["resident_rows"] == 1

    def test_idle_age_histogram_is_a_snapshot(self):
        ages = np.array([0.5, 2.0, 2.0, 40.0])
        h = capacity.idle_age_histogram(ages)
        j = jcap.idle_age_histogram(ages)
        assert h.n == 4 and h.sum_ms == pytest.approx(44.5)
        assert h.counts == j.counts and sum(h.counts) == 4


class _Store:
    """A store's shape for the census: ``state.fields()`` and ``n_docs``."""

    def __init__(self, n_docs):
        from fluidframework_tpu_torch.ops.merge_tree import StringState
        self.n_docs = n_docs
        self.state = StringState.create(n_docs, 64, device="cpu")


class _Door:
    """An idle tracker's owner with a bound row → doc resolver."""

    def __init__(self, tracker):
        self.tracker = tracker

    def doc_of(self, r):
        return f"doc-{r}"


class TestCapacityLedger:
    def test_census_of_stores_and_trackers(self):
        led = capacity.CapacityLedger()
        a, b = _Store(8), _Store(3)
        door = _Door(capacity.IdleAgeTracker(clock=lambda: 10.0))
        door.tracker.touch(np.array([2, 5]), now=4.0)
        door.tracker.touch(np.array([5]), now=6.0)
        assert led.register_store("store", a) == "store"
        assert led.register_store("store", b) == "store2"
        led.add_idle_tracker("door", door.tracker, row_doc_id=door.doc_of)
        c = led.census(top_k=1)
        nbytes = sum(t.numel() * t.element_size()
                     for t in a.state.fields().values())
        assert c["device"]["by_owner"] == {"store": nbytes,
                                           "store2": nbytes * 3 // 8}
        assert c["device"]["total_bytes"] == nbytes * 11 // 8
        assert c["docs"] == {"resident": 11,
                             "by_owner": {"store": 8, "store2": 3}}
        assert c["coldest"] == [{"row": 2, "last_touch": 4.0,
                                 "idle_s": 6.0, "owner": "door",
                                 "doc": "doc-2"}]
        assert c["idle"]["door"]["resident_rows"] == 2
        # a CPU store has no allocator to read
        assert c["device"]["allocator"]["available"] is False
        from fluidframework_tpu_torch.utils.telemetry import REGISTRY
        assert REGISTRY.histograms["doc_idle_age_s"].n == 2

    def test_dead_owner_silently_leaves_the_census(self):
        led = capacity.CapacityLedger()
        store = _Store(2)
        door = _Door(capacity.IdleAgeTracker(clock=lambda: 1.0))
        door.tracker.touch(np.array([0]))
        led.register_store("mortal", store)
        led.add_idle_tracker("door", door.tracker, row_doc_id=door.doc_of)
        assert led.census()["coldest"][0]["doc"] == "doc-0"
        del store, door
        gc.collect()
        c = led.census()
        assert c["device"]["by_owner"] == {} and c["idle"] == {}
        assert c["coldest"] == [] and c["docs"]["resident"] == 0


# ---------------------------------------- stage timeline and hot-doc sketch


def test_window_timeline_matches_jax():
    """The same crossings give the same stage histograms in both
    packages; stages sum to the end-to-end latency."""
    rng = np.random.default_rng(9)
    t, j = MetricsRegistry(), jtel.MetricsRegistry()
    for _ in range(50):
        base = float(rng.random() * 100)
        steps = np.cumsum(rng.random(8) * 0.01)
        tl = {"t_rx": base, "t_drain0": base + steps[0],
              "admit_ms": float(rng.random()), "t_ready": base + steps[2]}
        marks = {"pack1": base + steps[3], "seq1": base + steps[4],
                 "disp1": base + steps[5] - 0.02,   # clamped monotonic
                 "log1": base + steps[6]}
        observe_window_timeline(tl, marks, base + steps[7], registry=t)
        jopsd.observe_window_timeline(tl, marks, base + steps[7],
                                      registry=j)
    for name in [f"stage_{s}_ms" for s in STAGES] + ["stage_e2e_ack_ms"]:
        assert t.histograms[name].counts == j.histograms[name].counts
        assert t.histograms[name].sum_ms == j.histograms[name].sum_ms
    lb = latency_breakdown(t)
    assert lb == jopsd.latency_breakdown(j)
    assert lb["windows"] == 50
    assert lb["stage_sum_ms"] == pytest.approx(lb["e2e_mean_ms"])


def test_space_saving_matches_jax_and_bounds_its_error():
    rng = random.Random(4)
    t, j = SpaceSaving(capacity=16), jopsd.SpaceSaving(capacity=16)
    truth = {}
    keys = [(f"doc-{i}", f"t{i % 3}") for i in range(64)]
    weights = [1.0 / (i + 1) ** 1.2 for i in range(64)]
    for _ in range(3000):
        k = rng.choices(keys, weights=weights)[0]
        n = rng.randint(1, 4)
        truth[k] = truth.get(k, 0) + n
        t.offer(k, n)
        j.offer(k, n)
    assert t.top(16) == j.top(16) and t.total == j.total
    assert len(t) == 16
    for key, est, err in t.top(16):
        assert est - err <= truth[key] <= est
    heavy = [k for k, v in truth.items() if v > t.total / 16]
    assert set(heavy) <= {k for k, _, _ in t.top(16)}
    reg = MetricsRegistry()
    publish_hotdoc_gauges([t], registry=reg)
    jreg = jtel.MetricsRegistry()
    jopsd.publish_hotdoc_gauges([j], registry=jreg)
    assert reg.gauges == jreg.gauges
    assert reg.gauges["hotdoc_tracked"] == 16
    t.clear()
    assert len(t) == 0 and t.total == 0
