"""The planes under the port's serving frontend against the JAX package, on
the CPU: the metrics registry's gauges and exporters, the tracing
context, the runtime sanitizer, the program-build counts (jitstats), the
credit ledger, the admission queue and the async half of the ragged door
(``RaggedRuntime``, ``_dispatch_group``, ``RaggedBatcher``).

Where both packages have the function, the same operations must give the
same text, counters and verdicts; the ragged runtime's views are bit for
bit the executor's and ``CohortAggregator``'s.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from byzpy_tpu import aggregators as J
from byzpy_tpu.analysis import sanitize as jsanitize
from byzpy_tpu.observability import metrics as jmetrics
from byzpy_tpu.serving import credits as jcredits
from byzpy_tpu.serving import ragged as jragged
from byzpy_tpu_torch import aggregators as T
from byzpy_tpu_torch.analysis import sanitize
from byzpy_tpu_torch.observability import jitstats, metrics, runtime, tracing
from byzpy_tpu_torch.serving import (
    AdmissionQueue,
    CohortAggregator,
    StalenessPolicy,
    Submission,
    TenantConfig,
    build_cohort,
    credits,
)
from byzpy_tpu_torch.serving import ragged

D = 32


def _ops(reg):
    """One fixed sequence of registry operations."""
    c = reg.counter("byzpy_x_total", help="x things", labels={"tenant": "a"})
    c.inc()
    c.inc(2.5)
    reg.counter("byzpy_x_total", help="x things", labels={"tenant": 'b"q\\'}).inc()
    g = reg.gauge("byzpy_depth", help="queue depth", labels={"tenant": "a"})
    g.set(7)
    g.inc(3)
    g.dec(1.5)
    reg.gauge("byzpy_plain").set(-2)
    h = reg.histogram("byzpy_lat_seconds", help="latency", labels={"tenant": "a"})
    for v in (1e-4, 0.003, 0.2, 5.0, 100.0):
        h.observe(v)
    s = reg.histogram("byzpy_sizes", buckets=jmetrics.SIZE_BUCKETS)
    for v in (1, 3, 64, 5000):
        s.observe(v)
    return g, h


def test_gauge_and_exporters_match_the_reference(tmp_path):
    """Counters, gauges and histograms after the same operations: the
    Prometheus text, the snapshot and the JSONL records (but their
    timestamps) are the reference's; ``iter_jsonl`` reads the file back;
    a counter refuses to go down and a name clash of kinds raises."""
    ours, ref = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    g, h = _ops(ours)
    _ops(ref)
    assert metrics.SIZE_BUCKETS == jmetrics.SIZE_BUCKETS
    assert ours.prometheus_text() == ref.prometheus_text()
    assert ours.snapshot() == ref.snapshot()
    assert g.value == 8.5 and h.count == 5
    strip = [{k: v for k, v in r.items() if k != "time"} for r in ours.jsonl_records()]
    assert strip == [{k: v for k, v in r.items() if k != "time"} for r in ref.jsonl_records()]
    path = str(tmp_path / "m.jsonl")
    n = ours.to_jsonl(path)
    with open(path, "a") as fh:
        fh.write("\n")
    back = list(metrics.iter_jsonl(path))
    assert len(back) == n == len(strip) and back == list(jmetrics.iter_jsonl(path))
    with pytest.raises(ValueError):
        ours.counter("byzpy_x_total", labels={"tenant": "a"}).inc(-1)
    with pytest.raises((TypeError, ValueError)):
        ours.gauge("byzpy_x_total", labels={"tenant": "a"})
    ours.reset()
    assert ours.prometheus_text() == ""


def test_tracing_context_scope_carry_and_instant(monkeypatch):
    """``current_context`` inside a span, ``context_scope`` parenting a
    span opened elsewhere, ``carry_context`` across an executor hop,
    ``instant`` linked into the open span, and the chrome trace with a
    flow arrow between tracks; with telemetry off, all no-ops."""
    monkeypatch.setattr(runtime.STATE, "enabled", False)
    assert tracing.current_context() is None
    fn = lambda: 1  # noqa: E731
    assert tracing.carry_context(fn) is fn
    tracing.instant("nothing")
    monkeypatch.setattr(runtime.STATE, "enabled", True)
    tr = tracing.tracer()
    tr.clear()
    with tracing.span("round", track="tenant:a") as sp:
        ctx = tracing.current_context()
        assert ctx == sp.context
        tracing.instant("alarm", track="tenant:a", level=1)
        carried = tracing.carry_context(lambda: tracing.current_context())
    assert tracing.current_context() is None
    assert asyncio.run(_in_executor(carried)) == ctx
    with tracing.context_scope(ctx):
        with tracing.span("late", track="other"):
            pass
    events = tr.events()
    late = [e for e in events if e["name"] == "late"][0]
    assert late["args"]["parent"] == ctx[1] and late["args"]["trace"] == ctx[0]
    alarm = [e for e in events if e["name"] == "alarm"][0]
    assert alarm["ph"] == "i" and alarm["args"]["parent"] == ctx[1]
    trace = tr.chrome_trace()
    assert any(e.get("ph") == "s" for e in trace["traceEvents"])
    assert {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"} == {"tenant:a", "other"}
    tr.clear()


async def _in_executor(fn):
    return await asyncio.get_running_loop().run_in_executor(None, fn)


def test_sanitizer_counters_and_violations_match_the_reference(monkeypatch):
    """The same hook calls give the reference's counters and violations;
    the port reads ``BYZPY_TPU_TORCH_SANITIZE`` and is off by default."""
    for mod in (sanitize, jsanitize):
        mod.reset()
        mod.enable()
    try:
        for mod in (sanitize, jsanitize):
            mod.loop_tick("loop", threshold_s=1e9)
            mod.loop_tick("loop", threshold_s=1e9)
            mod.audit_fold("t", 0, [("a", 0), ("b", None)])
            mod.audit_fold("t", 1, [("a", 1)])
            mod.audit_fold("t", 1, [("a", 0)])        # repeated round, refolded key
            mod.check_drained("inflight", 0)
            mod.check_drained("inflight", 2)
        assert sanitize.counters() == jsanitize.counters()
        assert sanitize.violations() == jsanitize.violations()
        assert len(sanitize.violations()) >= 2
        with pytest.raises(AssertionError):
            sanitize.assert_clean()
    finally:
        for mod in (sanitize, jsanitize):
            mod.disable()
            mod.reset()
    assert "BYZPY_TPU_TORCH_SANITIZE" in sanitize._Sanitizer.__init__.__code__.co_consts


def test_jitstats_counts_built_programs():
    """``note_cache_size`` counts growth once (the reference's rule);
    ``programs_built`` reads a ragged executor's programs and a captured
    step's graphs."""
    jitstats.reset()
    site = "test.site"
    assert jitstats.note_cache_size(site, None) == 0
    assert jitstats.note_cache_size(site, 2) == 2
    assert jitstats.note_cache_size(site, 2) == 0
    assert jitstats.note_cache_size(site, 1) == 0
    assert jitstats.note_cache_size(site, 3) == 1
    assert jitstats.compiles_seen(site) == 3
    ex = ragged.RaggedExecutor(T.CoordinateWiseMedian(device="cpu"), D, 8, 2)
    assert jitstats.programs_built(ex) == ex.expected_compiles() == 1

    class Captured:
        graphs = {"sig-a": object(), "sig-b": object()}

    assert jitstats.programs_built(Captured()) == 2
    assert jitstats.programs_built(object()) is None
    jitstats.reset()
    assert jitstats.compiles_seen(site) == 0


def test_credit_ledger_and_round_stats_match_the_reference():
    ours = credits.CreditLedger(credits.CreditPolicy(rate_per_s=2.0, burst=3.0, max_tracked_clients=3))
    ref = jcredits.CreditLedger(jcredits.CreditPolicy(rate_per_s=2.0, burst=3.0, max_tracked_clients=3))
    rng = np.random.default_rng(0)
    now = 0.0
    for _ in range(60):
        now += float(rng.exponential(0.2))
        client = f"c{int(rng.integers(5))}"
        scale = float(rng.choice([1.0, 0.5]))
        a, b = ours.admit(client, now, rate_scale=scale), ref.admit(client, now, rate_scale=scale)
        assert a == b
        ours.record("accepted" if a else "rejected_rate", client)
        ref.record("accepted" if b else "rejected_rate", client)
    assert ours.snapshot() == ref.snapshot()
    stats, jstats = credits.RoundStats(), jcredits.RoundStats()
    for i in range(20):
        stats.record(0.01 * i, i % 5 + 1)
        jstats.record(0.01 * i, i % 5 + 1)
    assert stats.latency_percentiles_s(50, 99) == jstats.latency_percentiles_s(50, 99)


def test_admission_queue_bounds_snapshot_restore_and_collect():
    """Reject at the door past capacity, a high-water mark, a non-consuming
    snapshot, a restore past the bound, a nowait drain, and ``collect``'s
    size trigger and window."""
    q = AdmissionQueue(3)
    subs = [Submission(f"c{i}", 0, np.zeros(D, np.float32), float(i)) for i in range(5)]
    assert [q.offer(s) for s in subs[:4]] == [True, True, True, False]
    assert q.rejected_full == 1 and q.depth_high_water == 3
    assert [s.client for s in q.snapshot_items()] == ["c0", "c1", "c2"] and q.depth() == 3
    q.restore([subs[4]])
    assert q.depth() == 4 == q.depth_high_water
    assert [s.client for s in q.drain_nowait(2)] == ["c0", "c1"]

    async def collect():
        got = await q.collect(5, 0.05)
        q.offer(subs[0])
        q.offer(subs[1])
        return got, await q.collect(1, 10.0)

    got, one = asyncio.run(collect())
    assert [s.client for s in got] == ["c2", "c4"] and [s.client for s in one] == ["c0"]
    with pytest.raises(ValueError):
        AdmissionQueue(0)


def test_ragged_switch_and_dispatch_functions(monkeypatch):
    """``ragged_enabled`` reads the port's own variable; the dispatch
    functions are B11 and B12 (their plain versions on the CPU)."""
    monkeypatch.delenv("BYZPY_TPU_TORCH_RAGGED", raising=False)
    assert ragged.ragged_enabled()
    monkeypatch.setenv("BYZPY_TPU_TORCH_RAGGED", "0")
    assert not ragged.ragged_enabled()
    from byzpy_tpu_torch.ops import kernels

    x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, D)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 6)).astype(np.float32))
    assert torch.equal(ragged.ragged_segment_sum_fn(6, D)(x, w, fill=4), kernels.segment_sum(x, w, fill=4))
    from byzpy_tpu_torch.parallel import CommPrecision, encode_blockwise

    enc = encode_blockwise(x, CommPrecision("int8"))
    fused = ragged.ragged_segment_dequant_fn("int8", enc.block)(enc.values, enc.scales, w, d=D)
    assert torch.equal(fused, kernels.segment_sum_dequant(enc.values, enc.scales, w, mode="int8",
                                                          block=enc.block, d=D))


def _cohorts(sizes, seed, *, nonfinite=()):
    policy = StalenessPolicy("exponential", gamma=0.5)
    rng = np.random.default_rng(seed)
    out = []
    for k, m in enumerate(sizes):
        rows = rng.normal(size=(m, D)).astype(np.float32)
        if k in nonfinite:
            rows[0, 3] = np.inf
        subs = [Submission(f"t{k}/c{i}", 4 if i % 3 == 1 else 5, rows[i], float(i)) for i in range(m)]
        out.append(build_cohort(subs, 5, None, policy, device="cpu"))
    return out


def test_runtime_groups_and_snapshot_match_the_reference():
    """Tenant groups (class, statics, dim), the served set and the
    coalescing caps are the reference's; programless classes stay on the
    ladder."""
    def cfgs(port):
        mk = (lambda: T.MultiKrum(1, 2, device="cpu")) if port else (lambda: J.MultiKrum(f=1, q=2))
        med = (lambda: T.CoordinateWiseMedian(device="cpu")) if port else J.CoordinateWiseMedian
        caf = (lambda: T.CAF(1, device="cpu")) if port else (lambda: J.CAF(f=1))
        mod = TenantConfig if port else __import__("byzpy_tpu.serving", fromlist=["x"]).TenantConfig
        return [mod("a", mk(), dim=D, cohort_cap=8), mod("b", mk(), dim=D, cohort_cap=12),
                mod("c", med(), dim=D, cohort_cap=8), mod("d", mk(), dim=D + 8, cohort_cap=8),
                mod("e", caf(), dim=D, cohort_cap=8)]

    ours, ref = ragged.RaggedRuntime(cfgs(True)), jragged.RaggedRuntime(cfgs(False))
    for name in "abcde":
        assert ours.serves(name) == ref.serves(name), name
        ex, jex = ours.executor_for(name), ref.executor_for(name)
        assert (ex is None) == (jex is None)
        if ex is not None:
            assert (ex.rows, ex.max_cohorts) == (jex.rows, jex.max_cohorts)
    assert ours.executor_for("a") is ours.executor_for("b")
    snap, jsnap = ours.snapshot(), ref.snapshot()
    for key in ("groups", "tenants", "dispatches", "cohorts_dispatched", "max_batch"):
        assert snap[key] == jsnap[key], key


def test_dispatch_group_serves_each_cohort_and_routes_nonfinite_ones():
    """``_dispatch_group``: finite cohorts chunked against the executor's
    capacity, each view bit for bit ``CohortAggregator``'s; a non-finite
    cohort through its fallback; no fallback, its own exception."""
    agg = T.MultiKrum(1, 2, device="cpu")
    ex = ragged.RaggedExecutor(agg, D, row_capacity=12, max_cohorts=2, with_evidence=False)
    cohorts = _cohorts([5, 6, 7, 4], 3, nonfinite=(2,))
    fb = CohortAggregator(agg)
    items = [("a", cohorts[0], fb), ("b", cohorts[1], fb), ("c", cohorts[2], fb), ("d", cohorts[3], None)]
    results = ragged._dispatch_group(ex, items)
    assert ex.dispatches == 2
    for (_, cohort, _), view in zip(items, results):
        assert torch.equal(view.vector, CohortAggregator(agg).aggregate(cohort))
    assert results[2].scores is None and results[0].scores is not None
    bad = ragged._dispatch_group(ex, [("x", cohorts[2], None)])
    assert isinstance(bad[0], ValueError)


def test_batcher_coalesces_pending_cohorts_into_one_call():
    """Cohorts of two tenants handed to the batcher in one pass ride one
    device call (``max_batch`` 2), each view bit for bit the executor's
    own dispatch of that cohort alone."""
    def cfg(name):
        return TenantConfig(name, T.CoordinateWiseTrimmedMean(1, device="cpu"), dim=D, cohort_cap=8)

    rt = ragged.RaggedRuntime([cfg("a"), cfg("b")])
    cohorts = _cohorts([5, 7], 9)

    async def run():
        lock = asyncio.Lock()
        await rt.start(lock)
        try:
            return await asyncio.gather(rt.aggregate_async("a", cohorts[0]),
                                        rt.aggregate_async("b", cohorts[1]))
        finally:
            await rt.close()

    views = asyncio.run(run())
    snap = rt.snapshot()
    assert snap["batched_calls"] == 0  # the batcher is gone after close
    assert snap["cohorts_dispatched"] == 2
    ex = rt.executor_for("a")
    for view, cohort in zip(views, cohorts):
        (alone,) = ex.aggregate([cohort], ["x"])
        assert torch.equal(view.vector, alone.vector)
    assert jitstats.compiles_seen(ragged.RAGGED_SITE) >= 1
    assert json.dumps(snap)
