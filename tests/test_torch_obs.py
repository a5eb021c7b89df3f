"""The port's telemetry (``repro_torch.obs``, ``serving/trace.py``,
``serving/audit.py``) against the JAX package's.

The 27 tests of ``tests/test_obs.py`` replay here on the port, and each one
that the reference answers too is held to it on the same inputs: reduced
llama-7b on the CPU with the reference's weights converted, the same
requests, the same fee-charging prices and ``V100_X4_HF`` perf model on both
sides.  Held to the reference:

  * the ledger, entry by entry (category, activity, replica, req_id, tier,
    kind and nbytes exact or at 1e-9, dollars at 1e-9), with its totals,
    ``by_request``, ``by_activity``, ``by_tier`` and infrastructure total;
  * the registry's ``snapshot()`` after ``collect_engine`` and
    ``collect_cluster``, series by series (the ``jit_*`` gauges' help text
    says what the port counts: first and repeat calls per shape bucket);
  * span trees and the Chrome trace, audit rows and the console's lines;
  * JSONL traces line by line, and each package's ``read_events`` on the
    other's trace giving the other's live summaries, audits and spans.

Non-interference: telemetry on and off give the same tokens, records,
summary, calls of each kernel's plain version and shape-bucket counts.
"""
import dataclasses
import json
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro.core.perf_model import PerfModel as JPerfModel  # noqa: E402
from repro.core.perf_model import V100_X4_HF as J_V100_X4_HF  # noqa: E402
from repro.core.pricing import AWS_PAPER as J_AWS_PAPER  # noqa: E402
from repro.core.pricing import Pricing as JPricing  # noqa: E402
from repro.core.pricing import S3_STANDARD as J_S3_STANDARD  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro.obs.console import render as jrender  # noqa: E402
from repro.obs.registry import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.serving import audit as jaudit  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro_torch import serving as pserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.core.perf_model import PerfModel, V100_X4_HF  # noqa: E402
from repro_torch.core.pricing import AWS_PAPER, GB, Pricing, S3_STANDARD  # noqa: E402
from repro_torch.kernels import chunked_prefill as cpk  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import fused_prefill as fuk  # noqa: E402
from repro_torch.kernels import kv_quant as kq  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from repro_torch.kvcache import faults  # noqa: E402
from repro_torch.kvcache import hierarchy as phierarchy  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    CostLedger,
    Telemetry,
    build_cluster_spans,
    build_spans,
    check_conservation,
    chrome_trace,
    ledger_from_simulation,
    write_chrome_trace,
)
from repro_torch.obs.console import render  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Request,
    RoundRobinRouter,
    TraceWriter,
    read_events,
    read_tagged_events,
    read_trace,
)
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.audit import (  # noqa: E402
    audit,
    audit_from_trace,
    cluster_audit,
    cluster_audit_from_trace,
    format_cluster_table,
    format_table,
    slo_summary,
)
from repro_torch.serving.metrics import ClusterSummary, summarize, summarize_events  # noqa: E402
from test_torch_engine import _setup  # noqa: E402

torch.set_num_threads(1)
LLAMA = get_config("llama-7b")
PM, JPM = PerfModel(V100_X4_HF), JPerfModel(J_V100_X4_HF)

# a tier that charges transfer fees, so the transfer leg of the conservation
# law is tested against nonzero dollars (the paper's catalog tiers are all
# same-region: fee 0); built once from each package
FEE_PRICING = Pricing(
    compute=AWS_PAPER.compute,
    tiers={**AWS_PAPER.tiers, "s3": dataclasses.replace(S3_STANDARD, per_gb_transfer_fee=0.09)},
    default_tier="s3",
)
J_FEE_PRICING = JPricing(
    compute=J_AWS_PAPER.compute,
    tiers={**J_AWS_PAPER.tiers,
           "s3": dataclasses.replace(J_S3_STANDARD, per_gb_transfer_fee=0.09)},
    default_tier="s3",
)
# the port's help text of these gauges says what it counts (first and repeat
# calls per shape bucket, not compiles); their series are the reference's
JIT_GAUGES = ("jit_cache_hits", "jit_cache_misses", "jit_calls_since_miss", "jit_bucket_calls")
# each kernel's plain version, which the CPU runs in place of the kernel
PLAIN = {"packed_flash_attention": (pk, "packed_flash_attention_plain"),
         "decode_attention": (dk, "decode_attention_plain"),
         "flash_attention": (fk, "flash_attention_plain"),
         "paged_decode_attention": (pdk, "paged_decode_attention_plain"),
         "chunked_prefill_attention": (cpk, "chunked_prefill_attention_plain"),
         "fused_flash_attention": (fuk, "fused_flash_attention_plain"),
         "kv_quant": (kq, "kv_quant_plain"),
         "kv_dequant": (kq, "kv_dequant_plain"),
         "ssd_chunked": (ssk, "ssd_chunked_plain")}


def _same(got, want, where="", atol=1e-9):
    """Equal, floats at ``atol`` (NaN where the other is NaN), recursing into
    dataclasses (field names and class names must agree, whatever package
    defines them), dicts (the same keys) and sequences."""
    if dataclasses.is_dataclass(got) and not isinstance(got, type):
        assert dataclasses.is_dataclass(want), where
        assert type(got).__name__ == type(want).__name__, where
        names = [f.name for f in dataclasses.fields(got)]
        assert names == [f.name for f in dataclasses.fields(want)], where
        for n in names:
            _same(getattr(got, n), getattr(want, n), f"{where}.{n}", atol)
    elif isinstance(got, dict):
        assert isinstance(want, dict) and set(got) == set(want), (where, set(got) ^ set(want))
        for k in got:
            _same(got[k], want[k], f"{where}[{k!r}]", atol)
    elif isinstance(got, (list, tuple)):
        assert isinstance(want, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]", atol)
    elif isinstance(got, float) or isinstance(want, float):
        assert isinstance(want, (int, float)) and isinstance(got, (int, float)), where
        if math.isnan(got) or math.isnan(want):
            assert math.isnan(got) and math.isnan(want), (where, got, want)
        else:
            assert abs(got - want) <= atol, (where, got, want)
    else:
        assert got == want, (where, got, want)


def _same_ledger(led, jled):
    """Entry by entry, then every aggregation."""
    _same([e.as_dict() for e in led.all_entries()],
          [e.as_dict() for e in jled.all_entries()], "ledger entries")
    _same(led.totals(), jled.totals(), "totals")
    for r in {e.replica for e in jled.all_entries()}:
        _same(led.totals(replica=r), jled.totals(replica=r), f"totals[{r}]")
        _same(led.by_request(replica=r), jled.by_request(replica=r), f"by_request[{r}]")
    _same(led.by_request(), jled.by_request(), "by_request")
    _same(led.by_activity(), jled.by_activity(), "by_activity")
    _same(led.by_tier(), jled.by_tier(), "by_tier")
    _same(led.infrastructure_total(), jled.infrastructure_total(), "infrastructure")
    _same(led.as_dict(), jled.as_dict(), "as_dict")


def _same_snapshot(snap, jsnap):
    """Registry snapshots series by series; the ``jit_*`` gauges' help text
    is the port's own."""
    assert list(snap) == list(jsnap), set(snap) ^ set(jsnap)
    for name in snap:
        got, want = dict(snap[name]), dict(jsnap[name])
        if name in JIT_GAUGES:
            assert "shape bucket" in got.pop("help")
            want.pop("help")
        _same(got, want, name)


def _same_lines(path, jpath):
    """Two JSONL traces, line by line after parsing."""
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    jlines = [json.loads(x) for x in open(jpath).read().splitlines()]
    _same(lines, jlines, "trace")
    return len(lines)


NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]\d+)?")


def _same_console(text, jtext):
    """The reference's lines: the same words, each number within 1e-9
    relative of the reference's."""
    lines, jlines = text.splitlines(), jtext.splitlines()
    assert len(lines) == len(jlines)
    for line, jline in zip(lines, jlines):
        assert NUMBER.sub("#", line) == NUMBER.sub("#", jline), (line, jline)
        for a, b in zip(NUMBER.findall(line), NUMBER.findall(jline)):
            assert float(a) == pytest.approx(float(b), rel=1e-9, abs=0.0), (line, jline)


@pytest.fixture(scope="module")
def small():
    return _setup("llama-7b")


def _requests(vocab, n=6, ctx_len=64, seed=0, n_ctx=2):
    """``tests/test_obs.py``'s request mix, drawn from the same seed."""
    rng = np.random.default_rng(seed)
    ctxs = [list(map(int, rng.integers(0, vocab, ctx_len))) for _ in range(n_ctx)]
    return [
        dict(req_id=i, arrival_s=0.01 * i, context_tokens=tuple(ctxs[i % n_ctx]),
             prompt_tokens=tuple(map(int, rng.integers(0, vocab, 8))), max_new_tokens=4)
        for i in range(n)
    ]


def _engine(small, telemetry=None, port=True, **ec_kw):
    """``tests/test_obs.py``'s ``_engine`` on one package."""
    jcfg, jparams, cfg, params = small
    mod, hier = (pserving, phierarchy) if port else (jserving, jhierarchy)
    base = dict(max_slots=2, tier_specs=[hier.TierSpec("host_dram", 1.0),
                                         hier.TierSpec("s3", 1.0)], store_tier="s3")
    base.update(ec_kw)
    kw = dict(pricing=FEE_PRICING, perf=PM, device="cpu") if port else dict(
        pricing=J_FEE_PRICING, perf=JPM)
    return mod.ServingEngine(cfg if port else jcfg, params if port else jparams,
                             engine_cfg=mod.EngineConfig(**base),
                             planner=mod.AlwaysReusePlanner(), telemetry=telemetry, **kw)


def _drain(eng, reqs, make, trace=None):
    for r in reqs:
        eng.submit(make(**r))
    events = []
    while not eng.idle:
        out = eng.step()
        events.extend(out)
        if trace is not None:
            trace.write_all(out)
    return events


@pytest.fixture(scope="module")
def served(small, tmp_path_factory):
    """The engine mix on both packages, telemetry on and a trace written:
    (port: engine, telemetry, events, summary, trace path; reference: the
    same)."""
    d = tmp_path_factory.mktemp("obs")
    out = {}
    for port in (True, False):
        tel = Telemetry() if port else jobs.Telemetry()
        eng = _engine(small, tel, port=port)
        path = d / ("port.jsonl" if port else "ref.jsonl")
        with (TraceWriter if port else jtrace.TraceWriter)(path) as tw:
            events = _drain(eng, _requests(small[2].vocab),
                            Request if port else jserving.Request, tw)
        out["port" if port else "ref"] = (eng, tel, events, eng.summary(), path)
    return out


# --------------------------------------------------------------------------- #
# Metrics registry
# --------------------------------------------------------------------------- #
def _both_registries(ops):
    """Apply ``ops(registry)`` to a port and a reference registry; the two
    expositions must be equal.  Returns the port's registry and ops' value."""
    r, jr = MetricsRegistry(), JMetricsRegistry()
    got, jgot = ops(r), ops(jr)
    assert r.to_prometheus() == jr.to_prometheus()
    _same(r.snapshot(), jr.snapshot(), "snapshot")
    return r, got, jgot


class TestRegistry:
    def test_counter_gauge_histogram(self):
        def ops(r):
            c = r.counter("hits_total", "Hits", ("tier",))
            c.inc(tier="s3")
            c.inc(2, tier="s3")
            c.inc(tier="dram")
            g = r.gauge("level", "Level")
            g.set(7.5)
            g.set(2.5)
            h = r.histogram("lat", "Latency")
            for v in (0.002, 0.02, 0.2):
                h.observe(v)
            return c, g, h

        _, (c, g, h), (jc, jg, jh) = _both_registries(ops)
        assert c.value(tier="s3") == 3.0
        assert c.value(tier="dram") == 1.0
        assert g.value() == 2.5
        s = h.hist()
        assert s.n == 3 and abs(s.total - 0.222) < 1e-12
        assert 0.001 <= s.quantile(0.5) <= 0.05
        for q in (0.1, 0.5, 0.9, 0.99):
            assert s.quantile(q) == jh.hist().quantile(q)

    def test_idempotent_creation_and_mismatch(self):
        for r in (MetricsRegistry(), JMetricsRegistry()):
            a = r.counter("x_total", "X", ("l",))
            assert r.counter("x_total", "X", ("l",)) is a
            with pytest.raises(ValueError):
                r.gauge("x_total", "X", ("l",))
            with pytest.raises(ValueError):
                r.counter("x_total", "X", ("other",))

    def test_counter_rejects_negative(self):
        for r in (MetricsRegistry(), JMetricsRegistry()):
            c = r.counter("n_total", "N")
            with pytest.raises(ValueError):
                c.inc(-1)
            with pytest.raises(ValueError):
                c.inc(1, extra="label")

    def test_prometheus_exposition(self):
        def ops(r):
            r.counter("reqs_total", "Requests", ("tier",)).inc(tier="s3")
            r.gauge("temp", "Temp").set(1.0)
            r.gauge("nan_gauge", "NaN").set(float("nan"))
            h = r.histogram("lat_seconds", "Lat", ("replica",))
            h.observe(0.002, replica=0)
            h.observe(99.0, replica=1)

        r, _, _ = _both_registries(ops)
        text = r.to_prometheus()
        assert "# TYPE reqs_total counter" in text
        assert 'reqs_total{tier="s3"} 1.0' in text
        assert "# TYPE lat_seconds histogram" in text
        assert 'lat_seconds_bucket{replica="0",le="+Inf"} 1' in text
        assert 'lat_seconds_count{replica="0"} 1' in text
        assert "nan_gauge NaN" in text

    def test_snapshot_roundtrips_json(self):
        def ops(r):
            r.counter("a_total", "A").inc(5)
            r.histogram("b_seconds", "B").observe(0.1)

        r, _, _ = _both_registries(ops)
        snap = json.loads(json.dumps(r.snapshot()))
        assert snap["a_total"]["series"][0]["value"] == 5.0
        assert snap["b_seconds"]["series"][0]["count"] == 1


# --------------------------------------------------------------------------- #
# Ledger arithmetic (property-tested)
# --------------------------------------------------------------------------- #
ENTRY = st.tuples(
    st.sampled_from(["compute", "storage", "transfer"]),
    st.floats(0.0, 10.0, allow_nan=False),
    st.integers(0, 3),  # replica
    st.one_of(st.none(), st.integers(0, 9)),  # req_id
)


class TestLedger:
    @settings(max_examples=50, deadline=None, derandomize=True)
    @given(st.lists(ENTRY, max_size=40))
    def test_totals_partition(self, entries):
        led, jled = CostLedger(), jobs.CostLedger()
        for cat, d, rep, rid in entries:
            led.add(cat, "x", d, replica=rep, req_id=rid)
            jled.add(cat, "x", d, replica=rep, req_id=rid)
        _same_ledger(led, jled)
        t = led.totals()
        for cat in ("compute", "storage", "transfer"):
            expect = sum(d for c, d, _, _ in entries if c == cat)
            assert t[cat] == pytest.approx(expect, abs=1e-9)
        # replica slices partition the totals
        by_rep = [led.totals(replica=r) for r in range(4)]
        for cat in t:
            assert sum(b[cat] for b in by_rep) == pytest.approx(t[cat], abs=1e-9)
        # attributed + infrastructure partition the grand total
        attributed = sum(led.by_request().values())
        assert attributed + led.infrastructure_total() == pytest.approx(led.total(), abs=1e-9)

    def test_settle_storage_idempotent(self):
        led, jled = CostLedger(), jobs.CostLedger()
        for x in (led, jled):
            x.settle_storage({"s3": 1.0, "dram": 2.0})
            x.settle_storage({"s3": 1.5, "dram": 2.0}, bytes_by_tier={"s3": 4.0})
        _same_ledger(led, jled)
        assert led.totals()["storage"] == pytest.approx(3.5)
        assert len([e for e in led.all_entries() if e.category == "storage"]) == 2

    def test_conservation_violation_raises(self):
        led = CostLedger()
        led.add("compute", "request", 1.0, req_id=0)
        s = summarize([], storage_cost=0.0, transfer_cost=0.0)
        with pytest.raises(AssertionError, match="conservation"):
            check_conservation(led, s)
        with pytest.raises(AssertionError):
            led.add("market", "x", 1.0)  # not a category of the engine's bill


class TestSimulatorConservation:
    @settings(max_examples=15, deadline=None, derandomize=True)
    @given(
        n_contexts=st.integers(1, 5),
        reuses=st.integers(1, 4),
        l_context=st.integers(256, 4096),
        reuse_kv=st.booleans(),
        seed=st.integers(0, 99),
    )
    def test_ledger_matches_sim_cost(self, n_contexts, reuses, l_context, reuse_kv, seed):
        kw = dict(n_contexts=n_contexts, reuses_per_context=reuses, L_context=l_context,
                  seed=seed)
        tier, jtier = FEE_PRICING.tier("s3"), J_FEE_PRICING.tier("s3")
        res = simulator.simulate(LLAMA, simulator.make_trace(**kw), PM, reuse_kv=reuse_kv,
                                 tier=tier)
        from repro.configs import get_config as jget_config

        jres = jsimulator.simulate(jget_config("llama-7b"), jsimulator.make_trace(**kw), JPM,
                                   reuse_kv=reuse_kv, tier=jtier)
        led = ledger_from_simulation(res, FEE_PRICING, tier)
        _same_ledger(led, jobs.ledger_from_simulation(jres, J_FEE_PRICING, jtier))
        t = led.totals()
        c_gpu_s = FEE_PRICING.compute.cost_per_hour / 3600.0
        assert t["compute"] == pytest.approx(c_gpu_s * res.gpu_busy_s, abs=1e-9)
        assert t["storage"] == pytest.approx(tier.cost_per_gb_hour * res.storage_gb_hours,
                                             abs=1e-9)
        assert t["transfer"] == pytest.approx(
            tier.per_gb_transfer_fee * res.transferred_bytes / GB, abs=1e-9)
        assert led.total() == pytest.approx(res.cost(FEE_PRICING, tier), abs=1e-9)
        assert len(led.by_request()) == len(res.results)


# --------------------------------------------------------------------------- #
# Engine-level conservation + non-interference
# --------------------------------------------------------------------------- #
def _counting_plain(monkeypatch):
    """Count the calls of each kernel's plain version (the CPU's stand-in
    for a launch)."""
    calls = {name: 0 for name in PLAIN}
    for name, (mod, attr) in PLAIN.items():
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    return calls


class TestEngineTelemetry:
    def test_conservation_and_attribution(self, served):
        eng, tel, _, s, _ = served["port"]
        jeng, jtel, _, js, _ = served["ref"]
        assert s.transfer_cost > 0  # the fee tier's write-backs were charged
        residuals = tel.check(s)
        assert max(residuals.values()) <= 1e-9
        _same(residuals, jtel.check(js), "residuals")
        _same_ledger(tel.ledger, jtel.ledger)
        # every request's compute dollars are attributed
        by_req = tel.ledger.by_request()
        for rec in eng.records:
            assert by_req[rec.req_id] >= rec.compute_cost - 1e-12
        acts = tel.ledger.by_activity()
        assert "write_back" in acts and "fetch" in acts and "hold" in acts
        # reruns of summary() must not double-settle storage
        s2 = eng.summary()
        assert max(tel.check(s2).values()) <= 1e-9
        _same(s2.as_dict(), js.as_dict(), "summary")

    def test_token_identity_and_same_launches(self, small, monkeypatch):
        calls = _counting_plain(monkeypatch)

        def run(tel):
            for k in calls:
                calls[k] = 0
            eng = _engine(small, telemetry=tel)
            _drain(eng, _requests(small[2].vocab), Request)
            return (eng.records, eng.summary().as_dict(), dict(calls),
                    dict(eng.jit_stats.calls), dict(eng.fused_jit.calls))

        on, off = run(Telemetry()), run(None)
        assert [r.tokens for r in on[0]] == [r.tokens for r in off[0]]
        assert [r.compute_cost for r in on[0]] == [r.compute_cost for r in off[0]]
        assert on[0] == off[0]
        assert on[1] == off[1]
        assert on[2] == off[2] and on[2]["packed_flash_attention"] > 0, on[2]
        assert on[2]["decode_attention"] > 0
        assert on[3:] == off[3:]

    def test_migration_entries_are_zero_dollar(self):
        tel, jtel = Telemetry(), jobs.Telemetry()
        kw = dict(t_s=1.0, req_id=-1, entry_id="ctx0", from_tier="host_dram",
                  to_tier="s3", nbytes=1e6, reason="demote")
        tel.on_events([ev.TierMigrated(**kw)])
        jtel.on_events([jev.TierMigrated(**kw)])
        _same_ledger(tel.ledger, jtel.ledger)
        _same_snapshot(tel.registry.snapshot(), jtel.registry.snapshot())
        mig = [e for e in tel.ledger.all_entries() if e.activity == "migration"]
        assert len(mig) == 1
        assert mig[0].dollars == 0.0 and mig[0].nbytes == 1e6
        assert tel.ledger.totals()["transfer"] == 0.0

    def test_collect_engine_absorbs_counters(self, served):
        eng, tel, _, s, _ = served["port"]
        jeng, jtel, _, js, _ = served["ref"]
        tel.collect_engine(eng)
        jtel.collect_engine(jeng)
        _same_snapshot(tel.registry.snapshot(), jtel.registry.snapshot())
        reg = tel.registry
        assert reg.get("jit_cache_misses").value(replica="0", path="packed") == \
            eng.jit_stats.misses
        assert reg.get("store_entries") is not None
        assert reg.get("kv_cache_hit_rate").value() == pytest.approx(s.reuse_hits / s.n_requests)
        text = reg.to_prometheus()
        assert "jit_bucket_calls" in text and "tier_used_gb" in text
        # the dashboard renders the reference's lines and the conservation line
        out = render(tel, s)
        assert "conservation vs summary: OK" in out
        _same_console(out, jrender(jtel, js))


# --------------------------------------------------------------------------- #
# Span trees + Chrome trace export
# --------------------------------------------------------------------------- #
class TestSpans:
    def test_request_tree_shape(self, served):
        _, _, events, _, _ = served["port"]
        _, _, jevents, _, _ = served["ref"]
        roots = build_spans(events)
        _same(roots, jobs.build_spans(jevents), "spans")
        reqs = [s for s in roots if s.name.startswith("request #")]
        assert len(reqs) == 6
        for root in reqs:
            names = [c.name.split(":")[0] for c in root.children]
            assert names[0] == "queue"
            assert "plan" in names and "prefill" in names and "decode" in names
            # children are time-ordered and inside the root envelope
            for c in root.children:
                assert root.start_s - 1e-12 <= c.start_s
                assert c.end_s <= root.end_s + 1e-12
            decode = next(c for c in root.children if c.name == "decode")
            assert decode.attrs["tokens"] == 4
        loaded = [s for r in reqs for s in r.children if s.name.startswith("fetch:")]
        assert loaded, "reused requests must carry per-tier fetch spans"

    def test_chrome_trace_export(self, served, tmp_path):
        _, _, events, _, _ = served["port"]
        _, _, jevents, _, _ = served["ref"]
        doc = chrome_trace(build_spans(events))
        _same(json.loads(json.dumps(doc)),
              json.loads(json.dumps(jobs.chrome_trace(jobs.build_spans(jevents)))), "chrome")
        evs = doc["traceEvents"]
        assert any(e["ph"] == "M" for e in evs)  # process metadata
        xs = [e for e in evs if e["ph"] == "X"]
        assert xs and all(e["dur"] >= 0 for e in xs)
        assert {e["pid"] for e in evs} == {0}
        assert any(e["tid"] == 1 for e in xs)  # req 0 on lane 1 (0 = infra)
        p = tmp_path / "trace.json"
        write_chrome_trace(p, build_spans(events))
        assert json.loads(p.read_text()) == json.loads(json.dumps(doc))


# --------------------------------------------------------------------------- #
# Cluster: conservation per replica + cluster-level activities
# --------------------------------------------------------------------------- #
def _cluster(small, telemetry=None, trace=None, n=2, port=True, router=None, faults=None,
             retry=None):
    """``tests/test_obs.py``'s ``_cluster`` on one package."""
    jcfg, jparams, cfg, params = small
    mod, hier = (pserving, phierarchy) if port else (jserving, jhierarchy)
    specs = [hier.TierSpec("host_dram", 1.0), hier.TierSpec("s3", 1.0)]
    kw = dict(pricing=FEE_PRICING, perf=PM, device="cpu") if port else dict(
        pricing=J_FEE_PRICING, perf=JPM)
    return mod.ServingCluster(
        cfg if port else jcfg, params if port else jparams,
        cluster_cfg=mod.ClusterConfig(n_replicas=n, gossip_interval_s=0.05,
                                      rebalance_interval_s=0.05, rebalance_min_hits=1),
        engine_cfg=mod.EngineConfig(max_slots=2, tier_specs=specs, store_tier="host_dram",
                                    cost_arch="llama-7b", faults=faults, retry_policy=retry),
        router=router, planner_factory=mod.AlwaysReusePlanner, telemetry=telemetry,
        trace=trace, **kw)


def _serve_cluster(small, path, n_reqs, port, n_ctx=2, **kw):
    """One cluster run with telemetry and a trace: (cluster, telemetry,
    summary, trace path)."""
    tel = Telemetry() if port else jobs.Telemetry()
    tw = (TraceWriter if port else jtrace.TraceWriter)(path)
    cl = _cluster(small, telemetry=tel, trace=tw, port=port, **kw)
    for r in _requests(small[2].vocab, n=n_reqs, n_ctx=n_ctx):
        cl.submit((Request if port else jserving.Request)(**r))
    cs = cl.run()
    tw.close()
    return cl, tel, cs, path


@pytest.fixture(scope="module")
def cluster_served(small, tmp_path_factory):
    """``tests/test_obs.py``'s two-replica affinity cluster (10 requests),
    telemetry on and a trace written, on both packages."""
    d = tmp_path_factory.mktemp("cluster")
    return {side: _serve_cluster(small, d / f"{side}.jsonl", 10, side == "port")
            for side in ("port", "ref")}


class TestClusterTelemetry:
    def test_per_replica_conservation(self, cluster_served):
        cl, tel, cs, _ = cluster_served["port"]
        jcl, jtel, jcs, _ = cluster_served["ref"]
        residuals = tel.check_cluster(cs)
        assert set(residuals) == {0, 1}
        for per_cat in residuals.values():
            assert max(per_cat.values()) <= 1e-9
        _same_ledger(tel.ledger, jtel.ledger)
        acts = tel.ledger.by_activity()
        assert "gossip" in acts and acts["gossip"] == 0.0
        if cl.rebalances:
            assert "rebalance" in acts
        tel.collect_cluster(cl)
        jtel.collect_cluster(jcl)
        _same_snapshot(tel.registry.snapshot(), jtel.registry.snapshot())
        assert tel.registry.get("cluster_gossip_ticks").value() == cl.gossip_ticks
        assert tel.registry.get("router_decisions").value() == 10

    def test_routed_events_reach_telemetry_once(self, cluster_served):
        cl, tel, _, _ = cluster_served["port"]
        routed_tel = [e for _, e in tel.events if isinstance(e, ev.RequestRouted)]
        routed_live = [e for _, e in cl.events if isinstance(e, ev.RequestRouted)]
        assert routed_tel == routed_live  # fed exactly once, same order
        fin_tel = [e for _, e in tel.events if isinstance(e, ev.RequestFinished)]
        assert len(fin_tel) == 10
        # telemetry saw the cluster's stream, every event once, in its order
        assert tel.events == cl.events
        _same(tel.events, cluster_served["ref"][1].events, "telemetry events")

    def test_round_robin_rebalance_and_crash_conserve(self, small, tmp_path):
        """Round robin over three contexts, with rebalancing every 0.05 s
        and replica 1 crashing at 0.1 s, on both packages: conservation per
        replica at 1e-9, the ledger (rebalance and gossip entries among
        them) equal to the reference's, and every crash seen by the
        telemetry once."""
        sides = {}
        for side, mod in (("port", faults), ("ref", jfaults)):
            inj = mod.FaultInjector(seed=3)
            inj.schedule_crash(1, 0.1)
            router = (RoundRobinRouter if side == "port" else jserving.RoundRobinRouter)()
            sides[side] = _serve_cluster(small, tmp_path / f"{side}.jsonl", 10, side == "port",
                                         n_ctx=3, router=router, faults=inj)
        cl, tel, cs, path = sides["port"]
        jcl, jtel, jcs, jpath = sides["ref"]
        assert [r.tokens for r in sorted(cl.records, key=lambda r: r.req_id)] == \
            [r.tokens for r in sorted(jcl.records, key=lambda r: r.req_id)]
        for per_cat in tel.check_cluster(cs).values():
            assert max(per_cat.values()) <= 1e-9
        _same_ledger(tel.ledger, jtel.ledger)
        assert cl.rebalances > 0 and "rebalance" in tel.ledger.by_activity()
        crashed = [e for _, e in tel.events if isinstance(e, ev.ReplicaCrashed)]
        assert len(crashed) == 1 and crashed == [
            e for _, e in cl.events if isinstance(e, ev.ReplicaCrashed)]
        assert tel.events == cl.events
        _same_lines(path, jpath)
        assert cluster_audit_from_trace(path) == cluster_audit(cl.events_by_replica)


# --------------------------------------------------------------------------- #
# Trace schema + replay parity
# --------------------------------------------------------------------------- #
HEADER = {"__trace__": {"version": 1, "format": "repro.serving.events"}}


class TestTraceSchema:
    def test_header_written_and_hidden(self, tmp_path):
        p, jp = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
        with TraceWriter(p) as tw:
            tw.write(ev.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0))
        with jtrace.TraceWriter(jp) as tw:
            tw.write(jev.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0))
        assert p.read_bytes() == jp.read_bytes()  # the reference's header and line
        lines = p.read_text().splitlines()
        assert json.loads(lines[0]) == HEADER
        tr = read_trace(p)
        assert len(tr) == 1 and tr[0]["event"] == "ClockAdvanced"
        assert tr.header == {"version": 1, "format": "repro.serving.events"}

    def test_append_inherits_header(self, tmp_path):
        p = tmp_path / "t.jsonl"
        with TraceWriter(p) as tw:
            tw.write(ev.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0))
        with TraceWriter(p, append=True) as tw:
            tw.write(ev.ClockAdvanced(t_s=2.0, req_id=-1, to_s=2.0))
        text = p.read_text()
        assert text.count("__trace__") == 1
        assert len(read_trace(p)) == 2
        assert len(jtrace.read_trace(p)) == 2

    def test_legacy_headerless_trace_reads(self, tmp_path):
        p = tmp_path / "t.jsonl"
        p.write_text(json.dumps({"event": "ClockAdvanced", "t_s": 1.0, "req_id": -1,
                                 "to_s": 1.0}) + "\n")
        tr = read_trace(p)
        assert len(tr) == 1 and tr.header is None
        assert read_events(p) == [ev.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0)]

    def test_numpy_scalars_serialize_deterministically(self, tmp_path):
        p, jp = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
        kw = dict(arr=np.arange(3), flag=np.bool_(True), blob=b"\x01\x02")
        fields = dict(t_s=np.float64(1.25), req_id=np.int64(3), token=np.int32(17), index=0)
        with TraceWriter(p) as tw:
            tw.write(ev.TokenEmitted(**fields), **kw)
        with jtrace.TraceWriter(jp) as tw:
            tw.write(jev.TokenEmitted(**fields), **kw)
        assert p.read_bytes() == jp.read_bytes()
        d = read_trace(p)[0]
        assert d["t_s"] == 1.25 and d["req_id"] == 3 and d["token"] == 17
        assert d["arr"] == [0, 1, 2] and d["flag"] is True
        assert d["blob"] == "0102"

    def test_tensor_serializes(self, tmp_path):
        """In place of the reference's jax-array case: a torch tensor leaf
        (f32 and bf16, on the CPU) serializes as its values."""
        p = tmp_path / "t.jsonl"
        with TraceWriter(p) as tw:
            tw.write(ev.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0),
                     dev=torch.tensor([1, 2]),
                     f32=torch.tensor([0.5, -1.25], dtype=torch.float32),
                     bf16=torch.tensor([[1.0078125, 3.0]], dtype=torch.bfloat16))
        d = read_trace(p)[0]
        assert d["dev"] == [1, 2]
        assert d["f32"] == [0.5, -1.25]
        assert d["bf16"] == [[1.0078125, 3.0]]


class TestReplayParity:
    def test_engine_replay_matches_live(self, served):
        eng, _, live, s, p = served["port"]
        replayed = read_events(p)
        assert replayed == live  # typed events rebuild exactly
        rs = summarize_events(replayed, storage_cost=s.storage_cost,
                              transfer_cost=s.transfer_cost)
        assert rs == s
        assert audit(replayed) == audit(live)
        assert audit_from_trace(p) == audit(live)
        assert build_spans(replayed) == build_spans(live)

    def test_cluster_replay_matches_live(self, cluster_served):
        cl, _, _, p = cluster_served["port"]
        tagged = read_tagged_events(p)
        assert tagged == cl.events
        assert build_cluster_spans(tagged) == build_cluster_spans(cl.events)
        n = len(cl.replicas)
        streams = [[] for _ in range(n)]
        for rep, e in tagged:
            streams[rep].append(e)
        assert cluster_audit(streams) == cluster_audit(cl.events_by_replica)
        assert cluster_audit_from_trace(p) == cluster_audit(cl.events_by_replica)


class TestCrossPackageTraces:
    def test_engine_traces_equal_line_by_line(self, served):
        assert _same_lines(served["port"][4], served["ref"][4]) > 1

    def test_cluster_traces_equal_line_by_line(self, cluster_served):
        assert _same_lines(cluster_served["port"][3], cluster_served["ref"][3]) > 1

    def test_reference_reads_the_port_trace(self, served):
        """The reference's ``read_events`` on the port's trace gives the
        reference's live summary, audit and span trees."""
        _, _, jlive, js, _ = served["ref"]
        replayed = jtrace.read_events(served["port"][4])
        _same(replayed, jlive, "events")
        _same(jmetrics.summarize_events(replayed, storage_cost=js.storage_cost,
                                        transfer_cost=js.transfer_cost).as_dict(),
              js.as_dict(), "summary")
        _same(jaudit.audit(replayed), jaudit.audit(jlive), "audit")
        _same(jobs.build_spans(replayed), jobs.build_spans(jlive), "spans")

    def test_port_reads_the_reference_trace(self, served):
        _, _, live, s, _ = served["port"]
        replayed = read_events(served["ref"][4])
        _same(replayed, live, "events")
        _same(summarize_events(replayed, storage_cost=s.storage_cost,
                               transfer_cost=s.transfer_cost).as_dict(), s.as_dict(), "summary")
        assert audit(replayed) == audit(live)
        assert build_spans(replayed) == build_spans(live)
        # and the port's audit and spans equal the reference's
        _same(audit(live), jaudit.audit(served["ref"][2]), "audit vs reference")

    def test_cluster_traces_cross(self, cluster_served):
        cl, _, _, p = cluster_served["port"]
        jcl, _, _, jp = cluster_served["ref"]
        _same(jtrace.read_tagged_events(p), jcl.events, "reference reads port")
        _same(read_tagged_events(jp), cl.events, "port reads reference")
        _same(jobs.build_cluster_spans(jtrace.read_tagged_events(p)),
              jobs.build_cluster_spans(jcl.events), "reference spans")
        _same(build_cluster_spans(read_tagged_events(jp)), build_cluster_spans(cl.events),
              "port spans")
        _same(build_cluster_spans(cl.events), jobs.build_cluster_spans(jcl.events),
              "spans vs reference")
        _same(jaudit.cluster_audit_from_trace(p), jaudit.cluster_audit(jcl.events_by_replica),
              "reference audit of the port trace")
        _same(cluster_audit_from_trace(jp), cluster_audit(cl.events_by_replica),
              "port audit of the reference trace")

    def test_audit_tables_and_slo_summary(self, small, served, cluster_served):
        reqs = [dict(r, slo_ttft_s=0.1) for r in _requests(small[2].vocab)]
        rows = audit(served["port"][2], [Request(**r) for r in reqs])
        jrows = jaudit.audit(served["ref"][2], [jserving.Request(**r) for r in reqs])
        _same(rows, jrows, "rows")
        assert [r.slo_met for r in rows] == [r.slo_met for r in jrows]
        assert slo_summary(rows) == jaudit.slo_summary(jrows)
        assert {True, False} <= {r.slo_met for r in rows}
        _same_console(format_table(rows), jaudit.format_table(jrows))
        by_rep = cluster_audit(cluster_served["port"][0].events_by_replica)
        jby_rep = jaudit.cluster_audit(cluster_served["ref"][0].events_by_replica)
        _same_console(format_cluster_table(by_rep), jaudit.format_cluster_table(jby_rep))


# --------------------------------------------------------------------------- #
# Empty-records summaries report NaN, not 0.0
# --------------------------------------------------------------------------- #
class TestEmptySummaryNaN:
    def test_summarize_empty_is_nan(self):
        s = summarize([], storage_cost=0.0, transfer_cost=0.0)
        assert s.n_requests == 0
        for v in (s.mean_ttft_s, s.p50_ttft_s, s.p99_ttft_s, s.mean_e2e_s, s.p99_e2e_s):
            assert np.isnan(v), "empty runs must not report fake 0.0 latency"
        assert s.compute_cost == 0.0  # costs ARE zero, latency is unknown
        _same(s.as_dict(), jmetrics.summarize([], storage_cost=0.0,
                                              transfer_cost=0.0).as_dict(), "summary")

    def test_summarize_events_empty_is_nan(self):
        s = summarize_events([], storage_cost=0.0, transfer_cost=0.0)
        assert np.isnan(s.mean_ttft_s) and np.isnan(s.p99_e2e_s)
        _same(s.as_dict(), jmetrics.summarize_events([], storage_cost=0.0,
                                                     transfer_cost=0.0).as_dict(), "summary")

    def test_idle_replica_does_not_poison_cluster_mean(self, served):
        busy = served["port"][3]
        idle = summarize([], storage_cost=0.0, transfer_cost=0.0)
        cs = ClusterSummary(replicas=[busy, idle])
        assert np.isfinite(cs.mean_ttft_s)
        assert cs.mean_ttft_s == pytest.approx(busy.mean_ttft_s)
