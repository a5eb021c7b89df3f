"""The port's serving engine replays the JAX engine's fused-reuse scenarios.

``EngineConfig(fusion_enabled=True)`` with a ``BlendPlanner``: a context
whose stored chunks come back in another order is admitted ``"fused"``,
through one selective-recompute launch (dense or paged decode) or through
the unified step's chunked launches.  Each scenario of
``tests/test_fusion.py:393-473`` and ``tests/test_unified.py:197-272`` runs
on both engines with the same weights (reduced llama-7b, f32, CPU) and the
reference's hardware and prices rebuilt for the port, and must give
identical tokens and actions, every record field, summary key and
``fused_stats`` entry at 1e-9, and the same typed event stream, field by
field at 1e-9.  A source whose backend fails every read degrades the fused
admission to exact recompute on both engines alike.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.core.perf_model import PerfModel as JPerfModel  # noqa: E402
from repro.core.perf_model import tpu_v5e  # noqa: E402
from repro.core.pricing import tpu_v5e_pod  # noqa: E402
from repro.kvcache import backend as jbackend  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import transfer as jtransfer  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro_torch.kvcache import backend  # noqa: E402
from repro_torch.kvcache import faults, transfer  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AlwaysReusePlanner,
    BlendPlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from repro_torch.serving import events as ev  # noqa: E402
from test_torch_engine import _reference_perf_and_pricing, _setup  # noqa: E402

torch.set_num_threads(1)
CHUNK = 16
TOL = 1e-9


def _shuffled_requests(vocab, seed, perms=([2, 0, 3, 1], [3, 2, 1, 0], [1, 3, 0, 2]),
                       new=3, reuses=4):
    """One canonical-order request (recomputed, stores the chunks), then
    requests with the chunks reordered arriving later against the warm store
    (``tests/test_fusion.py:_shuffled_requests``, from the same seeds)."""
    rng = np.random.default_rng(seed)
    pool = [list(map(int, rng.integers(0, vocab, CHUNK))) for _ in range(4)]
    reqs = [dict(req_id=0, context_tokens=sum(pool, []),
                 prompt_tokens=list(map(int, rng.integers(0, vocab, 8))),
                 max_new_tokens=new, arrival_s=0.0, expected_reuses=reuses)]
    for i, p in enumerate(perms):
        reqs.append(dict(req_id=i + 1, context_tokens=sum((pool[j] for j in p), []),
                         prompt_tokens=list(map(int, rng.integers(0, vocab, 8))),
                         max_new_tokens=new, arrival_s=30.0, expected_reuses=reuses))
    return reqs


class _FailingStore(backend.ObjectStoreBackend):
    """An object store whose every read fails (retryably)."""

    def get(self, key, *, nbytes=None, charge=True):
        raise faults.TierUnavailable("read refused", tier=self.name, key=key, delay_s=0.002,
                                     reason="injected")


class _JFailingStore(jbackend.ObjectStoreBackend):
    """The reference's object store, every read failing the same way."""

    def get(self, key, *, nbytes=None, charge=True):
        raise jfaults.TierUnavailable("read refused", tier=self.name, key=key, delay_s=0.002,
                                      reason="injected")


def _engines(llama, planner, *, failing=False, **ec_kw):
    """The port's engine and the JAX engine on the same weights, config and
    modelled hardware; with ``failing``, the store tier ``io2`` refuses
    every read on both, and a retry policy without the cost gate retries
    each read up to its attempt limit."""
    jcfg, jparams, cfg, params = llama
    kw = {**dict(max_slots=2, max_len=128, chunk_tokens=CHUNK), **ec_kw}
    perf, pricing = _reference_perf_and_pricing()
    jperf, jpricing = JPerfModel(tpu_v5e(8, hosts=1)), tpu_v5e_pod(8)
    extra, jextra, policy, jpolicy = {}, {}, {}, {}
    if failing:
        policy = dict(retry_policy=faults.RetryPolicy(cost_aware=False))
        jpolicy = dict(retry_policy=jfaults.RetryPolicy(cost_aware=False))
        clock, jclock = transfer.SimClock(), jtransfer.SimClock()
        tm = transfer.TransferModel(perf, pricing)
        jtm = jtransfer.TransferModel(jperf, jpricing)
        extra = dict(clock=clock, transfer=tm, backends={
            "host_dram": backend.HostMemoryBackend("host_dram", transfer=tm, clock=clock),
            "io2": _FailingStore("io2", transfer=tm, clock=clock)})
        jextra = dict(clock=jclock, transfer=jtm, backends={
            "host_dram": jbackend.HostMemoryBackend("host_dram", transfer=jtm, clock=jclock),
            "io2": _JFailingStore("io2", transfer=jtm, clock=jclock)})
    port_planner, jplanner = planner
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**kw, **policy),
                        planner=port_planner(),
                        perf=perf, pricing=pricing, device="cpu", **extra)
    jeng = jserving.ServingEngine(jcfg, jparams,
                                  engine_cfg=jserving.EngineConfig(**kw, **jpolicy),
                                  planner=jplanner(), perf=jperf, pricing=jpricing, **jextra)
    return eng, jeng


def _blend(r):
    return (lambda: BlendPlanner(recompute_frac=r, always=True),
            lambda: jserving.BlendPlanner(recompute_frac=r, always=True))


def _serve(eng, make_req, reqs):
    for r in reqs:
        eng.submit(make_req(**r))
    events = []
    while not eng.idle:
        events.extend(eng.step())
    return events


def _tree(x):
    """A dataclass tree as nested (class name, fields) for comparison."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _tree(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (np.generic,)):
        return x.item()
    return x


def _assert_close(got, want, path="."):
    if isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, abs=TOL), path
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def _assert_replays(eng, events, jeng, jevents):
    """Tokens, actions, every record, the summary, the fused counters and
    the typed event stream of the port equal the JAX engine's."""
    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert [(r.req_id, r.action, r.tokens) for r in recs] == [
        (r.req_id, r.action, r.tokens) for r in jrecs]
    _assert_close(_tree(recs), _tree(jrecs), "records")
    _assert_close(eng.summary().as_dict(), jeng.summary().as_dict(), "summary")
    _assert_close(eng.fused_stats(), jeng.fused_stats(), "fused_stats")
    _assert_close(_tree(events), _tree(jevents), "events")
    assert all(e.pins == 0 for e in eng.store.entries.values())


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


@pytest.mark.parametrize("paged_decode", [False, True])
def test_engine_fused_r1_matches_recompute_bitwise(llama, paged_decode):
    """Shuffled-chunk requests served fused at recompute_frac 1.0 generate
    token for token what full recompute generates, under dense and paged
    decode, and replay the JAX engine exactly."""
    _, _, cfg, _ = llama
    reqs = _shuffled_requests(cfg.vocab, seed=1, reuses=4)
    eng, jeng = _engines(llama, _blend(1.0), fusion_enabled=True, paged_decode=paged_decode)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    base, _ = _engines(llama, (AlwaysReusePlanner, jserving.AlwaysReusePlanner),
                       reuse_enabled=False, paged_decode=paged_decode)
    _serve(base, Request, reqs)
    assert {r.req_id: r.tokens for r in eng.records} == {
        r.req_id: r.tokens for r in base.records}
    acts = {r.req_id: r.action for r in eng.records}
    assert acts[0] == "recompute" and all(acts[i] == "fused" for i in (1, 2, 3))
    fused = [e for e in events if isinstance(e, ev.FusedAdmitted)]
    assert len(fused) == 3
    assert all(e.reused_tokens == 0 and e.n_sources == 0 for e in fused)
    stats = eng.fused_stats()
    assert stats["enabled"] and stats["admissions"] == 3
    assert stats["recompute_tokens"] == 3 * 4 * CHUNK
    _assert_replays(eng, events, jeng, jevents)
    if paged_decode:
        eng._paged.audit()
        assert eng._paged.pool.n_used == 0


@pytest.mark.parametrize("paged_decode,compress_tier", [
    pytest.param(False, None, id="False"), pytest.param(True, None, id="True"),
    pytest.param(False, "io2", id="False-int8"), pytest.param(True, "io2", id="True-int8"),
])
def test_engine_fused_partial_counts_and_events_consistent(llama, paged_decode, compress_tier):
    """r < 1: fused admissions fetch their sources (from the int8 tier too,
    dequantised before delta-RoPE), reuse + recompute partition every
    context, the counters agree with the event stream, the summary counts
    fused admissions as reuse hits, and the whole serve replays the JAX
    engine."""
    _, _, cfg, _ = llama
    reqs = _shuffled_requests(cfg.vocab, seed=4)
    eng, jeng = _engines(llama, _blend(0.25), fusion_enabled=True, paged_decode=paged_decode,
                         compress_tier=compress_tier)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    fused = [e for e in events if isinstance(e, ev.FusedAdmitted)]
    assert len(fused) == 3
    for e in fused:
        assert e.reused_tokens > 0 and e.n_sources >= 1
        assert e.reused_tokens + e.recompute_tokens == 4 * CHUNK
    stats = eng.fused_stats()
    assert stats["admissions"] == 3 and stats["busy_s"] > 0
    assert stats["reused_tokens"] == sum(e.reused_tokens for e in fused)
    assert stats["recompute_tokens"] == sum(e.recompute_tokens for e in fused)
    assert stats["sources"] == sum(e.n_sources for e in fused)
    assert len([e for e in events if isinstance(e, ev.KVLoaded)]) == stats["sources"]
    recs = {r.req_id: r for r in eng.records}
    for i in (1, 2, 3):
        assert recs[i].action == "fused" and recs[i].plan.fused is not None
        assert recs[i].matched_tokens == recs[i].plan.fused.reused_tokens
    assert eng.summary().reuse_hits >= 3
    times = [e.t_s for e in events]
    assert times == sorted(times)
    _assert_replays(eng, events, jeng, jevents)


def test_engine_fusion_disabled_never_fuses(llama):
    """fusion_enabled=False: the BlendPlanner sees no composite and plans as
    its base planner; no fused events, no fused counters, as the reference."""
    _, _, cfg, _ = llama
    reqs = _shuffled_requests(cfg.vocab, seed=4)
    eng, jeng = _engines(llama, _blend(0.25), fusion_enabled=False)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    assert not [e for e in events if isinstance(e, ev.FusedAdmitted)]
    assert eng.fused_stats()["admissions"] == 0 and not eng.fused_stats()["enabled"]
    assert all(r.action != "fused" for r in eng.records)
    _assert_replays(eng, events, jeng, jevents)


def test_unified_fused_r1_matches_recompute(llama):
    """Fused at recompute_frac 1.0 inside the unified step: the fused
    query stream lands through the chunked launches and generates token for
    token what full recompute generates; the serve replays the reference's,
    whose ``FusedAdmitted`` names the stream length and the landed rows."""
    _, _, cfg, _ = llama
    reqs = _shuffled_requests(cfg.vocab, seed=5, reuses=1)
    kw = dict(paged_decode=True, chunk_tokens=16, max_slots=2)
    eng, jeng = _engines(llama, _blend(1.0), fusion_enabled=True, unified_step=True, **kw)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    base, _ = _engines(llama, (AlwaysReusePlanner, jserving.AlwaysReusePlanner),
                       reuse_enabled=False, **kw)
    _serve(base, Request, reqs)
    assert {r.req_id: r.tokens for r in eng.records} == {
        r.req_id: r.tokens for r in base.records}
    acts = {r.req_id: r.action for r in eng.records}
    assert acts[0] == "recompute" and all(acts[i] == "fused" for i in (1, 2, 3))
    fused = [e for e in events if isinstance(e, ev.FusedAdmitted)]
    assert len(fused) == 3
    assert all(e.reused_tokens == 0 and e.n_sources == 0 and e.jit_hit for e in fused)
    assert all(e.q_len == 4 * CHUNK + 8 == e.kv_len for e in fused)
    _assert_replays(eng, events, jeng, jevents)
    _assert_close(eng.unified_stats(), jeng.unified_stats(), "unified_stats")
    eng._paged.audit()
    assert eng._paged.pool.n_used == 0


def test_unified_fused_partial_reuses_sources(llama):
    """r < 1 inside the unified step: sources are fetched and pinned, their
    rows land in the pool before the first chunk, reuse + recompute
    partition every context, and the serve replays the reference's."""
    _unified_fused_partial(llama)


def test_unified_fused_partial_reuses_int8_sources(llama):
    """The same with the sources stored in the int8 tier: each source is
    dequantised before its rows are delta-RoPE'd into the pool."""
    eng = _unified_fused_partial(llama, compress_tier="io2")
    assert all(e.compressed for e in eng.store.entries.values())


def _unified_fused_partial(llama, **ec_kw):
    _, _, cfg, _ = llama
    reqs = _shuffled_requests(cfg.vocab, seed=6, perms=([2, 0, 3, 1], [3, 2, 1, 0]),
                              reuses=1)
    eng, jeng = _engines(llama, _blend(0.25), fusion_enabled=True, unified_step=True,
                         paged_decode=True, **ec_kw)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    fused = [e for e in events if isinstance(e, ev.FusedAdmitted)]
    assert len(fused) == 2
    for e in fused:
        assert e.reused_tokens > 0 and e.n_sources >= 1
        assert e.reused_tokens + e.recompute_tokens == 4 * CHUNK
    stats = eng.fused_stats()
    assert stats["admissions"] == 2
    assert stats["reused_tokens"] == sum(e.reused_tokens for e in fused)
    _assert_replays(eng, events, jeng, jevents)
    _assert_close(eng.unified_stats(), jeng.unified_stats(), "unified_stats")
    eng._paged.audit()
    assert eng._paged.pool.n_used == 0
    return eng


@pytest.mark.parametrize("mode", ["dense", "paged", "unified"])
def test_failed_fused_source_degrades_to_recompute(llama, mode):
    """Every read of the store tier fails: each fused admission retries its
    source under the retry policy, then degrades to exact recompute.  The
    tokens are recompute's, the pins are released, and records, events and
    counters replay the reference's (which fails the same way)."""
    _, _, cfg, _ = llama
    reqs = _shuffled_requests(cfg.vocab, seed=4)
    ec = {"dense": {}, "paged": dict(paged_decode=True),
          "unified": dict(paged_decode=True, unified_step=True)}[mode]
    eng, jeng = _engines(llama, _blend(0.25), failing=True, fusion_enabled=True, **ec)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    degraded = [e for e in events if isinstance(e, ev.DegradedToRecompute)]
    assert len(degraded) == 3 and all(e.reason == "fused_source_failed" for e in degraded)
    assert [e for e in events if isinstance(e, ev.FetchFailed)]
    assert [e for e in events if isinstance(e, ev.FetchRetried)]
    assert not [e for e in events if isinstance(e, ev.FusedAdmitted)]
    assert all(r.degraded and r.action == "recompute" for r in eng.records if r.req_id > 0)
    base, _ = _engines(llama, (AlwaysReusePlanner, jserving.AlwaysReusePlanner),
                       reuse_enabled=False, **ec)
    _serve(base, Request, reqs)
    assert {r.req_id: r.tokens for r in eng.records} == {
        r.req_id: r.tokens for r in base.records}
    _assert_replays(eng, events, jeng, jevents)
    assert len([e for e in jevents if isinstance(e, jev.DegradedToRecompute)]) == 3


@pytest.mark.parametrize("mode", ["dense", "paged", "unified"])
def test_fused_serve_with_overlap_and_prefetch_replays(llama, mode):
    """``overlap_load`` and ``prefetch_lookahead`` beside fused admissions:
    each fused source's KVLoaded carries the delay charged after the
    overlap (the unified intake charges the whole fetch, as the reference),
    the carried prefetch walks are released on every fused exit, and the
    serve replays the reference's."""
    _, _, cfg, _ = llama
    reqs = _shuffled_requests(cfg.vocab, seed=4)
    ec = {"dense": {}, "paged": dict(paged_decode=True),
          "unified": dict(paged_decode=True, unified_step=True)}[mode]
    eng, jeng = _engines(llama, _blend(0.25), fusion_enabled=True, overlap_load=True,
                         prefetch_lookahead=2, cost_arch="llama-7b", **ec)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    assert len([e for e in events if isinstance(e, ev.FusedAdmitted)]) == 3
    _assert_replays(eng, events, jeng, jevents)
    plain, _ = _engines(llama, _blend(0.25), fusion_enabled=True, cost_arch="llama-7b", **ec)
    plain_events = _serve(plain, Request, reqs)
    loads = [e.load_s for e in events if isinstance(e, ev.KVLoaded)]
    plain_loads = [e.load_s for e in plain_events if isinstance(e, ev.KVLoaded)]
    assert len(loads) == len(plain_loads) > 0
    if mode == "unified":
        assert loads == plain_loads
    else:
        assert all(x <= y for x, y in zip(loads, plain_loads))
        assert any(x < y for x, y in zip(loads, plain_loads))
    assert not eng._prefetch_pins and not eng._prefetch_lookup
