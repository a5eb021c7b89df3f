"""The engine's latency-hiding and migration options on the port, against the
JAX engine.

Replays the reference's own tests of ``prefetch_lookahead`` (with its
eviction pins and its carried trie walk), the clock-driven migration pass
(``migration_interval_s``, through idle gaps too) and hedged reads: each
scenario runs the port's ``ServingEngine`` (reduced llama-7b on the CPU,
weights converted from the reference's) and the JAX engine on the same
requests, and holds the port's records, summary, store entries and typed
events to the reference's at 1e-9, tokens exact, under dense, paged and
unified decode where the reference test allows it; then the reference
test's own assertions run on the port.  The audit table of
``test_engine_migrations_demote_cold_entries_and_audit`` waits for the
port's audit module; its migration half is here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.perf_model import PerfModel as JPerfModel  # noqa: E402
from repro.core.perf_model import V100_X4_HF as JV100_X4_HF  # noqa: E402
from repro.core.pricing import AWS_PAPER as JAWS_PAPER  # noqa: E402
from repro.kvcache import backend as jbackend  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro.kvcache import transfer as jtransfer  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch.core.perf_model import V100_X4_HF, PerfModel  # noqa: E402
from repro_torch.core.pricing import AWS_PAPER, GB  # noqa: E402
from repro_torch.kvcache.backend import ObjectStoreBackend  # noqa: E402
from repro_torch.kvcache.hierarchy import TierSpec  # noqa: E402
from repro_torch.kvcache.transfer import TransferModel  # noqa: E402
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.scheduler import HedgePolicy  # noqa: E402
from test_hierarchy import check_invariants  # noqa: E402
from test_torch_engine import _replay_on_both, _requests, _setup  # noqa: E402

torch.set_num_threads(1)
DECODE = {"dense": {}, "paged": dict(paged_decode=True),
          "unified": dict(paged_decode=True, unified_step=True)}
PAPER = dict(perf=(PerfModel(V100_X4_HF), JPerfModel(JV100_X4_HF)),
             pricing=(AWS_PAPER, JAWS_PAPER))


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


def _tiers(*specs):
    """The same tier hierarchy in each package: (port kwargs, JAX kwargs)."""
    return ([TierSpec(*s) if len(s) == 2 else TierSpec(s[0], s[1], concurrency=s[2])
             for s in specs],
            [jhierarchy.TierSpec(*s) if len(s) == 2
             else jhierarchy.TierSpec(s[0], s[1], concurrency=s[2]) for s in specs])


def _mk_reqs(vocab, ctxs, arrivals, prompt_len=8, new=3):
    """``tests/test_hierarchy.py``'s request builder, as dicts."""
    rng = np.random.default_rng(7)
    return [
        dict(req_id=i, context_tokens=ctx,
             prompt_tokens=list(map(int, rng.integers(0, vocab, prompt_len))),
             max_new_tokens=new, arrival_s=t, expected_reuses=3)
        for i, (ctx, t) in enumerate(zip(ctxs, arrivals))
    ]


def _tokens(eng):
    return {r.req_id: r.tokens for r in eng.records}


@pytest.mark.parametrize("decode", sorted(DECODE))
def test_prefetch_lookahead_reduces_ttft(llama, decode):
    """``test_serving.py::test_prefetch_lookahead_reduces_ttft``: queued
    requests' stored contexts are fetched during earlier requests' service,
    so their TTFT drops to the unfinished remainder, tokens unchanged."""
    reqs = _requests(llama[2].vocab, n=8, n_ctx=2, ctx_len=64)

    def run(prefetch):
        eng, _ = _replay_on_both(llama, reqs, "always", max_slots=1, cost_arch="llama-7b",
                                 prefetch_lookahead=prefetch, **PAPER, **DECODE[decode])
        return eng.summary(), _tokens(eng)

    s_plain, t_plain = run(0)
    s_pre, t_pre = run(4)
    assert t_plain == t_pre
    assert s_pre.mean_ttft_s < s_plain.mean_ttft_s
    assert s_pre.reuse_hits == s_plain.reuse_hits >= 6


@pytest.mark.parametrize("decode", sorted(DECODE))
def test_prefetch_pin_survives_eviction_pressure(llama, decode):
    """``test_hierarchy.py::test_prefetch_pin_survives_eviction_pressure``:
    an entry whose prefetch is in flight is not evicted by another request's
    write-back; the prefetching request still loads, the writer's put is
    rejected, and every pin is released."""
    vocab = llama[2].vocab
    rng = np.random.default_rng(11)
    ctx1 = list(map(int, rng.integers(0, vocab, 64)))
    ctx2 = list(map(int, rng.integers(0, vocab, 64)))
    probe, _ = _replay_on_both(llama, [dict(req_id=0, context_tokens=ctx1,
                                            prompt_tokens=[1, 2, 3], max_new_tokens=1,
                                            arrival_s=0.0)], "always", max_slots=1)
    (entry,) = probe.store.entries.values()
    eng, _ = _replay_on_both(
        llama, _mk_reqs(vocab, [ctx1, ctx2, ctx1], [0.0, 0.0, 0.0]), "always", max_slots=1,
        tier_capacities_gb={"io2": 1.5 * entry.nbytes / GB},  # room for exactly one
        prefetch_lookahead=4, **DECODE[decode])
    actions = {rec.req_id: rec.action for rec in eng.records}
    assert actions == {0: "recompute", 1: "recompute", 2: "load"}
    assert eng.store.rejected_puts >= 1  # the writer could not evict the pinned entry
    assert eng.store.evictions == 0
    assert all(e.pins == 0 for e in eng.store.entries.values())  # all released
    assert not eng._prefetch_pins and not eng._prefetch_ready
    check_invariants(eng.store)


@pytest.mark.parametrize("decode", sorted(DECODE))
def test_engine_migrations_demote_cold_entries(llama, decode):
    """The migration half of ``test_hierarchy.py::
    test_engine_migrations_demote_cold_entries_and_audit``: cold write-backs
    demote to the cheap tier (typed TierMigrated events at their own clock
    time), and a later reuse is served from it."""
    vocab = llama[2].vocab
    rng = np.random.default_rng(5)
    ctxs = [list(map(int, rng.integers(0, vocab, 64))) for _ in range(3)]
    reqs = _mk_reqs(vocab, [ctxs[0], ctxs[1], ctxs[2], ctxs[0]], [0.0, 1.0, 2.0, 3.0])
    for r in reqs:
        r["slo_ttft_s"] = 5.0
    tiers, jtiers = _tiers(("host_dram", 1.0), ("local_nvme", 1.0), ("s3", 1.0, 2))
    eng, events = _replay_on_both(
        llama, reqs, "always", jax_kw=dict(tier_specs=jtiers), max_slots=1,
        tier_specs=tiers, store_tier="host_dram", migration_interval_s=0.25, **DECODE[decode])
    migs = [e for e in events if isinstance(e, ev.TierMigrated)]
    assert migs and all(m.reason == "demote" for m in migs)
    assert {m.to_tier for m in migs} == {"s3"}  # cold: cheapest $/GB-hour wins
    times = [e.t_s for e in events]
    assert times == sorted(times)
    loads = [e for e in events if isinstance(e, ev.KVLoaded)]
    assert [e.tier for e in loads] == ["s3"]  # req 3 reuses ctx0 from the cold tier
    for rec in eng.records:
        assert rec.ttft_s <= 5.0
    check_invariants(eng.store)


@pytest.mark.parametrize("decode", sorted(DECODE))
def test_prefetch_lookup_carried_to_admission(llama, decode):
    """``test_packed.py::test_prefetch_lookup_carried_to_admission``: the
    prefetch pass's trie walk is reused at admission (no double walk) and
    invalidated by store mutation; generations unchanged either way."""
    vocab = llama[2].vocab
    rng = np.random.default_rng(4)
    ctx = list(map(int, rng.integers(0, vocab, 64)))
    reqs = [dict(req_id=i, context_tokens=ctx,
                 prompt_tokens=list(map(int, rng.integers(0, vocab, 8))),
                 max_new_tokens=3, arrival_s=i * 0.01, expected_reuses=8)
            for i in range(8)]
    kw = dict(max_slots=1, cost_arch="llama-7b", **DECODE[decode])
    eng_p, _ = _replay_on_both(llama, reqs, "always", prefetch_lookahead=4, **kw)
    eng_n, _ = _replay_on_both(llama, reqs, "always", **kw)
    assert _tokens(eng_p) == _tokens(eng_n)
    assert eng_p.lookup_reuses > 0
    assert eng_p.lookup_walks + eng_p.lookup_reuses >= len(reqs)
    assert eng_p.lookup_reuses >= eng_n.lookup_reuses == 0
    assert eng_p.packed_stats()["lookup_reuses"] == eng_p.lookup_reuses


def _gap_reqs(vocab, seed, gap_end):
    rng = np.random.default_rng(seed)
    ctx = list(map(int, rng.integers(0, vocab, 64)))
    return [dict(req_id=i, context_tokens=ctx,
                 prompt_tokens=list(map(int, rng.integers(0, vocab, 8))),
                 max_new_tokens=2, arrival_s=t)
            for i, t in enumerate([0.0, gap_end])]


@pytest.mark.parametrize("decode", ["dense", "paged"])
def test_idle_gap_runs_missed_migrations_on_schedule(llama, decode):
    """``test_unified.py::test_idle_gap_runs_missed_migrations_on_schedule``
    (paged there): across a long idle gap every missed migration pass runs at
    its own due time, so the cold entry demotes early in the gap, not in one
    late pass at the next arrival."""
    tiers, jtiers = _tiers(("host_dram", 1.0), ("local_nvme", 1.0), ("s3", 1.0))
    eng, events = _replay_on_both(
        llama, _gap_reqs(llama[2].vocab, 9, 60.0), "always", jax_kw=dict(tier_specs=jtiers),
        max_slots=1, tier_specs=tiers, store_tier="host_dram", migration_interval_s=1.0,
        **DECODE[decode])
    migs = [e for e in events if isinstance(e, ev.TierMigrated)]
    assert migs and all(m.reason == "demote" for m in migs)
    assert migs[0].t_s < 10.0
    times = [e.t_s for e in events]
    assert times == sorted(times)
    loads = [e for e in events if isinstance(e, ev.KVLoaded)]
    assert [e.tier for e in loads] == [migs[-1].to_tier]


def test_idle_gap_migrations_under_unified_step(llama):
    """``test_unified.py::test_idle_gap_migrations_under_unified_step``: the
    same catch-up walk services the unified step's idle jumps."""
    tiers, jtiers = _tiers(("host_dram", 1.0), ("s3", 1.0))
    eng, events = _replay_on_both(
        llama, _gap_reqs(llama[2].vocab, 10, 60.0), "always", jax_kw=dict(tier_specs=jtiers),
        max_slots=1, tier_specs=tiers, store_tier="host_dram", migration_interval_s=1.0,
        **DECODE["unified"])
    migs = [e for e in events if isinstance(e, ev.TierMigrated)]
    assert migs and migs[0].t_s < 10.0
    assert {r.req_id: len(r.tokens) for r in eng.records} == {0: 2, 1: 2}


def test_hedged_object_store_caps_tail():
    """``test_backend.py::test_hedged_object_store_caps_tail``, with each
    delay equal to the reference backend's."""
    hedge = HedgePolicy(threshold_s=1e-4, parallelism=2)
    nbytes = 5 * GB
    got = []
    for mod, tm, perf, pricing, h in (
        (None, TransferModel, PerfModel(V100_X4_HF), AWS_PAPER, hedge),
        (jbackend, jtransfer.TransferModel, JPerfModel(JV100_X4_HF), JAWS_PAPER,
         jscheduler.HedgePolicy(threshold_s=1e-4, parallelism=2)),
    ):
        cls = ObjectStoreBackend if mod is None else mod.ObjectStoreBackend
        plain = cls("s3", transfer=tm(perf, pricing))
        hedged = cls("s3", transfer=tm(perf, pricing), hedge=h)
        plain.put("a", object(), nbytes=nbytes)
        hedged.put("a", object(), nbytes=nbytes)
        _, hp = plain.get("a")
        _, hh = hedged.get("a")
        assert hh.delay_s == pytest.approx(h.effective_delay(hp.delay_s))
        assert hh.delay_s < hp.delay_s
        # the duplicate fetch doesn't hide the billed bytes
        assert hedged.transfer.stats["s3"].loaded_bytes == nbytes
        got.append((hp.delay_s, hh.delay_s))
    assert got[0] == pytest.approx(got[1], abs=1e-12)


@pytest.mark.parametrize("decode", sorted(DECODE))
def test_hedged_serve_replays_and_cuts_load_time(llama, decode):
    """The engine with ``hedge`` (paper platform, full llama-7b economics, a
    10 ms hedge threshold, under the ~0.1 s loads of these contexts): the
    serve replays the JAX engine's, and no load is charged more than
    unhedged, some less."""
    reqs = _requests(llama[2].vocab)
    kw = dict(cost_arch="llama-7b", **PAPER, **DECODE[decode])
    eng, events = _replay_on_both(
        llama, reqs, "always", jax_kw=dict(hedge=jscheduler.HedgePolicy(threshold_s=0.01)),
        hedge=HedgePolicy(threshold_s=0.01), **kw)
    plain, plain_events = _replay_on_both(llama, reqs, "always", **kw)
    assert _tokens(eng) == _tokens(plain)
    hedged = [e.load_s for e in events if isinstance(e, ev.KVLoaded)]
    unhedged = [e.load_s for e in plain_events if isinstance(e, ev.KVLoaded)]
    assert hedged and len(hedged) == len(unhedged)
    assert all(h <= u for h, u in zip(hedged, unhedged))
    assert any(h < u for h, u in zip(hedged, unhedged))
