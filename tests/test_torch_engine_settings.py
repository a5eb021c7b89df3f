"""The port's engine against the JAX engine under non-default settings.

``tests/test_torch_engine.py`` replays the four golden scenarios, which run
the default store and admission settings.  This file pins the settings that
take other branches of the same pipeline: one admission per step, a write-
back floor, no write-back, LRU and cost eviction under tight capacities with
and without spilling, a larger packing bucket with three slots, and an
explicit hierarchy over disk, RPC and object backends with and without a
concurrency limit on each link, and the int8 tier (priced at full llama-7b
scale, and fed by spills out of a tight host tier).  Each runs the same twelve requests through
both engines (reduced llama-7b, weights converted from the reference's, the
reference's hardware and prices rebuilt for the port): the tokens must be
identical, and every record field, summary key, ``packed_stats`` and
``decode_stats`` entry, the store's entries and the typed event stream must
agree, floats at 1e-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.kvcache import TierSpec as JTierSpec  # noqa: E402
from repro_torch.kvcache.hierarchy import TierSpec  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AlwaysReusePlanner,
    CostAwarePlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from test_torch_engine import _close, _reference_perf_and_pricing, _setup  # noqa: E402

torch.set_num_threads(1)
ENTRY_GB = 65540 / 1e9  # one stored 64-token context of reduced llama-7b


ORDER = (0, 1, 2, 0, 3, 1, 0, 2, 3, 0, 1, 2)  # context of each request


def _traffic(vocab, seed=7):
    """Twelve requests over four contexts (48, 64, 64 and 96 tokens), three
    at a time, 0.01 s apart; context 0 is the hot one, and the others
    compete for the store's room."""
    rng = np.random.default_rng(seed)
    ctxs = [list(map(int, rng.integers(0, vocab, n))) for n in (48, 64, 64, 96)]
    return [
        dict(req_id=i, context_tokens=ctxs[ORDER[i]],
             prompt_tokens=list(map(int, rng.integers(0, vocab, 8))),
             max_new_tokens=3, arrival_s=0.01 * (i // 3), expected_reuses=3)
        for i in range(12)
    ]


def _hierarchy(spec, concurrency):
    """Host DRAM with room for one entry, then disk, RPC and object tiers
    with room for two each."""
    return [
        spec("host_dram", 1.5 * ENTRY_GB, concurrency=concurrency),
        spec("local_nvme", 2.5 * ENTRY_GB, concurrency=concurrency, backend="disk"),
        spec("peer_dram", 2.5 * ENTRY_GB, concurrency=concurrency, backend="rpc"),
        spec("s3", 2.5 * ENTRY_GB, concurrency=concurrency, backend="object"),
    ]


TIGHT = {"host_dram": 2.5 * ENTRY_GB, "io2": 2.5 * ENTRY_GB}
# name -> (planner, EngineConfig fields beyond max_len 128 and chunk_tokens 16)
SETTINGS = {
    "admit_one_with_cache_floor": ("always", dict(
        admit_batch=1, min_cache_tokens=60, cost_arch="llama-7b")),
    "no_write_back": ("always", dict(store_write_back=False, admit_batch=1)),
    "lru_tight": ("always", dict(eviction="lru", tier_capacities_gb=TIGHT)),
    "cost_tight": ("always", dict(eviction="cost", tier_capacities_gb=TIGHT)),
    "lru_tight_spill": ("always", dict(
        eviction="lru", tier_capacities_gb=TIGHT, spill_on_pressure=True,
        store_tier="host_dram")),
    "cost_tight_spill": ("always", dict(
        eviction="cost", tier_capacities_gb=TIGHT, spill_on_pressure=True,
        store_tier="host_dram")),
    "bucket_64_three_slots": ("always", dict(
        pack_bucket_min=64, max_slots=3, store_tier="host_dram")),
    "tiers_disk_rpc_object": ("always", dict(
        tier_specs="specs", store_tier="host_dram", spill_on_pressure=True)),
    "tiers_disk_rpc_object_one_link": ("always", dict(
        tier_specs="specs_one_link", store_tier="host_dram", spill_on_pressure=True)),
    # the int8 tier priced at full llama-7b scale: a fetch from it moves half
    # the full arch's KV bytes
    "compressed_cost_arch": ("always", dict(compress_tier="io2", cost_arch="llama-7b")),
    # spills out of a tight host tier enter the int8 tier and are quantised
    # there, from host payloads; loads then come back from both tiers
    "compressed_spill_into_int8": ("always", dict(
        eviction="cost", tier_capacities_gb=TIGHT, spill_on_pressure=True,
        store_tier="host_dram", compress_tier="io2")),
}




def _n(events, name):
    return sum(type(e).__name__ == name for e in events)


# name -> what the port's run must show, so that each setting keeps taking
# the branch it is here for
EXERCISES = {
    "admit_one_with_cache_floor": lambda eng, events: (
        _n(events, "BatchAdmitted") == 12 and _n(events, "KVLoaded") > 0
        and all(e.nbytes != 49156 for e in eng.store.entries.values())),  # 48 < 60 tokens
    "no_write_back": lambda eng, events: (
        not eng.store.entries and _n(events, "StoreWriteBack") == 0),
    "lru_tight": lambda eng, events: eng.store.evictions > 0,
    "cost_tight": lambda eng, events: eng.store.evictions > 0 and _n(events, "KVLoaded") > 0,
    "lru_tight_spill": lambda eng, events: _n(events, "TierMigrated") > 0,
    "cost_tight_spill": lambda eng, events: _n(events, "TierMigrated") > 0,
    "bucket_64_three_slots": lambda eng, events: (
        _n(events, "BatchAdmitted") < 12 and _n(events, "KVLoaded") > 0),
    "tiers_disk_rpc_object": lambda eng, events: (
        {e.tier for e in eng.store.entries.values()} >= {"local_nvme", "peer_dram"}),
    "tiers_disk_rpc_object_one_link": lambda eng, events: (
        {e.tier for e in eng.store.entries.values()} >= {"local_nvme", "peer_dram"}),
    "compressed_cost_arch": lambda eng, events: (
        all(e.compressed for e in eng.store.entries.values())
        and any(e.tier == "io2" for e in events if type(e).__name__ == "KVLoaded")),
    "compressed_spill_into_int8": lambda eng, events: (
        _n(events, "TierMigrated") > 0
        and any(e.compressed for e in eng.store.entries.values() if e.tier == "io2")
        and {e.tier for e in events if type(e).__name__ == "KVLoaded"} == {"host_dram", "io2"}),
}


def _config(make_config, spec, kw):
    kw = {**dict(max_slots=2, max_len=128, chunk_tokens=16), **kw}
    if "tier_specs" in kw:
        kw["tier_specs"] = _hierarchy(spec, 1 if kw["tier_specs"] == "specs_one_link" else None)
    return make_config(**kw)


def _serve(make_engine, make_config, make_request, spec, planners, cfg, params, setting,
           **engine_kw):
    planner, kw = SETTINGS[setting]
    eng = make_engine(cfg, params, engine_cfg=_config(make_config, spec, kw),
                      planner=planners[planner](), **engine_kw)
    for r in _traffic(cfg.vocab):
        eng.submit(make_request(**r))
    events = []
    while not eng.idle:
        events.extend(eng.step())
    return eng, events


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_engine_setting_replays_reference(llama, setting):
    jcfg, jparams, cfg, params = llama
    perf, pricing = _reference_perf_and_pricing()
    eng, events = _serve(
        ServingEngine, EngineConfig, Request, TierSpec,
        {"always": AlwaysReusePlanner, "cost": CostAwarePlanner}, cfg, params, setting,
        perf=perf, pricing=pricing, device="cpu")
    jeng, jevents = _serve(
        jserving.ServingEngine, jserving.EngineConfig, jserving.Request, JTierSpec,
        {"always": jserving.AlwaysReusePlanner, "cost": jserving.CostAwarePlanner},
        jcfg, jparams, setting)
    assert EXERCISES[setting](eng, events), setting

    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    _close(eng.summary().as_dict(), jeng.summary().as_dict(), "summary")
    _close(eng.packed_stats(), jeng.packed_stats(), "packed_stats")
    _close(eng.decode_stats(), jeng.decode_stats(), "decode_stats")
    entries = sorted((e.tier, e.nbytes, e.compressed) for e in eng.store.entries.values())
    assert entries == sorted(
        (e.tier, e.nbytes, e.compressed) for e in jeng.store.entries.values())
    _close(events, jevents, "events")
