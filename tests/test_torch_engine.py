"""The port's serving engine replays the JAX engine's golden scenarios.

The four scenarios of ``tests/test_serving.py`` (``always``, ``cost``,
``recompute``, ``partial_always``) run through ``repro_torch``'s engine on
reduced llama-7b with dense decode, on the CPU, with weights converted from
the reference's.  The port defaults to H100 hardware and prices, so the test
builds a ``HardwareSpec`` and a ``Pricing`` equal to the reference's
defaults from the reference objects' fields; actions, matched tokens and
every modelled time and dollar must then equal the golden file at 1e-9, and
the generated tokens must be identical to the JAX engine's.  Each option
the engine once refused (faults, hedging, ``overlap_load``,
``prefetch_lookahead``, the migration pass and its policy) serves the
``always`` mix on both engines with the same records, events and summary.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core.perf_model import tpu_v5e  # noqa: E402
from repro.core.pricing import tpu_v5e_pod  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.perf_model import HardwareSpec, PerfModel  # noqa: E402
from repro_torch.core.pricing import ComputePrice, Pricing, StorageTier  # noqa: E402
from repro_torch.kvcache import faults, hierarchy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AlwaysReusePlanner,
    CostAwarePlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from repro_torch.serving import scheduler  # noqa: E402

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).parent / "data" / "serving_golden_seed.json"


def _reference_perf_and_pricing():
    """The JAX engine's defaults (``tpu_v5e(8, hosts=1)``, ``tpu_v5e_pod(8)``)
    rebuilt as the port's types, field by field."""
    hw = HardwareSpec(**dataclasses.asdict(tpu_v5e(8, hosts=1)))
    ref = tpu_v5e_pod(8)
    pricing = Pricing(
        compute=ComputePrice(**dataclasses.asdict(ref.compute)),
        tiers={n: StorageTier(**dataclasses.asdict(t)) for n, t in ref.tiers.items()},
        default_tier=ref.default_tier,
    )
    return PerfModel(hw), pricing


def _setup(arch, seed=0):
    jcfg = jreduced(jget_config(arch))
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    cfg = reduced_config(get_config(arch))
    params = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


# the request mixes of tests/test_serving.py, drawn from the same seeds
def _requests(vocab, n=6, n_ctx=2, ctx_len=64, prompt_len=8, new=4, seed=0):
    rng = np.random.default_rng(seed)
    ctxs = [list(map(int, rng.integers(0, vocab, ctx_len))) for _ in range(n_ctx)]
    return [
        dict(req_id=i, context_tokens=ctxs[i % n_ctx],
             prompt_tokens=list(map(int, rng.integers(0, vocab, prompt_len))),
             max_new_tokens=new, arrival_s=i * 0.01, expected_reuses=n // n_ctx)
        for i in range(n)
    ]


def _partial_requests(vocab, seed=3):
    rng = np.random.default_rng(seed)
    shared = list(map(int, rng.integers(0, vocab, 32)))
    ctx_a = shared + list(map(int, rng.integers(0, vocab, 16)))
    ctx_b = shared + list(map(int, rng.integers(0, vocab, 16)))
    prompt = list(map(int, rng.integers(0, vocab, 8)))
    return [
        dict(req_id=0, context_tokens=ctx_a, prompt_tokens=prompt, max_new_tokens=3,
             arrival_s=0.0, expected_reuses=2),
        dict(req_id=1, context_tokens=ctx_b, prompt_tokens=prompt, max_new_tokens=3,
             arrival_s=0.01, expected_reuses=2),
    ]


SCENARIOS = {
    "always": (_requests, dict(planner="always")),
    "cost": (_requests, dict(planner="cost")),
    "recompute": (_requests, dict(reuse_enabled=False)),
    "partial_always": (_partial_requests, dict(planner="always")),
}
ENGINE_KW = dict(max_slots=2, max_len=128, chunk_tokens=16)


def _run_port(cfg, params, reqs, planner=None, **ec_kw):
    perf, pricing = _reference_perf_and_pricing()
    planner = {"always": AlwaysReusePlanner, "cost": CostAwarePlanner}.get(planner)
    eng = ServingEngine(
        cfg, params, engine_cfg=EngineConfig(**{**ENGINE_KW, **ec_kw}),
        planner=planner() if planner else None, perf=perf, pricing=pricing, device="cpu",
    )
    for r in reqs:
        eng.submit(Request(**r))
    return eng, eng.run()


def _run_jax(jcfg, jparams, reqs, planner=None, **ec_kw):
    planner = {"always": jserving.AlwaysReusePlanner,
               "cost": jserving.CostAwarePlanner}.get(planner)
    eng = jserving.ServingEngine(
        jcfg, jparams, engine_cfg=jserving.EngineConfig(**{**ENGINE_KW, **ec_kw}),
        planner=planner() if planner else None,
    )
    for r in reqs:
        eng.submit(jserving.Request(**r))
    eng.run()
    return {rec.req_id: rec.tokens for rec in eng.records}


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


def _close(got, want, where):
    """Equal, floats at ``1e-9``, recursing into dicts, sequences and
    dataclasses (compared field by field, whatever package defines them).
    Every field of the port's dataclasses must be the reference's; dicts
    are compared on the keys both report (the reference's stats carry keys
    of features the port does not, and the port's ``decode_stats`` adds
    ``decode_steps``)."""
    if dataclasses.is_dataclass(got) and not isinstance(got, type):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(got):
            _close(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    elif isinstance(got, dict):
        common = set(got) & set(want)
        assert common, where
        for k in sorted(common):
            _close(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, (float, np.floating)):
        assert got == pytest.approx(float(want), abs=1e-9), where
    else:
        assert got == want, where


def _serve_both(llama, reqs, planner=None, jax_kw=None, perf=None, pricing=None,
                telemetry=(None, None), **ec_kw):
    """The same requests through the port's and the JAX engine, step by
    step: the reference's hardware and prices on both sides, unless
    ``perf`` and ``pricing`` are given as (port's, reference's) pairs.
    ``jax_kw`` overrides ``ec_kw`` on the JAX side (an option object, such
    as a fault injector, is each package's own), and ``telemetry`` is the
    (port's, reference's) ``Telemetry`` pair, off by default.  Returns
    (engine, events, JAX engine, JAX events)."""
    jcfg, jparams, cfg, params = llama
    if perf is None:
        perf, pricing = _reference_perf_and_pricing()
        jperf = jpricing = None
    else:
        (perf, jperf), (pricing, jpricing) = perf, pricing
    planners = {"always": (AlwaysReusePlanner, jserving.AlwaysReusePlanner),
                "cost": (CostAwarePlanner, jserving.CostAwarePlanner)}.get(planner)
    kw = {**ENGINE_KW, **ec_kw}
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**kw), perf=perf, pricing=pricing,
                        planner=planners[0]() if planners else None, device="cpu",
                        telemetry=telemetry[0])
    jeng = jserving.ServingEngine(
        jcfg, jparams, engine_cfg=jserving.EngineConfig(**{**kw, **(jax_kw or {})}),
        planner=planners[1]() if planners else None, perf=jperf, pricing=jpricing,
        telemetry=telemetry[1])
    events, jevents = [], []
    for e, make, out in ((eng, Request, events), (jeng, jserving.Request, jevents)):
        for r in reqs:
            e.submit(make(**r))
        while not e.idle:
            out.extend(e.step())
    return eng, events, jeng, jevents


def _replay_on_both(llama, reqs, planner=None, jax_kw=None, perf=None, pricing=None,
                    **ec_kw):
    """``_serve_both``, then the checks: the tokens must be identical, and
    every record field, summary key, the store's entries (tier, nbytes,
    compressed) and the typed event stream agree, floats at 1e-9.  Returns
    the port's engine and events."""
    eng, events, jeng, jevents = _serve_both(llama, reqs, planner, jax_kw, perf, pricing,
                                             **ec_kw)
    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    _close(eng.summary().as_dict(), jeng.summary().as_dict(), "summary")
    entries = [sorted((e.entry_id, e.tier, e.nbytes, e.compressed)
                      for e in x.store.entries.values()) for x in (eng, jeng)]
    assert entries[0] == entries[1]
    _close(events, jevents, "events")
    return eng, events


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_scenario_replays_on_port(llama, name):
    jcfg, jparams, cfg, params = llama
    make, kw = SCENARIOS[name]
    reqs = make(cfg.vocab)
    eng, summary = _run_port(cfg, params, reqs, **kw)
    want = json.loads(GOLDEN.read_text())[name]
    recs = sorted(eng.records, key=lambda r: r.req_id)
    assert len(recs) == len(want["records"])
    for rec, w in zip(recs, want["records"]):
        assert rec.action == w["action"], (name, rec.req_id)
        assert rec.matched_tokens == w["matched_tokens"], (name, rec.req_id)
        for field in ("load_s", "prefill_s", "decode_s", "start_s", "finish_s",
                      "compute_cost"):
            assert getattr(rec, field) == pytest.approx(w[field], abs=1e-9), (
                name, rec.req_id, field)
    got = summary.as_dict()
    for k, v in want["summary"].items():
        assert got[k] == pytest.approx(v, abs=1e-9), (name, k)
    tokens = {rec.req_id: rec.tokens for rec in eng.records}
    assert tokens == _run_jax(jcfg, jparams, reqs, **kw)


@pytest.mark.parametrize("arch", ["llama-7b", "qwen2-1.5b", "olmoe-1b-7b"])
def test_reuse_tokens_identical_to_recompute(arch):
    """Loading stored context state generates the same tokens as full
    recomputation (the reference's core property, ``test_serving.py:87``)."""
    _, _, cfg, params = _setup(arch)
    reqs = _requests(cfg.vocab)
    eng_yes, s_yes = _run_port(cfg, params, reqs, planner="always")
    eng_no, _ = _run_port(cfg, params, reqs, reuse_enabled=False)
    toks_yes = {r.req_id: r.tokens for r in eng_yes.records}
    toks_no = {r.req_id: r.tokens for r in eng_no.records}
    assert toks_yes == toks_no
    acts = [r.action for r in eng_yes.records]
    assert sum(a == "load" for a in acts) >= len(reqs) - 2
    assert s_yes.reuse_hits >= len(reqs) - 2
    assert eng_yes.packed_stats()["batches"] >= 2
    assert eng_yes.decode_stats()["decode_steps"] >= 3


def _option_kw(field):
    """Engine kwargs that run ``field`` away from its default, built once
    from each package (an injector, a hedge or a migration policy is each
    package's own object): (port kwargs, reference kwargs).  The contexts
    are priced at full llama-7b scale where the option needs fetches long
    enough to matter."""
    out = []
    for f, h, sch in ((faults, hierarchy, scheduler), (jfaults, jhierarchy, jscheduler)):
        tiers = dict(tier_specs=[h.TierSpec("host_dram", 1.0), h.TierSpec("local_nvme", 1.0),
                                 h.TierSpec("s3", 1.0)], store_tier="host_dram")
        out.append({
            "faults": dict(faults=f.FaultInjector(seed=7, fail_rate=0.4, corrupt_rate=0.2),
                           retry_policy=f.RetryPolicy(max_attempts=2, cost_aware=False)),
            "hedge": dict(hedge=sch.HedgePolicy(threshold_s=1e-3), cost_arch="llama-7b"),
            "overlap_load": dict(overlap_load=True, cost_arch="llama-7b"),
            "prefetch_lookahead": dict(prefetch_lookahead=4, max_slots=1,
                                       cost_arch="llama-7b"),
            "migration_interval_s": dict(migration_interval_s=0.004, **tiers),
            "migration_policy": dict(migration_policy=h.BreakEvenMigrator(min_residency_s=0.0),
                                     migration_interval_s=0.004, **tiers),
        }[field])
    return out


PORTED_OPTIONS = ["faults", "hedge", "migration_interval_s", "migration_policy",
                  "overlap_load", "prefetch_lookahead"]


@pytest.mark.parametrize("field", PORTED_OPTIONS)
def test_ported_options_replay_jax_engine(llama, field):
    """Each option the engine once refused runs on the port and replays the
    JAX engine's serve of the ``always`` mix: tokens, records, summary,
    store entries and events at 1e-9.  The same serve without the option
    differs, so the option took effect."""
    port_kw, jax_kw = _option_kw(field)
    reqs = _requests(llama[2].vocab)
    eng, events = _replay_on_both(llama, reqs, "always", jax_kw=jax_kw, **port_kw)
    plain_kw = {k: v for k, v in port_kw.items() if k in ("cost_arch", "max_slots",
                                                           "tier_specs", "store_tier")}
    plain, plain_events = _serve_both(llama, reqs, "always", **plain_kw)[:2]
    assert [r.tokens for r in sorted(eng.records, key=lambda r: r.req_id)] == \
        [r.tokens for r in sorted(plain.records, key=lambda r: r.req_id)]
    assert [(type(e).__name__, e.t_s) for e in events] != \
        [(type(e).__name__, e.t_s) for e in plain_events]


@pytest.mark.parametrize("name", ["always", "partial_always"])
def test_compressed_scenario_replays_jax_engine(llama, name):
    """A golden scenario with ``compress_tier="io2"``: write-backs are stored
    as int8 rows and scales, loads dequantise them, and the serve replays the
    JAX engine's (the golden file holds no compressed run)."""
    make, kw = SCENARIOS[name]
    eng, events = _replay_on_both(llama, make(llama[2].vocab), compress_tier="io2", **kw)
    assert eng.store.entries and all(e.compressed for e in eng.store.entries.values())
    assert any(type(e).__name__ == "KVLoaded" for e in events)


def test_entry_points_need_a_device_without_cuda(llama):
    """The entry points run on the card unless the caller asks for the CPU:
    without CUDA and without a device they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    _, _, cfg, params = llama
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, engine_cfg=EngineConfig(**ENGINE_KW))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(cfg)
