"""The port's serving engine replays the JAX engine's golden scenarios.

The four scenarios of ``tests/test_serving.py`` (``always``, ``cost``,
``recompute``, ``partial_always``) run through ``repro_torch``'s engine on
reduced llama-7b with dense decode, on the CPU, with weights converted from
the reference's.  The port defaults to H100 hardware and prices, so the test
builds a ``HardwareSpec`` and a ``Pricing`` equal to the reference's
defaults from the reference objects' fields; actions, matched tokens and
every modelled time and dollar must then equal the golden file at 1e-9, and
the generated tokens must be identical to the JAX engine's.
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
from repro.models import registry as jregistry  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.perf_model import HardwareSpec, PerfModel  # noqa: E402
from repro_torch.core.pricing import ComputePrice, Pricing, StorageTier  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AlwaysReusePlanner,
    CostAwarePlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from repro_torch.serving.engine import _NOT_PORTED  # noqa: E402

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


@pytest.mark.parametrize("arch", ["llama-7b", "qwen2-1.5b"])
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


_CHANGED = {
    "paged_decode": True, "kv_block": 64, "unified_step": True,
    "step_token_budget": 64, "fusion_enabled": True,
    "compress_tier": "io2", "faults": object(), "hedge": object(),
    "overlap_load": True, "prefetch_lookahead": 1, "migration_interval_s": 1.0,
    "migration_policy": object(),
}


@pytest.mark.parametrize("field", sorted(_NOT_PORTED))
def test_unported_options_raise(llama, field):
    """An option whose path the port does not carry raises, naming the
    ROADMAP item, instead of silently serving another path."""
    _, _, cfg, params = llama
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(cfg, params, device="cpu",
                      engine_cfg=EngineConfig(**{**ENGINE_KW, field: _CHANGED[field]}))


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
