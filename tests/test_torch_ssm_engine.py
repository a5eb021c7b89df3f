"""The port's serving engine on the SSM family replays the JAX engine's.

mamba2-1.3b cannot be packed (its state mixes along the sequence), so both
engines admit one request per step through ``ModelApi.prefill``: a load
inserts the stored (conv tail, SSD state) snapshot and prefills the prompt
after it, a recompute that writes back runs in two phases (context, store,
prompt).  Reduced mamba2 on weights converted from the reference's, on the
CPU, with the reference's ``PerfModel`` and prices rebuilt as the port's
types: identical tokens, and every record field, summary key, the store's
entries and the typed event stream at 1e-9.  Then the reference's own
engine checks of the family, on the port: reuse tokens equal recompute
tokens, no partial reuse, no packed batch, and ``paged_decode`` (with the
unified step and fusion) quietly off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import ENGINE_KW, _close, _reference_perf_and_pricing, _setup  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro_torch.kvcache import compression  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AlwaysReusePlanner,
    CostAwarePlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from repro_torch.serving import events as ev  # noqa: E402

ARCH = "mamba2-1.3b"


@pytest.fixture(scope="module")
def mamba():
    return _setup(ARCH)


def _requests(vocab, n=6, n_ctx=2, ctx_len=64, prompt_len=8, new=4, seed=0, arrival=0.01):
    """``tests/test_serving.py``'s request mix (``arrival=0`` makes it the
    burst of ``tests/test_packed.py``)."""
    rng = np.random.default_rng(seed)
    ctxs = [list(map(int, rng.integers(0, vocab, ctx_len))) for _ in range(n_ctx)]
    return [
        dict(req_id=i, context_tokens=ctxs[i % n_ctx],
             prompt_tokens=list(map(int, rng.integers(0, vocab, prompt_len))),
             max_new_tokens=new, arrival_s=i * arrival, expected_reuses=n // n_ctx)
        for i in range(n)
    ]


def _serve(cfg, params, reqs, planner=AlwaysReusePlanner, **ec_kw):
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**{**ENGINE_KW, **ec_kw}),
                        planner=planner() if planner else None, device="cpu")
    for r in reqs:
        eng.submit(Request(**r))
    events = []
    while not eng.idle:
        events.extend(eng.step())
    return eng, events


def _tokens(eng):
    return {r.req_id: r.tokens for r in eng.records}


@pytest.mark.parametrize("planner,ec", [
    ("always", {}), ("cost", {}), ("always", dict(compress_tier="io2")),
    ("cost", dict(cost_arch=ARCH)),
], ids=["always", "cost", "always-compressed", "cost-full-economics"])
def test_engine_replays_jax_engine(mamba, planner, ec):
    """Under ``always`` the second wave loads the stored states; under
    ``cost`` with the reference's hardware, recompute wins for the reduced
    model, and with full-size economics (``cost_arch``) the planner prices
    the full mamba2's ~100 MB states.  ``compress_tier`` stores the conv
    tail and the SSD state as int8 on both sides."""
    jcfg, jparams, cfg, params = mamba
    perf, pricing = _reference_perf_and_pricing()
    planners = {"always": (AlwaysReusePlanner, jserving.AlwaysReusePlanner),
                "cost": (CostAwarePlanner, jserving.CostAwarePlanner)}[planner]
    kw = {**ENGINE_KW, **ec}
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**kw), perf=perf, pricing=pricing,
                        planner=planners[0](), device="cpu")
    jeng = jserving.ServingEngine(jcfg, jparams, engine_cfg=jserving.EngineConfig(**kw),
                                  planner=planners[1]())
    reqs = _requests(cfg.vocab)
    events, jevents = [], []
    for e, make, out in ((eng, Request, events), (jeng, jserving.Request, jevents)):
        for r in reqs:
            e.submit(make(**r))
        while not e.idle:
            out.extend(e.step())
    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    _close(eng.summary().as_dict(), jeng.summary().as_dict(), "summary")
    entries = [sorted((e.entry_id, e.tier, e.nbytes, e.compressed)
                      for e in x.store.entries.values()) for x in (eng, jeng)]
    assert entries[0] == entries[1]
    _close(events, jevents, "events")
    _close(eng.packed_stats(), jeng.packed_stats(), "packed_stats")
    _close(eng.decode_stats(), jeng.decode_stats(), "decode_stats")
    assert "partial" not in [r.action for r in recs]
    if planner == "always":
        assert [r.action for r in recs].count("load") == 4 and len(entries[0]) == 2
    if ec.get("compress_tier"):
        assert all(e.compressed for e in eng.store.entries.values())


def test_stored_state_is_the_reference_artifact(mamba):
    """A write-back stores the context's (conv tail, SSD state) snapshot,
    taken after the context alone: the same tree and byte count as the JAX
    engine stores, and the same values at 1e-4 (f32 reduced model)."""
    jcfg, jparams, cfg, params = mamba
    reqs = _requests(cfg.vocab, n=2, n_ctx=1)
    eng, _ = _serve(cfg, params, reqs)
    jeng = jserving.ServingEngine(jcfg, jparams, planner=jserving.AlwaysReusePlanner(),
                                  engine_cfg=jserving.EngineConfig(**ENGINE_KW))
    for r in reqs:
        jeng.submit(jserving.Request(**r))
    jeng.run()
    (e,), (je,) = eng.store.entries.values(), jeng.store.entries.values()
    art = eng.store.backends[e.tier].peek(e.entry_id)
    jart = jeng.store.backends[je.tier].peek(je.entry_id)
    assert art.caches[0].attn is None
    m, jm = art.caches[0].mamba, jart.caches[0].mamba
    assert m.conv.shape == jm.conv.shape == (2, 1, cfg.ssm.d_conv - 1, 64 * 2 + 2 * 16)
    assert m.ssd.shape == jm.ssd.shape and m.ssd.dtype == np.float32
    np.testing.assert_allclose(m.ssd, np.asarray(jm.ssd), atol=1e-4)
    np.testing.assert_allclose(m.conv, np.asarray(jm.conv), atol=1e-4)
    assert e.nbytes == je.nbytes == compression.tree_nbytes(art)


def test_reuse_tokens_identical_to_recompute(mamba):
    """``tests/test_serving.py:87`` for mamba2: loading the stored state
    generates the tokens full recomputation does."""
    _, _, cfg, params = mamba
    reqs = _requests(cfg.vocab)
    eng_yes, _ = _serve(cfg, params, reqs)
    eng_no, _ = _serve(cfg, params, reqs, planner=None, reuse_enabled=False)
    assert _tokens(eng_yes) == _tokens(eng_no)
    acts = [r.action for r in eng_yes.records]
    assert sum(a == "load" for a in acts) >= len(reqs) - 2
    assert eng_yes.summary().reuse_hits >= len(reqs) - 2


def test_partial_reuse_disallowed_for_ssm(mamba):
    """``tests/test_serving.py:110``: SSM state is all or nothing, so a
    shared 32-token prefix must not produce a partial load."""
    _, _, cfg, params = mamba
    rng = np.random.default_rng(4)
    shared = list(map(int, rng.integers(0, cfg.vocab, 32)))
    ctx_a = shared + list(map(int, rng.integers(0, cfg.vocab, 16)))
    ctx_b = shared + list(map(int, rng.integers(0, cfg.vocab, 16)))
    reqs = [dict(req_id=i, context_tokens=ctx, prompt_tokens=[1, 2, 3, 4], max_new_tokens=2,
                 arrival_s=0.01 * i, expected_reuses=2) for i, ctx in enumerate((ctx_a, ctx_b))]
    eng_yes, _ = _serve(cfg, params, reqs)
    eng_no, _ = _serve(cfg, params, reqs, planner=None, reuse_enabled=False)
    assert {r.req_id: r.action for r in eng_yes.records}[1] == "recompute"
    assert _tokens(eng_yes) == _tokens(eng_no)


def test_non_packable_arch_serves_through_per_request_path(mamba):
    """``tests/test_packed.py:349``: a burst of mamba2 requests rides the
    per-request path, one admission per step: no ``BatchAdmitted``, no
    packed batch."""
    _, _, cfg, params = mamba
    reqs = _requests(cfg.vocab, n=4, n_ctx=1, new=3, arrival=0.0)
    eng, events = _serve(cfg, params, reqs, max_slots=4)
    assert not [e for e in events if isinstance(e, ev.BatchAdmitted)]
    assert eng.batches == 0 and len(eng.records) == len(reqs)
    admitted = [e for e in events if isinstance(e, ev.RequestAdmitted)]
    assert len(admitted) == len(reqs)


def test_paged_unified_and_fusion_flags_stay_off(mamba):
    """``tests/test_paged_decode.py:311``: under ``paged_decode=True`` (and
    ``unified_step``, ``fusion_enabled``) an SSM arch keeps the dense decode
    path, as the reference does: ``decode_stats()["paged"]`` is False and
    the tokens equal the dense run's."""
    _, _, cfg, params = mamba
    reqs = _requests(cfg.vocab, n=3, n_ctx=1, arrival=0.0, seed=4)
    eng_d, _ = _serve(cfg, params, reqs, max_slots=4)
    eng_p, _ = _serve(cfg, params, reqs, max_slots=4, paged_decode=True, unified_step=True,
                      fusion_enabled=True)
    assert eng_p.decode_stats()["paged"] is False
    assert eng_p.fused_stats()["enabled"] is False
    assert eng_p.unified_stats()["steps"] == 0
    assert _tokens(eng_d) == _tokens(eng_p)
