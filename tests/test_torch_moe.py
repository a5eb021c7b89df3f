"""The port's MoE family against the JAX package's, on the CPU.

``repro_torch.models.moe`` routes, dispatches and combines as
``repro.models.moe`` does; this file holds it to the reference at three
levels, on the same numpy inputs and weights converted from the reference's:

  * layer: ``tests/test_models.py:52-79`` on the port (dropless equal to the
    dense oracle ``moe_ref``; drops bounded and finite), and ``apply_moe``
    against the reference at capacity factors 4.0 (dropless) and 1.25
    (drops): the same experts and the same kept pairs first, then outputs
    within 2e-5 and the aux loss within 1e-6.  The reference's routing is
    read by repeating its own lines on its inputs (``_reference_routing``),
    checked against its ``apply_moe`` output bit for bit;
  * weights: the router stays f32 under bf16 params, the expert stacks
    unstack per layer; the combine gives the same bits on two calls;
  * engine: reduced olmoe-1b-7b served by both engines under dense decode,
    paged decode and fused reuse, tokens exact and records, summaries and
    events at 1e-9; at capacity factor 1.25 the unified step's padding
    crowds real tokens out of their experts on both packages alike.

The reduced config keeps the reference's ``capacity_factor=4.0`` (4
experts, top-2): no pair can drop, so reuse and recompute agree exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AlwaysReusePlanner,
    BlendPlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from test_torch_engine import _close, _reference_perf_and_pricing, _requests  # noqa: E402
from test_torch_fusion_engine import _shuffled_requests  # noqa: E402
from test_torch_unified import PAD, _burst  # noqa: E402

torch.set_num_threads(1)
ATOL = 2e-5  # the reference's MoE tolerance (tests/test_models.py)
AUX_ATOL = 1e-6
MODEL_ATOL = 1e-4
ARCH = "olmoe-1b-7b"
RNG_SEED = 7


def _cfgs(cf=4.0, **overrides):
    """Reduced olmoe in both packages: 4 experts, top-2, capacity factor ``cf``."""
    jcfg = jreduced(jget_config(ARCH), moe=JMoEConfig(n_experts=4, top_k=2,
                                                       capacity_factor=cf), **overrides)
    cfg = reduced_config(get_config(ARCH), moe=MoEConfig(n_experts=4, top_k=2,
                                                          capacity_factor=cf), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _layer(cf, seed=0):
    """One MoE layer's weights in both packages (the reference's init)."""
    jcfg, cfg = _cfgs(cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _inputs(shape, n_pad=0, scale=0.3, seed=RNG_SEED):
    """Random tokens ``[B, S, D]`` whose last ``n_pad`` tokens share one row,
    as padding tokens share one hidden state: they route to the same experts."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    flat = x.reshape(-1, shape[-1])
    if n_pad:
        flat[-n_pad:] = flat[-n_pad - 1]
    return x


def _reference_routing(jp, jcfg, xf):
    """The reference's routing of ``xf [T, D]``, its own lines of
    ``src/repro/models/moe.py:79-104`` step by step: (top_i, keep in sorted
    pair order, the output its combine gives)."""
    m = jcfg.moe
    T, D = xf.shape
    E, k = m.n_experts, m.top_k
    C = jmoe.expert_capacity(T, jcfg)
    logits = xf.astype(jnp.float32) @ jp["router"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    e_flat, w_flat = top_i.reshape(-1), top_p.reshape(-1)
    t_flat = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)
    order = jnp.argsort(e_flat, stable=True)
    e_s, w_s, t_s = e_flat[order], w_flat[order], t_flat[order]
    first = jnp.searchsorted(e_s, e_s, side="left")
    pos_in_e = jnp.arange(T * k, dtype=jnp.int32) - first.astype(jnp.int32)
    keep = pos_in_e < C
    slot = jnp.where(keep, e_s * C + pos_in_e, E * C)
    xs = jnp.zeros((E * C + 1, D), xf.dtype).at[slot].set(xf[t_s])
    xe = xs[: E * C].reshape(E, C, D)
    g = jnp.einsum("ecd,edf->ecf", xe, jp["w_gate"])
    u = jnp.einsum("ecd,edf->ecf", xe, jp["w_up"])
    ye = jnp.einsum("ecf,efd->ecd", jax.nn.silu(g) * u, jp["w_down"])
    ys = jnp.concatenate([ye.reshape(E * C, D), jnp.zeros((1, D), xf.dtype)], axis=0)
    out = jnp.zeros((T, D), xf.dtype).at[t_s].add(ys[slot] * (w_s * keep)[:, None])
    return np.asarray(top_i), np.asarray(keep), np.asarray(out)


# --------------------------------------------------------------------------- #
# Layer level
# --------------------------------------------------------------------------- #
def test_moe_matches_dense_oracle_when_dropless():
    """``tests/test_models.py:52`` on the port: at capacity factor 4.0 no pair
    drops, and ``apply_moe`` is the dense loop-over-experts oracle; the
    port's oracle is the reference's; the switch loss is at least 1."""
    jcfg, jp, cfg, p = _layer(4.0)
    x = _inputs((2, 12, cfg.d_model))
    out, aux = moe.apply_moe(p, cfg, torch.from_numpy(x))
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model))
    want = ref.moe_ref(xt, p["router"], p["w_gate"], p["w_up"], p["w_down"], top_k=2)
    np.testing.assert_allclose(out.numpy(), want.view(x.shape).numpy(), atol=ATOL)
    jwant = jref.moe_ref(jnp.asarray(x.reshape(-1, cfg.d_model)), jp["router"], jp["w_gate"],
                         jp["w_up"], jp["w_down"], top_k=2)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=ATOL)
    assert bool(moe.dispatch(p, cfg, xt).keep.all())
    assert float(aux) >= 1.0 - 1e-6


def test_moe_capacity_drops_are_bounded():
    """``tests/test_models.py:70`` on the port: at capacity factor 0.5 pairs
    drop, no expert keeps more than its capacity, and the output stays
    finite (a dropped pair adds nothing)."""
    _, _, cfg, p = _layer(0.5)
    x = torch.from_numpy(_inputs((2, 16, cfg.d_model), scale=1.0))
    out, _ = moe.apply_moe(p, cfg, x)
    assert torch.isfinite(out).all()
    d = moe.dispatch(p, cfg, x.reshape(-1, cfg.d_model))
    assert not d.keep.all()
    kept = torch.bincount(d.expert[d.keep], minlength=cfg.moe.n_experts)
    assert int(kept.max()) <= d.capacity
    assert d.slot[~d.keep].eq(cfg.moe.n_experts * d.capacity).all()


@pytest.mark.parametrize("cf,n_pad", [(4.0, 0), (4.0, 20), (1.25, 20)])
def test_apply_moe_matches_reference(cf, n_pad):
    """The same numpy tokens and weights through both packages' ``apply_moe``:
    the same experts and the same kept pairs, then outputs within 2e-5 and
    the aux loss within 1e-6.  At 1.25 the shared padding rows overfill
    their experts, so pairs drop; at 4.0 none does."""
    jcfg, jp, cfg, p = _layer(cf)
    x = _inputs((2, 24, cfg.d_model), n_pad=n_pad)
    xf = x.reshape(-1, cfg.d_model)
    top_i, keep, jout = _reference_routing(jp, jcfg, jnp.asarray(xf))
    want, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    assert np.array_equal(jout.reshape(x.shape), np.asarray(want))  # the routing is the reference's

    d = moe.dispatch(p, cfg, torch.from_numpy(xf))
    # the same experts (the order within a token's k may differ at a tie; the
    # sorted pair order does not depend on it)
    assert np.array_equal(np.sort(d.top_i.numpy(), axis=1), np.sort(top_i, axis=1))
    assert np.array_equal(d.keep.numpy(), keep)
    assert d.capacity == jmoe.expert_capacity(xf.shape[0], jcfg)
    assert bool(keep.all()) == (cf == 4.0)
    out, aux = moe.apply_moe(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)
    assert float(aux) == pytest.approx(float(jaux), abs=AUX_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_gives_the_same_bits_twice(dtype):
    """The combine adds each token's pairs in a fixed order, without
    atomics: two calls on the same inputs give the same bits."""
    _, _, cfg, p = _layer(1.25)
    p = {k: (v if k == "router" else v.to(dtype)) for k, v in p.items()}
    x = torch.from_numpy(_inputs((4, 32, cfg.d_model), n_pad=40)).to(dtype)
    a, _ = moe.apply_moe(p, cfg, x)
    b, _ = moe.apply_moe(p, cfg, x)
    assert a.dtype == dtype and torch.equal(a, b)


def test_conversion_keeps_the_router_f32():
    """Under bf16 params the reference keeps the router f32: so does the
    port's conversion, and its own init; the expert stacks ``[E, D, F]``
    unstack per layer with the reference's values."""
    jcfg, cfg = _cfgs(param_dtype="bfloat16", dtype="bfloat16")
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    assert jparams["layers"][0]["ffn"]["router"].dtype == jnp.float32
    params = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    for i, layer in enumerate(params["layers"]):
        ffn, jffn = layer["ffn"], jparams["layers"][0]["ffn"]
        assert ffn["router"].dtype == torch.float32 and ffn["router"].shape == (D, E)
        assert np.array_equal(ffn["router"].numpy(), np.asarray(jffn["router"][i]))
        for name, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D))):
            assert ffn[name].dtype == torch.bfloat16 and ffn[name].shape == shape
            assert np.array_equal(ffn[name].float().numpy(),
                                  np.asarray(jffn[name][i].astype(jnp.float32)))
    own = lm.init(cfg, seed=0, device="cpu")
    assert own["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert own["layers"][0]["ffn"]["w_gate"].dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# Model level: the unified step's padding at capacity factor 1.25
# --------------------------------------------------------------------------- #
def _models(cf):
    jcfg, cfg = _cfgs(cf)
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _record_reference_moe(monkeypatch):
    """Record each reference MoE call's input and router (the calls run
    inside ``lax.scan``, so through a host callback)."""
    seen = []
    orig = jmoe.apply_moe

    def apply_moe(p, cfg, x):
        jax.debug.callback(lambda xx, rr: seen.append((np.asarray(xx), np.asarray(rr))),
                           x, p["router"])
        return orig(p, cfg, x)

    monkeypatch.setattr(jmoe, "apply_moe", apply_moe)
    return seen


def _record_port_dispatch(monkeypatch):
    seen = []
    orig = moe.dispatch

    def dispatch(p, cfg, xf):
        d = orig(p, cfg, xf)
        seen.append(d)
        return d

    monkeypatch.setattr(moe, "dispatch", dispatch)
    return seen


def test_unified_padding_crowds_real_tokens_at_cf_1_25(monkeypatch):
    """One chunked launch at capacity factor 1.25 whose rows are a decode
    token (1 valid of 16), an idle row (16 padding) and a 16-token prompt
    chunk: the 31 padding tokens share one hidden state, fill their two
    experts first, and the chunk's real tokens routed there drop.  The
    reference does the same (its rule, copied): each layer keeps the same
    pairs on both packages, and the logits agree within 1e-4."""
    jcfg, jparams, cfg, params = _models(1.25)
    rng = np.random.default_rng(3)
    max_len, block, C, B = 64, 16, 16, 3
    ps = paged.PagedSlots(B, max_len, block)
    ps.admit(0, 24)  # decodes its 24th token
    ps.admit(2, 16)  # lands a 16-token prompt chunk
    tokens = np.zeros((B, C), np.int32)
    q_pos = np.full((B, C), PAD, np.int32)
    tokens[0, 0], q_pos[0, 0] = 5, 23
    tokens[2] = rng.integers(0, cfg.vocab, C)
    q_pos[2] = np.arange(C)
    last = np.array([0, 0, C - 1], np.int32)
    pool = paged.init_pool_caches(cfg, ps.pool.n_blocks, block, device="cpu")
    jpool = jpaged.init_pool_caches(jcfg, ps.pool.n_blocks, block, dtype=jnp.float32)

    jseen = _record_reference_moe(monkeypatch)
    seen = _record_port_dispatch(monkeypatch)
    jl, _ = jlm.prefill_chunked(jparams, jcfg, jnp.asarray(tokens), jpool,
                                block_table=jnp.asarray(ps.tables), q_pos=jnp.asarray(q_pos),
                                last_idx=jnp.asarray(last), block=block)
    jl = np.asarray(jl)
    tl, _ = lm.prefill_chunked(params, cfg, torch.from_numpy(tokens), pool,
                               block_table=torch.from_numpy(ps.tables),
                               q_pos=torch.from_numpy(q_pos), last_idx=torch.from_numpy(last),
                               block=block)
    assert len(seen) == len(jseen) == cfg.n_layers
    real = (q_pos >= 0).reshape(-1)
    for i, (d, (jx, jrouter)) in enumerate(zip(seen, jseen)):
        assert np.array_equal(jrouter, np.asarray(jparams["layers"][0]["ffn"]["router"][i]))
        jp = {n: jparams["layers"][0]["ffn"][n][i] for n in ("router", "w_gate", "w_up",
                                                            "w_down")}
        top_i, keep, _ = _reference_routing(jp, jcfg, jnp.asarray(jx.reshape(-1, cfg.d_model)))
        assert np.array_equal(np.sort(d.top_i.numpy(), axis=1), np.sort(top_i, axis=1)), i
        assert np.array_equal(d.keep.numpy(), keep), i
        dropped = d.token[~d.keep].numpy()
        assert d.capacity == 32 and real[dropped].any(), (i, dropped)  # real tokens drop
    np.testing.assert_allclose(tl.numpy(), jl, atol=MODEL_ATOL)
    assert tl.argmax(-1).tolist() == jl.argmax(-1).tolist()


# --------------------------------------------------------------------------- #
# Engine level
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def olmoe():
    return _models(4.0)


def _replay(models, reqs, planners, **ec_kw):
    """Serve ``reqs`` on the port's and the JAX engine with the reference's
    hardware and prices: tokens exact, every record, the summary and the
    typed events at 1e-9.  Returns the port's engine."""
    jcfg, jparams, cfg, params = models
    perf, pricing = _reference_perf_and_pricing()
    kw = {**dict(max_slots=2, max_len=128, chunk_tokens=16), **ec_kw}
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**kw), planner=planners[0](),
                        perf=perf, pricing=pricing, device="cpu")
    jeng = jserving.ServingEngine(jcfg, jparams, engine_cfg=jserving.EngineConfig(**kw),
                                  planner=planners[1]())
    evs = []
    for e, make in ((eng, Request), (jeng, jserving.Request)):
        for r in reqs:
            e.submit(make(**r))
        out = []
        while not e.idle:
            out.extend(e.step())
        evs.append(out)
    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert len(recs) == len(reqs)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    _close(eng.summary().as_dict(), jeng.summary().as_dict(), "summary")
    _close(evs[0], evs[1], "events")
    return eng


ALWAYS = (AlwaysReusePlanner, jserving.AlwaysReusePlanner)


@pytest.mark.parametrize("reuse", [True, False])
def test_engine_replays_reference_dense(olmoe, reuse):
    """``tests/test_serving.py:83-96`` for olmoe on both engines: the always
    mix with reuse on (loads) and off (recomputes), each replaying the
    reference's serve."""
    eng = _replay(olmoe, _requests(olmoe[2].vocab), ALWAYS, reuse_enabled=reuse)
    acts = [r.action for r in eng.records]
    assert (sum(a == "load" for a in acts) >= len(acts) - 2) == reuse
    assert eng.packed_stats()["batches"] >= 2


def test_engine_paged_decode_replays_reference_and_dense(olmoe):
    """``tests/test_paged_decode.py:240`` for olmoe: paged decode replays the
    reference's paged serve, and gives the dense serve's tokens and
    modelled records."""
    reqs = _burst(olmoe[2].vocab, n=8, ctx_lens=[64, 64], seed=1)
    dense = _replay(olmoe, reqs, ALWAYS, max_slots=4)
    eng = _replay(olmoe, reqs, ALWAYS, max_slots=4, paged_decode=True)
    assert eng.decode_stats()["paged"] is True
    _close(sorted(eng.records, key=lambda r: r.req_id),
           sorted(dense.records, key=lambda r: r.req_id), "paged vs dense")
    eng._paged.audit()


def test_engine_fused_replays_reference(olmoe):
    """Fused reuse (``tests/test_fusion.py:276``'s arch at engine level): the
    shuffled-chunk mix under ``BlendPlanner(0.25)`` admits fused on both
    engines, with the same records and events."""
    planners = (lambda: BlendPlanner(recompute_frac=0.25, always=True),
                lambda: jserving.BlendPlanner(recompute_frac=0.25, always=True))
    eng = _replay(olmoe, _shuffled_requests(olmoe[2].vocab, seed=1), planners,
                  fusion_enabled=True)
    assert sum(r.action == "fused" for r in eng.records) >= 2


def test_engine_unified_at_cf_1_25_replays_reference(monkeypatch):
    """At capacity factor 1.25 the unified step drops real pairs behind its
    padding (see the model-level test); both engines drop alike, so the
    serve still replays the reference's."""
    models = _models(1.25)
    seen = _record_port_dispatch(monkeypatch)
    _replay(models, _burst(models[2].vocab, n=8, ctx_lens=[64, 64], seed=1), ALWAYS,
            max_slots=4, paged_decode=True, unified_step=True)
    assert any(not d.keep.all() for d in seen)
