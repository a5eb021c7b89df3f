"""The port's GELU MLP and granite-34b (MQA) against the JAX package's, on the CPU.

``granite-34b`` is a dense decoder with one KV head (48 query heads share
it) and the two-matrix GELU MLP with biases.  Reduced granite (d_model 64,
4 query heads on 1 KV head, f32) runs on weights converted from the
reference's (``models.convert.from_jax_params``), the reference on its
plain kernels:

  * the registry: the port's ``CONFIGS`` names every arch of the
    reference's, each config and its reduced config field for field the
    reference's;
  * the GELU MLP at atol 1e-6 (``jax.nn.gelu``'s tanh form, biases in the
    activation dtype), and granite's parameter count;
  * granite's ``prefill`` (full and suffix), ``decode``, ``prefill_packed``,
    ``decode_paged``, ``prefill_chunked`` and ``prefill_fused`` logits at
    atol 5e-5;
  * ``tests/test_serving.py::test_reuse_tokens_identical_to_recompute
    [granite-34b]`` replayed on both engines (dense, paged, unified, with
    fusion on) and a shuffled-chunk mix served fused: records, summaries
    and events at 1e-9, tokens exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import CONFIGS, get_config, reduced_config  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import layers, lm, registry  # noqa: E402
from repro_torch.serving import BlendPlanner, Request  # noqa: E402
from test_torch_engine import _replay_on_both, _requests, _run_port, _setup  # noqa: E402
from test_torch_fusion import _fused_both  # noqa: E402
from test_torch_fusion_engine import (  # noqa: E402
    _assert_replays, _engines, _serve, _shuffled_requests,
)
from test_torch_models import _packed_both, _port_artifact  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-34b"
ATOL = 5e-5
LAYER_ATOL = 1e-6
MAX_LEN = 128
PAD = -(2**30)


@pytest.fixture(scope="module")
def granite():
    return _setup(ARCH)


# --------------------------------------------------------------------------- #
# Registry, layers, counts
# --------------------------------------------------------------------------- #
def test_configs_are_the_reference_configs():
    """The port registers every arch of the reference, each config and its
    reduced config the reference's field for field."""
    assert sorted(CONFIGS) == sorted(JCONFIGS)
    for name in CONFIGS:
        cfg, jcfg = get_config(name), jget_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(reduced_config(cfg)) == dataclasses.asdict(jreduced(jcfg))


def test_gelu_mlp_matches_reference():
    """The GELU MLP (``w1, b1, w2, b2``) on the reference's weights with
    random biases, at atol 1e-6; the erf form of GELU would miss that."""
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    assert cfg.mlp_type == "gelu" and cfg.n_kv_heads == 1
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    jp = {k: (np.array(v) if k.startswith("w") else
              rng.standard_normal(v.shape).astype(np.float32)) for k, v in jp.items()}
    assert sorted(jp) == ["b1", "b2", "w1", "w2"]
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp({k: jnp.asarray(v) for k, v in jp.items()}, jcfg,
                                        jnp.asarray(x)))
    p = {k: torch.from_numpy(v) for k, v in jp.items()}
    got = layers.apply_mlp(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_ATOL)
    h = torch.from_numpy(x) @ p["w1"] + p["b1"]
    erf = torch.nn.functional.gelu(h) @ p["w2"] + p["b2"]
    assert (erf - got).abs().max().item() > 10 * LAYER_ATOL
    # init gives the reference's tree: two matrices and two zero biases
    tp = layers.init_mlp(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert not tp["b1"].any() and not tp["b2"].any()


def test_param_count_matches_reference():
    """Full granite: 88 layers of MQA attention and the GELU MLP, an untied
    head; 33,965,070,336 parameters, the reference's ``eval_shape``
    count."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    got = (registry.count_params(cfg), registry.count_active_params(cfg))
    assert got == (jregistry.count_params(jcfg), jregistry.count_active_params(jcfg))
    assert got == (33_965_070_336, 33_965_070_336)
    D, F = cfg.d_model, cfg.d_ff
    per_layer = 2 * D + D * 48 * 128 * 2 + 2 * D * 128 + 2 * D * F + F + D
    assert got[0] == 2 * cfg.padded_vocab * D + cfg.n_layers * per_layer + D


# --------------------------------------------------------------------------- #
# The model against the reference
# --------------------------------------------------------------------------- #
def test_prefill_suffix_and_decode_match_reference(granite):
    """A full prefill, the load path's suffix prefill after 40 stored rows
    and three decode steps, at 5e-5 with the reference's argmax."""
    jcfg, jparams, cfg, params = granite
    rng = np.random.default_rng(5)
    ctx = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    suffix = rng.integers(0, cfg.vocab, (1, 12)).astype(np.int32)
    jl, jst = jlm.prefill(jparams, jcfg, jnp.asarray(ctx), jlm.init_state(jcfg, 2, MAX_LEN))
    tl, tst = lm.prefill(params, cfg, torch.from_numpy(ctx),
                         lm.init_state(cfg, 2, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tst.caches[0].attn.k.shape[-2] == 1  # one KV head
    jart = jpaged.extract_slot(jcfg, jst, 1, 40)
    js = jpaged.insert_slot(jcfg, jlm.init_state(jcfg, 1, MAX_LEN), 0, jart)
    ts = paged.insert_slot(cfg, lm.init_state(cfg, 1, MAX_LEN, device="cpu"), 0,
                           _port_artifact(jart))
    jl, js = jlm.prefill(jparams, jcfg, jnp.asarray(suffix), js)
    tl, ts = lm.prefill(params, cfg, torch.from_numpy(suffix), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for _ in range(3):
        toks = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        assert tl.argmax(-1).tolist() == toks[:, 0].tolist()
        jl, js = jlm.decode(jparams, jcfg, jnp.asarray(toks), js)
        tl, ts = lm.decode(params, cfg, torch.from_numpy(toks), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_prefill_packed_matches_reference():
    """Two segments packed, one over 32 stored rows: logits at 5e-5."""
    (_, _, jlogits, _), (_, _, logits, _), _ = _packed_both(ARCH)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    assert logits.argmax(-1).tolist() == np.asarray(jlogits).argmax(-1).tolist()


def _pool_with(cfg, jcfg, jparams, ps, tpool, jpool, lens, rng, block):
    """Land a prefilled sequence of each length of ``lens`` in slot b's
    blocks of both pools (the reference's rows on both sides)."""
    jk, jv = jpool[0].attn.k, jpool[0].attn.v
    for b, L in enumerate(lens):
        toks = rng.integers(0, cfg.vocab, (1, L)).astype(np.int32)
        _, st = jlm.prefill(jparams, jcfg, jnp.asarray(toks), jlm.init_state(jcfg, 1, MAX_LEN))
        dst = paged.block_rows(ps.tables[b, : -(-L // block)], block)[:L]
        k_rows = np.array(st.caches[0].attn.k[:, 0, :L])
        v_rows = np.array(st.caches[0].attn.v[:, 0, :L])
        jk, jv = jk.at[:, dst].set(k_rows), jv.at[:, dst].set(v_rows)
        tpool[0].attn.k[:, torch.from_numpy(dst)] = torch.from_numpy(k_rows)
        tpool[0].attn.v[:, torch.from_numpy(dst)] = torch.from_numpy(v_rows)
    return (jpool[0]._replace(attn=jpool[0].attn._replace(k=jk, v=jv)),)


def test_decode_paged_matches_reference(granite):
    """Two slots of 13 and 37 tokens in a pool of 16-row blocks decode 5
    greedy steps (the shorter one across a block boundary): logits at 5e-5."""
    jcfg, jparams, cfg, params = granite
    rng = np.random.default_rng(2)
    block, lens = 16, [13, 37]
    ps = paged.PagedSlots(len(lens), MAX_LEN, block)
    for b, L in enumerate(lens):
        ps.admit(b, L)
    tpool = paged.init_pool_caches(cfg, ps.pool.n_blocks, block, device="cpu")
    jpool = _pool_with(cfg, jcfg, jparams, ps, tpool,
                       jpaged.init_pool_caches(jcfg, ps.pool.n_blocks, block,
                                               dtype=jnp.float32), lens, rng, block)
    toks = np.array([[3], [7]], np.int32)
    for _ in range(5):
        for b in range(len(lens)):
            assert ps.prepare_append(b) is None
        jl, jpool = jlm.decode_paged(
            jparams, jcfg, jnp.asarray(toks), jpool, block_table=jnp.asarray(ps.tables),
            pos=jnp.asarray(ps.lens, jnp.int32), block=block)
        tl, tpool = lm.decode_paged(
            params, cfg, torch.from_numpy(toks), tpool, block_table=torch.from_numpy(ps.tables),
            pos=torch.from_numpy(ps.lens.astype(np.int32)), block=block)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for b in range(len(lens)):
            ps.note_token(b)
        toks = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        assert tl.argmax(-1).tolist() == toks[:, 0].tolist()


def test_prefill_chunked_matches_reference(granite):
    """The unified step's launch: slot 0 lands a 24-token prompt after 13
    stored rows in 16-token chunks, slot 1 decodes after 37 rows, slot 2 is
    idle; logits of the live rows at 5e-5."""
    jcfg, jparams, cfg, params = granite
    rng = np.random.default_rng(2)
    block, C, B = 16, 16, 3
    ctx0, prompt0 = 13, 24
    ps = paged.PagedSlots(B, MAX_LEN, block)
    ps.admit(0, ctx0 + prompt0)
    ps.admit(1, 37)
    tpool = paged.init_pool_caches(cfg, ps.pool.n_blocks, block, device="cpu")
    jpool = _pool_with(cfg, jcfg, jparams, ps, tpool,
                       jpaged.init_pool_caches(jcfg, ps.pool.n_blocks, block,
                                               dtype=jnp.float32), [ctx0, 37], rng, block)
    prompt = rng.integers(0, cfg.vocab, prompt0).astype(np.int32)
    landed, dec_tok = 0, 5
    while landed < prompt0:
        assert ps.prepare_append(1) is None
        n = min(C, prompt0 - landed)
        tokens = np.zeros((B, C), np.int32)
        q_pos = np.full((B, C), PAD, np.int32)
        tokens[0, :n] = prompt[landed:landed + n]
        q_pos[0, :n] = np.arange(ctx0 + landed, ctx0 + landed + n)
        tokens[1, 0], q_pos[1, 0] = dec_tok, ps.lens[1]
        last_idx = np.array([n - 1, 0, 0], np.int32)
        jl, jpool = jlm.prefill_chunked(
            jparams, jcfg, jnp.asarray(tokens), jpool, block_table=jnp.asarray(ps.tables),
            q_pos=jnp.asarray(q_pos), last_idx=jnp.asarray(last_idx), block=block)
        tl, tpool = lm.prefill_chunked(
            params, cfg, torch.from_numpy(tokens), tpool,
            block_table=torch.from_numpy(ps.tables), q_pos=torch.from_numpy(q_pos),
            last_idx=torch.from_numpy(last_idx), block=block)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl[:2].numpy(), jl[:2], atol=ATOL)
        assert tl[:2].argmax(-1).tolist() == jl[:2].argmax(-1).tolist()
        ps.note_token(1)
        landed += n
        dec_tok = int(jl[1].argmax())


def test_prefill_fused_matches_reference():
    """A fused launch over a stored context's permuted chunks, a quarter of
    them recomputed (delta-RoPE on the one K head): logits at 5e-5."""
    f = _fused_both(ARCH, 0.25)
    np.testing.assert_allclose(f["logits"].numpy(), f["jlogits"], atol=ATOL)
    assert f["logits"].argmax(-1).tolist() == f["jlogits"].argmax(-1).tolist()


# --------------------------------------------------------------------------- #
# The engine against the reference's
# --------------------------------------------------------------------------- #
MODES = {"dense": {}, "paged": dict(paged_decode=True),
         "unified": dict(paged_decode=True, unified_step=True),
         "fusion on": dict(fusion_enabled=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reuse_tokens_identical_to_recompute(granite, mode):
    """``tests/test_serving.py:87`` for granite on both engines, under each
    decode mode: records, summary, store entries and events at 1e-9 to the
    reference's engine; loading the stored MQA rows generates recompute's
    tokens."""
    reqs = _requests(granite[2].vocab)
    eng, _ = _replay_on_both(granite, reqs, "always", **MODES[mode])
    off, _ = _run_port(*granite[2:], reqs, reuse_enabled=False, **MODES[mode])
    tokens = {r.req_id: r.tokens for r in eng.records}
    assert tokens == {r.req_id: r.tokens for r in off.records}
    assert sum(r.action == "load" for r in eng.records) >= len(reqs) - 2
    assert eng.summary().reuse_hits >= len(reqs) - 2
    assert eng.batches >= 1 or eng.unified_stats()["steps"] >= 1
    assert eng.decode_stats()["paged"] is bool(MODES[mode].get("paged_decode"))


@pytest.mark.parametrize("paged_decode", [False, True])
def test_fused_serve_replays_reference(granite, paged_decode):
    """Shuffled chunks of a stored context served fused (``BlendPlanner``,
    r = 0.25) on both engines: every record, the summary, ``fused_stats``
    and the events at 1e-9, tokens exact."""
    reqs = _shuffled_requests(granite[2].vocab, seed=1)
    planners = (lambda: BlendPlanner(recompute_frac=0.25, always=True),
                lambda: jserving.BlendPlanner(recompute_frac=0.25, always=True))
    eng, jeng = _engines(granite, planners, fusion_enabled=True,
                         paged_decode=paged_decode)
    events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
    assert eng.fused_stats()["admissions"] == 3
    _assert_replays(eng, events, jeng, jevents)
