"""The port's sliding-window family against the JAX package's, on the CPU.

``mixtral-8x22b`` attends within a window of 4,096 (16 reduced), and its
slotted cache is a ring of ``min(max_len, window)`` rows: position ``p``
lives in row ``p % window``.  This file holds the port's ring to the
reference's on the same numpy inputs and weights converted from the
reference's (``models.convert.from_jax_params``), the reference running on
its plain attention or its Pallas kernels in interpret mode:

  * ``_ring_positions``: ``tests/test_models.py:41``'s invariants, both
    packages equal;
  * the ring's ``prefill`` of 40 tokens over a window of 16 and a ``decode``
    after it (``tests/test_models.py:78``), then a suffix ``prefill`` over a
    wrapped ring, against windowed attention over the whole sequence and
    against the reference: outputs and ring caches within 2e-5;
  * the window cases of ``tests/test_kernels.py:55, 99`` on the port's plain
    versions;
  * the model: ``tests/test_archs_smoke.py:83``'s prefill/decode
    consistency, and the cache's length;
  * the engine: ``tests/test_serving.py:87`` for mixtral on both engines,
    tokens exact and records, summaries, store entries and events at 1e-9;
    the packable serve (``max_len == window``) dense, paged and unified,
    each replaying the reference's;
  * ROADMAP C11 on both sides: a partial match below the stored length of a
    context longer than the window.  The reference serves it from the
    wrapped ring's first rows and generates wrong tokens; the port plans a
    recompute and generates the reference's recompute tokens.  A match of
    the whole stored context plans ``partial`` on both and replays at 1e-9.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jdecode_attention  # noqa: E402
from repro.kernels.flash_prefill import flash_attention as jflash_attention  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models.attention import KVCache, _ring_positions  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import apply_rope  # noqa: E402
from test_torch_engine import (  # noqa: E402
    ENGINE_KW,
    _close,
    _partial_requests,
    _replay_on_both,
    _requests,
    _serve_both,
)

torch.set_num_threads(1)
ARCH = "mixtral-8x22b"
ATOL = 2e-5  # the reference's f32 attention tolerance (tests/test_kernels.py)
MODEL_ATOL = 3e-4  # tests/test_archs_smoke.py's prefill/decode consistency
RNG = np.random.default_rng(7)


def _cfgs(**overrides):
    jcfg = jreduced(jget_config(ARCH), **overrides)
    cfg = reduced_config(get_config(ARCH), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _models(seed=0, **overrides):
    jcfg, cfg = _cfgs(**overrides)
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    params = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def mixtral():
    return _models()


def test_full_config_is_the_references():
    """The arch is the reference's, field for field, with its window of
    4,096; reduced, the window is 16 on both packages."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.sliding_window == 4096 and cfg.moe.n_experts == 8 and cfg.moe.top_k == 2
    assert _cfgs()[1].sliding_window == 16


# --------------------------------------------------------------------------- #
# Ring positions
# --------------------------------------------------------------------------- #
@settings(max_examples=40, deadline=None)
@given(length=st.integers(0, 100), w=st.sampled_from([4, 8, 16]))
def test_ring_positions_invariants(length, w):
    """``tests/test_models.py:41`` on the port: each ring row holds the one
    live position of its residue, or -1 if none ever landed; the same
    positions as the reference's."""
    pos = _ring_positions(torch.tensor([length]), w, 1)[0].tolist()
    for j, p in enumerate(pos):
        if p < 0:
            assert length <= j  # slot never written
        else:
            assert p % w == j
            assert length - w <= p < length  # within the live window
    assert pos == np.asarray(jattention._ring_positions(jnp.asarray([length]), w, 1))[0].tolist()


# --------------------------------------------------------------------------- #
# The attention layer over the ring
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = _cfgs()
    jp = jattention.init_attention(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _windowed(p, cfg, x):
    """The port's windowed causal attention over a whole sequence, with no
    cache: the full-attention oracle of the ring."""
    B, S, _ = x.shape
    q, k, v = attention._qkv(p, cfg, x)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                            window=cfg.sliding_window)
    return attention._out(p, o)


def _ring(cfg, B):
    shape = (B, cfg.sliding_window, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape), torch.zeros(shape))


def _close_cache(cache, jcache):
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=ATOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=ATOL)


def test_ring_prefill_and_decode_match_full_attention(layer):
    """``tests/test_models.py:78`` on both packages: 40 tokens prefilled into
    a ring of 16 (2.5 turns) give windowed attention over the whole
    sequence, and a decode after them gives its next row; each output and
    the ring after each call equal the reference's."""
    jcfg, jp, cfg, p = layer
    B, S = 2, 40
    x = (RNG.standard_normal((B, S, cfg.d_model)) * 0.2).astype(np.float32)
    x1 = (RNG.standard_normal((B, 1, cfg.d_model)) * 0.2).astype(np.float32)
    full = _windowed(p, cfg, torch.from_numpy(np.concatenate([x, x1], 1)))
    jfull = jattention.forward(jp, jcfg, jnp.asarray(np.concatenate([x, x1], 1)))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=ATOL)

    cache = _ring(cfg, B)
    out = attention.prefill(p, cfg, torch.from_numpy(x), cache, torch.zeros(B, dtype=torch.int32))
    jcache = jattention.init_kv_cache(jcfg, B, 64)
    assert jcache.k.shape == tuple(cache.k.shape)  # min(64, 16) rows
    jout, jcache = jattention.prefill(jp, jcfg, jnp.asarray(x), jcache, jnp.zeros(B, jnp.int32))
    np.testing.assert_allclose(out.numpy(), full[:, :S].numpy(), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    _close_cache(cache, jcache)

    dec = attention.decode(p, cfg, torch.from_numpy(x1), cache, torch.full((B,), S, dtype=torch.int32))
    jdec, jcache = jattention.decode(jp, jcfg, jnp.asarray(x1), jcache, jnp.full((B,), S, jnp.int32))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), atol=ATOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=ATOL)
    _close_cache(cache, jcache)


@pytest.mark.parametrize("s2", [5, 20])
def test_suffix_prefill_over_a_wrapped_ring(layer, s2):
    """A suffix prefill at offset 24 over a ring that has wrapped: shorter
    than the window (old rows stay live beside the new ones) and longer
    than it (only each row's last new token is written), then a decode;
    each against windowed attention over the whole sequence and against
    the reference, rings included."""
    jcfg, jp, cfg, p = layer
    B, s1 = 2, 24
    x = (RNG.standard_normal((B, s1 + s2 + 1, cfg.d_model)) * 0.2).astype(np.float32)
    full = _windowed(p, cfg, torch.from_numpy(x))
    cache, jcache = _ring(cfg, B), jattention.init_kv_cache(jcfg, B, 64)
    for lo, hi in ((0, s1), (s1, s1 + s2)):
        out = attention.prefill(p, cfg, torch.from_numpy(x[:, lo:hi]), cache,
                                torch.full((B,), lo, dtype=torch.int32))
        jout, jcache = jattention.prefill(jp, jcfg, jnp.asarray(x[:, lo:hi]), jcache,
                                          jnp.full((B,), lo, jnp.int32))
        np.testing.assert_allclose(out.numpy(), full[:, lo:hi].numpy(), atol=ATOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
        _close_cache(cache, jcache)
    n = s1 + s2
    dec = attention.decode(p, cfg, torch.from_numpy(x[:, n:]), cache,
                           torch.full((B,), n, dtype=torch.int32))
    jdec, jcache = jattention.decode(jp, jcfg, jnp.asarray(x[:, n:]), jcache,
                                     jnp.full((B,), n, jnp.int32))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, n].numpy(), atol=ATOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=ATOL)
    _close_cache(cache, jcache)


def test_ring_write_never_repeats_a_row():
    """A prefill longer than the window writes each ring row once: its last
    occurrence, as the reference's scratch-row scatter keeps it."""
    W, B, S = 8, 2, 21
    cache = torch.full((B, W, 1), -1.0)
    offset = torch.tensor([3, 10], dtype=torch.int32)[:, None]
    positions = offset + torch.arange(S, dtype=torch.int32)[None]
    attention._ring_write(cache, positions, positions[..., None].float())
    want = _ring_positions(offset[:, 0] + S, W, B)
    assert torch.equal(cache[..., 0].long(), want.long())


# --------------------------------------------------------------------------- #
# The kernels' window cases on the plain versions
# --------------------------------------------------------------------------- #
def _randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window", [4, 16])
def test_flash_sliding_window(window):
    """``tests/test_kernels.py:55`` on the port's plain ``flash_attention``:
    the reference's Pallas kernel (interpret mode) and its oracle agree with
    it within 2e-5."""
    B, S, H, KV, hd = 2, 32, 4, 2, 16
    q, k, v = _randn(B, S, H, hd), _randn(B, S, KV, hd), _randn(B, S, KV, hd)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    got = fk.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
                                   causal=True, window=window)
    j = [jnp.asarray(a) for a in (q, k, v)]
    jpos = jnp.asarray(pos)
    kernel = jflash_attention(*j, q_pos=jpos, kv_pos=jpos, causal=True, window=window,
                              interpret=True, block_q=8, block_kv=8)
    oracle = jref.attention_ref(*j, q_pos=jpos, kv_pos=jpos, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)


def test_decode_ring_buffer_positions():
    """``tests/test_kernels.py:99`` on the port's plain ``decode_attention``:
    ring rows at wrapped positions (lengths 20 and 9 over 16 rows), equal
    within 2e-5 to the reference's Pallas kernel (interpret mode) and its
    oracle."""
    B, W, H, KV, hd = 2, 16, 4, 2, 8
    q, k, v = _randn(B, 1, H, hd), _randn(B, W, KV, hd), _randn(B, W, KV, hd)
    length = np.array([20, 9], np.int32)
    kv_pos = _ring_positions(torch.from_numpy(length), W, B)
    jkv_pos = jattention._ring_positions(jnp.asarray(length), W, B)
    assert kv_pos.tolist() == np.asarray(jkv_pos).tolist()
    pos = (length - 1)[:, None]
    got = dk.decode_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    q_pos=torch.from_numpy(pos), kv_pos=kv_pos, window=W)
    j = [jnp.asarray(a) for a in (q, k, v)]
    kernel = jdecode_attention(*j, q_pos=jnp.asarray(pos), kv_pos=jkv_pos, window=W,
                               interpret=True, block_kv=8)
    oracle = jref.attention_ref(*j, q_pos=jnp.asarray(pos), kv_pos=jkv_pos, causal=True,
                                window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_cache_holds_the_window(mixtral):
    """A windowed arch's slotted cache holds ``min(max_len, window)`` rows,
    as the reference's."""
    jcfg, _, cfg, _ = mixtral
    for max_len in (8, 16, 128):
        st_ = lm.init_state(cfg, 2, max_len, device="cpu")
        jst = jlm.init_state(jcfg, 2, max_len)
        assert tuple(st_.caches[0].attn.k.shape) == jst.caches[0].attn.k.shape
        assert st_.caches[0].attn.k.shape[2] == min(max_len, 16)


def test_smoke_prefill_decode_consistency(mixtral):
    """``tests/test_archs_smoke.py:83`` for mixtral on the port: the prefill's
    last logits equal the reference's training forward's, and a decode step
    after it is finite and equals the reference's."""
    jcfg, jparams, cfg, params = mixtral
    rng = np.random.default_rng(1)
    B, S = 2, 16
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jlogits, _ = jregistry.get_model(jcfg).forward(jparams, jcfg, jnp.asarray(toks))
    last, state = lm.prefill(params, cfg, torch.from_numpy(toks),
                             lm.init_state(cfg, B, 64, device="cpu"))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlogits[:, -1]), rtol=MODEL_ATOL,
                               atol=MODEL_ATOL)
    jlast, jstate = jlm.prefill(jparams, jcfg, jnp.asarray(toks), jlm.init_state(jcfg, B, 64))
    nxt = np.asarray(jlast).argmax(-1)[:, None].astype(np.int32)
    assert last.argmax(-1).tolist() == nxt[:, 0].tolist()
    ld, _ = lm.decode(params, cfg, torch.from_numpy(nxt), state)
    jld, _ = jlm.decode(jparams, jcfg, jnp.asarray(nxt), jstate)
    assert ld.shape == (B, cfg.padded_vocab) and torch.isfinite(ld).all()
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), atol=1e-4)


def test_prefill_past_the_window_and_decode_match_reference(mixtral):
    """``lm.prefill`` of 40 tokens (past the window), a 12-token suffix after
    them and three decode steps, against ``repro.models.lm`` on the same
    weights: logits within 1e-4, greedy tokens and rings equal."""
    jcfg, jparams, cfg, params = mixtral
    rng = np.random.default_rng(5)
    ctx = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    suffix = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    state = lm.init_state(cfg, 2, 128, device="cpu")
    jstate = jlm.init_state(jcfg, 2, 128)
    for toks in (ctx, suffix):
        tl, state = lm.prefill(params, cfg, torch.from_numpy(toks), state)
        jl, jstate = jlm.prefill(jparams, jcfg, jnp.asarray(toks), jstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        assert tl.argmax(-1).tolist() == nxt[:, 0].tolist()
        tl, state = lm.decode(params, cfg, torch.from_numpy(nxt), state)
        jl, jstate = jlm.decode(jparams, jcfg, jnp.asarray(nxt), jstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert state.pos.tolist() == np.asarray(jstate.pos).tolist() == [55, 55]
    for got, want in ((state.caches[0].attn.k, jstate.caches[0].attn.k),
                      (state.caches[0].attn.v, jstate.caches[0].attn.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # a stored artifact past the window is the whole ring, as the reference's
    art = paged.extract_slot(cfg, state, 1, 55)
    jart = jpaged.extract_slot(jcfg, jstate, 1, 55)
    assert art.caches[0].attn.k.shape == jart.caches[0].attn.k.shape == (2, 1, 16, 2, 16)
    assert int(art.pos[0]) == int(np.asarray(jart.pos)[0]) == 55


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #
def test_reuse_tokens_identical_to_recompute(mixtral):
    """``tests/test_serving.py:87`` for mixtral on both engines: 64-token
    contexts (four turns of the ring) load whole, one request per step, and
    generate the tokens of recompute; each serve replays the reference's."""
    reqs = _requests(mixtral[2].vocab)
    eng, _ = _replay_on_both(mixtral, reqs, "always")
    off, _ = _replay_on_both(mixtral, reqs, reuse_enabled=False)
    assert {r.req_id: r.tokens for r in eng.records} == {r.req_id: r.tokens for r in off.records}
    acts = [r.action for r in eng.records]
    assert sum(a == "load" for a in acts) >= len(reqs) - 2
    assert eng.summary().reuse_hits >= len(reqs) - 2
    assert eng.packed_stats()["batches"] == 0  # window < max_len: not packable
    # each stored artifact is the ring: 16 rows a layer, not 64
    cfg = mixtral[2]
    ring_bytes = 2 * cfg.n_layers * 16 * cfg.n_kv_heads * cfg.resolved_head_dim * 4  # K, V f32
    assert {e.nbytes for e in eng.store.entries.values()} == {4 + ring_bytes}


@pytest.mark.parametrize("mode", ["dense", "paged", "unified"])
def test_packable_serve_replays_reference(mode):
    """With ``max_len == window`` (128 here) the ring never wraps and the
    arch packs: dense decode, paged decode and the unified step each replay
    the reference's serve, window passed to every kernel."""
    models = _models(sliding_window=128)
    kw = {"dense": {}, "paged": dict(paged_decode=True),
          "unified": dict(paged_decode=True, unified_step=True)}[mode]
    eng, _ = _replay_on_both(models, _requests(models[2].vocab), "always", max_slots=4, **kw)
    assert paged.packable_arch(models[2], ENGINE_KW["max_len"])
    if mode == "unified":
        assert eng.unified_stats()["steps"] > 0
    else:
        assert eng.packed_stats()["batches"] >= 2
    assert eng.decode_stats()["paged"] is (mode != "dense")


# --------------------------------------------------------------------------- #
# ROADMAP C11: partial reuse from a wrapped ring
# --------------------------------------------------------------------------- #
def _tokens(recs):
    return {r.req_id: r.tokens for r in recs}


def test_c11_reference_serves_a_wrapped_ring_wrongly_and_the_port_recomputes(mixtral):
    """Two 48-token contexts (three turns of a 16-row ring) share 32 tokens.
    The reference plans request 1 ``partial`` with 32 matched tokens, reads
    the wrapped ring's first 32 rows as positions 0-31, and generates other
    tokens than its own recompute.  The port reports no usable match: it
    recomputes and generates the reference's recompute tokens."""
    jcfg, jparams, cfg, params = mixtral
    reqs = _partial_requests(cfg.vocab)
    eng, _, jeng, _ = _serve_both(mixtral, reqs, "always")
    _, _, joff, _ = _serve_both(mixtral, reqs, reuse_enabled=False)
    jrecs = {r.req_id: r for r in jeng.records}
    recs = {r.req_id: r for r in eng.records}
    assert (jrecs[1].action, jrecs[1].matched_tokens) == ("partial", 32)
    assert jrecs[1].tokens != _tokens(joff.records)[1]  # the reference's fault
    assert (recs[1].action, recs[1].matched_tokens) == ("recompute", 0)
    assert _tokens(eng.records) == _tokens(joff.records)
    # request 0 is untouched by C11: the same on both packages
    _close(recs[0], jrecs[0], "request 0")


def test_c11_extending_the_whole_stored_context_replays_reference(mixtral):
    """Request 1 extends request 0's whole 48-token context by 16 tokens:
    both engines plan ``partial`` with 48 matched tokens (the ring inserted
    as it is) and generate recompute's tokens; records, summaries, entries
    and events replay at 1e-9."""
    cfg = mixtral[2]
    reqs = _partial_requests(cfg.vocab)
    rng = np.random.default_rng(11)
    reqs[1]["context_tokens"] = reqs[0]["context_tokens"] + rng.integers(
        0, cfg.vocab, 16).tolist()
    eng, _ = _replay_on_both(mixtral, reqs, "always")
    off, _ = _replay_on_both(mixtral, reqs, reuse_enabled=False)
    rec = next(r for r in eng.records if r.req_id == 1)
    assert (rec.action, rec.matched_tokens) == ("partial", 48)
    assert _tokens(eng.records) == _tokens(off.records)


def test_c11_rule(mixtral):
    """``paged.ring_match_usable``: any match below the window's length, a
    match of the whole stored context, and nothing else past the window;
    archs without a window are untouched."""
    cfg = mixtral[2]
    assert paged.ring_match_usable(cfg, 16, 8) and paged.ring_match_usable(cfg, 48, 48)
    assert not paged.ring_match_usable(cfg, 48, 32)
    assert not paged.ring_match_usable(cfg, 17, 16)
    assert paged.ring_match_usable(reduced_config(get_config("llama-7b")), 48, 32)
