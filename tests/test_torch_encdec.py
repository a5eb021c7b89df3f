"""The port's encoder-decoder family (whisper-tiny) against the JAX package's.

Whisper encodes a request's audio frames (``Request.embeds``, a stub for the
mel frontend) once; every decoder layer's cross-attention K/V of that
encoder output is the reusable context, and the decoder's self-attention
K/V belong to the prompt.  Reduced whisper (2 encoder and 2 decoder layers,
32 frames, 64 decoder positions, d_model 64, LayerNorm, GELU, f32) runs on
weights converted from the reference's, the reference on its plain kernels:

  * LayerNorm and the sinusoidal table at atol 1e-6;
  * ``attention.forward`` (causal and not), ``cross_kv`` and
    ``cross_attend`` at atol 2e-5;
  * ``encode``, ``prefill`` with frames and over a stored cross K/V, and
    ``decode`` at logits atol 5e-5; the stored artifact is the reference's
    tree (an empty self K/V, ``pos`` 0), its bytes and checksum;
  * ``tests/test_serving.py::test_whisper_cross_kv_reuse`` replayed on both
    engines (records, summaries and events at 1e-9, tokens exact), also
    with ``paged_decode=True`` and ``unified_step=True`` (quietly dense, as
    in the reference) and with decoder positions past ``decoder_seq_len``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kvcache import compression as jcompression  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kvcache import compression, faults, paged  # noqa: E402
from repro_torch.models import attention, common, encdec, layers, registry  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from test_torch_engine import _replay_on_both, _run_port, _setup  # noqa: E402

torch.set_num_threads(1)
ARCH = "whisper-tiny"
LAYER_ATOL = 1e-6
ATTN_ATOL = 2e-5
ATOL = 5e-5
MAX_LEN = 64


@pytest.fixture(scope="module")
def whisper():
    return _setup(ARCH)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #
def test_layer_norm_and_sinusoidal_table_match_reference():
    """LayerNorm (f32, population variance, random scale and bias, bf16 in
    and out as well) and the sinusoidal table at atol 1e-6."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 7, 64)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    got = common.layer_norm(_t(x), _t(w), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_ATOL)
    want16 = jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                                1e-5)
    got16 = common.layer_norm(_t(x).bfloat16(), _t(w), _t(b), 1e-5)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32),
                               rtol=2 ** -7, atol=LAYER_ATOL)  # one bf16 rounding
    cfg = reduced_config(get_config(ARCH))
    p = layers.init_norm(cfg, "cpu")
    assert sorted(p) == sorted(jlayers.init_norm(jreduced(jget_config(ARCH))))
    for S, D in ((32, 64), (1500, 384)):
        np.testing.assert_allclose(layers.sinusoidal_positions(S, D, "cpu").numpy(),
                                   np.asarray(jlayers.sinusoidal_positions(S, D)),
                                   atol=LAYER_ATOL)


@pytest.mark.parametrize("arch,causal", [(ARCH, False), (ARCH, True), ("qwen2-1.5b", True)])
def test_attention_forward_matches_reference(arch, causal):
    """``attention.forward`` over a call's own tokens (no cache), causal and
    not, with RoPE and QKV biases (qwen2) and without (whisper): 2e-5."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced_config(get_config(arch))
    jp = jax.tree_util.tree_map(np.asarray, jattention.init_attention(jax.random.PRNGKey(1),
                                                                      jcfg))
    rng = np.random.default_rng(1)
    jp = {k: (v if k.startswith("w") else rng.standard_normal(v.shape).astype(np.float32))
          for k, v in jp.items()}
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    want = jattention.forward({k: jnp.asarray(v) for k, v in jp.items()}, jcfg, jnp.asarray(x),
                              causal=causal)
    got = attention.forward({k: _t(v) for k, v in jp.items()}, cfg, _t(x), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)


def test_cross_kv_and_cross_attend_match_reference(whisper):
    """The cross K/V of an encoder output and the decoder tokens' attention
    over it (one query row, as at a decode step, and eight): 2e-5.  A
    causal read of the same rows (``decode_attention``'s mask at position
    0) would keep row 0 alone and miss."""
    jcfg, jparams, cfg, params = whisper
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["decoder"]["cross_attn"])
    p = params["decoder"][0]["cross_attn"]
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jckv = jattention.cross_kv(jp, jcfg, jnp.asarray(enc))
    ckv = attention.cross_kv(p, cfg, _t(enc))
    for got, want in zip(ckv, jckv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)
    for S in (1, 8):
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        want = np.asarray(jattention.cross_attend(jp, jcfg, jnp.asarray(x), jckv))
        got = attention.cross_attend(p, cfg, _t(x), ckv)
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL)
    q = (_t(x[:, :1]) @ p["wq"].reshape(cfg.d_model, -1)).view(2, 1, cfg.n_heads, -1)
    row0 = ops.decode_attention(
        q, ckv.k, ckv.v, q_pos=torch.zeros(2, 1, dtype=torch.int32),
        kv_pos=torch.arange(32, dtype=torch.int32)[None].expand(2, 32).contiguous())
    assert (attention._out(p, row0) - got[:, :1]).abs().max().item() > 100 * ATTN_ATOL


# --------------------------------------------------------------------------- #
# The model against the reference
# --------------------------------------------------------------------------- #
def test_encode_prefill_and_decode_match_reference(whisper):
    """``encode``; ``prefill`` of a prompt with frames (the encoder runs and
    its cross K/V land in the state); ``prefill`` of another prompt over
    the stored cross K/V (the load path); two decode steps after each.
    Logits at 5e-5 with the reference's argmax."""
    jcfg, jparams, cfg, params = whisper
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(encdec.encode(params, cfg, frames).numpy(),
                               np.asarray(jencdec.encode(jparams, jcfg, jnp.asarray(frames))),
                               atol=ATOL)
    prompt = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    jl, js = jencdec.prefill(jparams, jcfg, jnp.asarray(prompt),
                             jencdec.init_state(jcfg, 2, MAX_LEN), embeds=jnp.asarray(frames))
    tl, ts = encdec.prefill(params, cfg, _t(prompt),
                            encdec.init_state(cfg, 2, MAX_LEN, device="cpu"), embeds=frames)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert ts.pos.tolist() == [8, 8]
    # the stored context: slot 1's cross K/V, restarted at position 0
    jart = jpaged.extract_slot(jcfg, js, 1, 32)
    jfresh = jpaged.insert_slot(jcfg, jencdec.init_state(jcfg, 1, MAX_LEN), 0, jart)
    fresh = paged.insert_slot(cfg, encdec.init_state(cfg, 1, MAX_LEN, device="cpu"), 0,
                              paged.extract_slot(cfg, ts, 1, 32))
    other = rng.integers(0, cfg.vocab, (1, 5)).astype(np.int32)
    jl2, js2 = jencdec.prefill(jparams, jcfg, jnp.asarray(other), jfresh)
    tl2, ts2 = encdec.prefill(params, cfg, _t(other), fresh)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)
    assert ts2.pos.tolist() == [5]
    for (jd, jst, td, tst) in ((jl, js, tl, ts), (jl2, js2, tl2, ts2)):
        for _ in range(2):
            nxt = np.asarray(jd).argmax(-1)[:, None].astype(np.int32)
            assert td.argmax(-1).tolist() == nxt[:, 0].tolist()
            jd, jst = jencdec.decode(jparams, jcfg, jnp.asarray(nxt), jst)
            td, tst = encdec.decode(params, cfg, _t(nxt), tst)
            np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)


def test_stored_artifact_is_the_reference_tree(whisper):
    """The stored artifact of an audio context: ``pos`` 0, an empty self
    K/V and the cross K/V of every decoder layer, the reference's shapes,
    dtypes, byte count and checksum; on the host, then back in a slot."""
    jcfg, jparams, cfg, params = whisper
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((1, 32, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab, (1, 4)).astype(np.int32)
    _, js = jencdec.prefill(jparams, jcfg, jnp.asarray(prompt), jencdec.init_state(jcfg, 1, 16),
                            embeds=jnp.asarray(frames))
    _, ts = encdec.prefill(params, cfg, _t(prompt), encdec.init_state(cfg, 1, 16, device="cpu"),
                           embeds=frames)
    jart = jax.tree_util.tree_map(np.asarray, jpaged.extract_slot(jcfg, js, 0, 32))
    art = paged.extract_slot(cfg, ts, 0, 32)
    assert isinstance(art, encdec.EncDecState) and paged.artifact_length(art) == 0
    got, want = list(compression.tree_leaves(art)), jax.tree_util.tree_leaves(jart)
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    assert art.self_kv.k.shape == (2, 1, 0, cfg.n_kv_heads, cfg.resolved_head_dim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATTN_ATOL)
    assert compression.tree_nbytes(art) == jcompression.tree_nbytes(jart)
    ported = encdec.EncDecState(np.asarray(jart.pos), KVCache(*jart.self_kv),
                                KVCache(*jart.cross_kv))
    back = paged.extract_slot(cfg, paged.insert_slot(
        cfg, encdec.init_state(cfg, 2, 16, device="cpu"), 1, ported), 1, 32)
    assert faults.payload_checksum(back) == jfaults.payload_checksum(jart)


def test_counts_and_conversion_match_reference(whisper):
    """The encoder-decoder's parameter tree: full and reduced counts the
    reference's, every converted leaf the reference's per layer; no packed,
    paged, chunked or fused entry point."""
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (reduced_config(get_config(ARCH)), jreduced(jget_config(ARCH)))):
        assert registry.count_params(cfg) == jregistry.count_params(jcfg)
        assert registry.count_active_params(cfg) == registry.count_params(cfg)
    assert registry.count_params(get_config(ARCH)) == 36_675_072
    api = registry.get_model(whisper[2])
    assert (api.prefill_packed, api.decode_paged, api.prefill_chunked, api.prefill_fused) == (
        None, None, None, None)
    assert not paged.packable_arch(whisper[2], 128) and not paged.partial_reuse_allowed(
        whisper[2])
    jcfg, jparams, cfg, params = whisper
    assert len(params["encoder"]) == 2 and len(params["decoder"]) == 2
    for i in range(2):
        for path, leaf in jax.tree_util.tree_leaves_with_path(jparams["decoder"]):
            node = params["decoder"][i]
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf)[i])
    np.testing.assert_array_equal(params["dec_pos"].numpy(), np.asarray(jparams["dec_pos"]))
    fresh = encdec.init(cfg, device="cpu")
    again = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert compression.tree_nbytes(fresh) == compression.tree_nbytes(again)


# --------------------------------------------------------------------------- #
# The engine against the reference's
# --------------------------------------------------------------------------- #
def _audio_requests(cfg, seed=5, n=3, prompt_len=8, new=3):
    """``tests/test_serving.py:143``'s mix, from its seed: ``n`` requests
    over one audio (its frames and a 32-token identity proxy)."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((1, 32, cfg.d_model)).astype(np.float32)
    ctx_proxy = list(map(int, rng.integers(0, 1000, 32)))
    prompt = list(map(int, rng.integers(0, cfg.vocab, prompt_len)))
    return [dict(req_id=i, context_tokens=ctx_proxy, prompt_tokens=prompt, max_new_tokens=new,
                 arrival_s=i * 0.01, expected_reuses=3, embeds=frames) for i in range(n)]


MODES = {"dense": {}, "paged_decode": dict(paged_decode=True),
         "unified_step": dict(paged_decode=True, unified_step=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_whisper_cross_kv_reuse(whisper, mode):
    """``tests/test_serving.py:143`` on both engines: the stored cross K/V is
    loaded twice and generates recompute's tokens.  Under
    ``paged_decode=True`` and ``unified_step=True`` the arch keeps the
    per-request path and dense decode, as the reference's engine does."""
    reqs = _audio_requests(whisper[2])
    eng, events = _replay_on_both(whisper, reqs, "always", **MODES[mode])
    off, _ = _run_port(*whisper[2:], reqs, reuse_enabled=False, **MODES[mode])
    assert {r.req_id: r.tokens for r in eng.records} == {r.req_id: r.tokens for r in off.records}
    assert [r.action for r in sorted(eng.records, key=lambda r: r.req_id)] == [
        "recompute", "load", "load"]
    assert eng.batches == 0 and eng.decode_stats()["paged"] is False
    assert eng.unified_stats()["steps"] == 0
    (entry,) = eng.store.entries.values()
    # cross K and V of two decoder layers for 32 frames, f32, and the int32 pos
    per_frame = 2 * 2 * whisper[2].n_kv_heads * whisper[2].resolved_head_dim * 4
    assert entry.nbytes == 32 * per_frame + 4
    loads = [e for e in events if type(e).__name__ == "KVLoaded"]
    assert [e.matched_tokens for e in loads] == [32, 32]


def test_decoder_positions_past_the_table(whisper):
    """``max_len`` above ``decoder_seq_len`` (64): a 60-token prompt and 12
    new tokens run past the learned table, whose last row the positions
    reuse, on both engines alike."""
    reqs = _audio_requests(whisper[2], seed=8, n=2, prompt_len=60, new=12)
    eng, _ = _replay_on_both(whisper, reqs, "always", max_len=128)
    assert max(len(r.tokens) for r in eng.records) == 12
    assert [r.action for r in sorted(eng.records, key=lambda r: r.req_id)] == [
        "recompute", "load"]


def test_reduced_config_keeps_the_encoder():
    """The reduced config: 2 encoder layers over 32 frames, 64 decoder
    positions, LayerNorm and GELU kept, as the reference's."""
    cfg = reduced_config(get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jreduced(jget_config(ARCH)))
    assert (cfg.n_encoder_layers, cfg.encoder_seq_len, cfg.decoder_seq_len) == (2, 32, 64)
    assert (cfg.norm_type, cfg.mlp_type, cfg.rope_theta) == ("layernorm", "gelu", None)
