"""Whisper-style encoder-decoder transformer.

The audio frontend (the mel conv stem) is a stub: a request's ``embeds`` are
precomputed frame embeddings ``[B, S_enc, D]``.  LayerNorm, the GELU MLP,
sinusoidal encoder positions and learned decoder positions, as Whisper
(arXiv:2212.04356).

The reusable context state is the decoder's cross-attention K/V of one
audio context (``build_cross_kv``, every decoder layer's); the decoder's
self-attention K/V belong to the request's prompt.

API (the reference's ``models/encdec.py``):
  init(cfg, seed=0, device=None) -> params
  forward(params, cfg, frames [B, S_enc, D], dec_tokens [B, S]) -> (logits [B, S, V], aux 0)
  init_state(cfg, batch, max_len, device=None, dtype=None, enc_len=None) -> EncDecState
  encode(params, cfg, frames [B, S_enc, D]) -> encoder output [B, S_enc, D]
  build_cross_kv(params, cfg, enc_out) -> KVCache [n_dec, B, S_enc, KV, hd]
  prefill(params, cfg, tokens [B, S], state, embeds=None) -> (last logits [B, V], state)
  decode(params, cfg, tokens [B, 1], state) -> (logits [B, V], state)

Layer weights are one dict per layer (the reference stacks them for
``lax.scan``; ``models.convert`` unstacks them); the state keeps the
reference's stacked layout, so a stored context is the same array tree in
both packages.  The self-attention K/V are written in place, as ``lm``
writes its caches.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, layers
from repro_torch.models.attention import KVCache
from repro_torch.models.common import Params, embed_init, resolve_device, resolve_dtype


class EncDecState(NamedTuple):
    pos: torch.Tensor  # [B] int32 decoder positions filled
    self_kv: KVCache  # [n_dec, B, L, KV, hd]
    cross_kv: KVCache  # [n_dec, B, S_enc, KV, hd]


def _layer(c: KVCache, i: int) -> KVCache:
    return KVCache(c.k[i], c.v[i])


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init(cfg: ArchConfig, seed: int = 0, device=None) -> Params:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (the card unless the caller asks for the CPU; on
    ``"meta"``, shapes and dtypes only, as ``lm.init``)."""
    device = resolve_device(device)
    gen = common.seeded_generator(seed, device)
    pdtype = resolve_dtype(cfg.param_dtype)

    def enc_layer():
        return {"norm1": layers.init_norm(cfg, device),
                "attn": attention.init_attention(gen, cfg, device),
                "norm2": layers.init_norm(cfg, device),
                "mlp": layers.init_mlp(gen, cfg, device)}

    def dec_layer():
        return {"norm1": layers.init_norm(cfg, device),
                "self_attn": attention.init_attention(gen, cfg, device),
                "norm_x": layers.init_norm(cfg, device),
                "cross_attn": attention.init_cross_attention(gen, cfg, device),
                "norm2": layers.init_norm(cfg, device),
                "mlp": layers.init_mlp(gen, cfg, device)}

    return {
        "embed": layers.init_embedding(gen, cfg, device),
        "dec_pos": embed_init(gen, (cfg.decoder_seq_len, cfg.d_model), pdtype, device),
        "encoder": [enc_layer() for _ in range(cfg.n_encoder_layers)],
        "enc_norm": layers.init_norm(cfg, device),
        "decoder": [dec_layer() for _ in range(cfg.n_layers)],
        "dec_norm": layers.init_norm(cfg, device),
    }


def init_state(cfg: ArchConfig, batch: int, max_len: int, device=None,
               dtype=None, enc_len=None) -> EncDecState:
    """Zero self-attention K/V of ``max_len`` rows and cross K/V of
    ``enc_len`` rows per slot (the config's ``encoder_seq_len`` unless
    given)."""
    device = resolve_device(device)
    enc_len = cfg.encoder_seq_len if enc_len is None else enc_len
    dtype = dtype or resolve_dtype(cfg.dtype)
    n, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim

    def z(length):
        return torch.zeros((n, batch, length, kv, hd), dtype=dtype, device=device)

    return EncDecState(pos=torch.zeros(batch, dtype=torch.int32, device=device),
                       self_kv=KVCache(z(max_len), z(max_len)),
                       cross_kv=KVCache(z(enc_len), z(enc_len)))


# --------------------------------------------------------------------------- #
# Encoder
# --------------------------------------------------------------------------- #
def encode(params: Params, cfg: ArchConfig, frames) -> torch.Tensor:
    """frames ``[B, S_enc, D]`` (a tensor or an array) -> encoder output
    ``[B, S_enc, D]`` in ``cfg.dtype``: sinusoidal positions, then
    non-causal self-attention and the MLP per layer, pre-norm."""
    device = params["enc_norm"]["scale"].device
    x = torch.as_tensor(frames, device=device).to(resolve_dtype(cfg.dtype))
    S = x.shape[1]
    x = x + layers.sinusoidal_positions(S, cfg.d_model, device)[None].to(x.dtype)
    for lp in params["encoder"]:
        h = layers.apply_norm(lp["norm1"], cfg, x)
        x = x + attention.forward(lp["attn"], cfg, h, causal=False)
        h = layers.apply_norm(lp["norm2"], cfg, x)
        x = x + layers.apply_mlp(lp["mlp"], cfg, h)
    return layers.apply_norm(params["enc_norm"], cfg, x)


def build_cross_kv(params: Params, cfg: ArchConfig, enc_out: torch.Tensor) -> KVCache:
    """Every decoder layer's cross-attention K/V of the encoder output,
    stacked ``[n_dec, B, S_enc, KV, hd]``: the stored context of an audio
    (computed once, reused across requests)."""
    kvs = [attention.cross_kv(lp["cross_attn"], cfg, enc_out) for lp in params["decoder"]]
    return KVCache(torch.stack([c.k for c in kvs]), torch.stack([c.v for c in kvs]))


# --------------------------------------------------------------------------- #
# Decoder
# --------------------------------------------------------------------------- #
def _dec_embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
               offset: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the learned positions ``offset + 0 .. S-1``,
    clamped at ``decoder_seq_len - 1`` (positions past the table reuse its
    last row, as the reference's ``jnp.minimum`` does)."""
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    S = tokens.shape[1]
    pos = offset.long()[:, None] + torch.arange(S, device=x.device)[None]
    pos = pos.clamp(max=cfg.decoder_seq_len - 1)
    return x + params["dec_pos"][pos].to(x.dtype)


def _cross_and_mlp(lp: Params, cfg: ArchConfig, x: torch.Tensor, ckv: KVCache) -> torch.Tensor:
    """A decoder layer after its self-attention: cross-attention, then the
    MLP, each pre-norm."""
    h = layers.apply_norm(lp["norm_x"], cfg, x)
    x = x + attention.cross_attend(lp["cross_attn"], cfg, h, ckv)
    h = layers.apply_norm(lp["norm2"], cfg, x)
    return x + layers.apply_mlp(lp["mlp"], cfg, h)


def forward(
    params: Params, cfg: ArchConfig, frames, dec_tokens: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: encode ``frames``, then decode ``dec_tokens``
    causally from position 0 (self-attention, cross-attention over the
    encoder output and the MLP at every layer, each pre-norm).  Returns the
    f32 logits ``[B, S, V]`` and an aux loss of 0 (the reference's
    ``encdec.forward``).  Both attentions get their gradient through
    ``ops.FlashAttentionFn``."""
    enc_out = encode(params, cfg, frames)
    dec_tokens = torch.as_tensor(dec_tokens, device=enc_out.device)
    B = dec_tokens.shape[0]
    x = _dec_embed(params, cfg, dec_tokens,
                   torch.zeros(B, dtype=torch.int32, device=enc_out.device))
    for lp in params["decoder"]:
        h = layers.apply_norm(lp["norm1"], cfg, x)
        x = x + attention.forward(lp["self_attn"], cfg, h, causal=True)
        x = _cross_and_mlp(lp, cfg, x, attention.cross_kv(lp["cross_attn"], cfg, enc_out))
    x = layers.apply_norm(params["dec_norm"], cfg, x)
    return (layers.lm_logits(params["embed"], cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(
    params: Params, cfg: ArchConfig, tokens: torch.Tensor, state: EncDecState,
    embeds=None,
) -> Tuple[torch.Tensor, EncDecState]:
    """Decoder prefill of ``tokens [B, S]`` after ``state.pos``.  With
    ``embeds`` (audio frames) the audio is encoded and its cross K/V
    replace the state's; without, the state's cross K/V are the reused
    stored context (the paper's technique).  Returns the last token's
    logits ``[B, V]`` and the state with ``pos + S``."""
    cross = state.cross_kv
    if embeds is not None:
        cross = build_cross_kv(params, cfg, encode(params, cfg, embeds))
    S = tokens.shape[1]
    offset = state.pos
    x = _dec_embed(params, cfg, tokens, offset)
    for i, lp in enumerate(params["decoder"]):
        h = layers.apply_norm(lp["norm1"], cfg, x)
        x = x + attention.prefill(lp["self_attn"], cfg, h, _layer(state.self_kv, i), offset)
        x = _cross_and_mlp(lp, cfg, x, _layer(cross, i))
    x = layers.apply_norm(params["dec_norm"], cfg, x[:, -1:])
    logits = layers.lm_logits(params["embed"], cfg, x)[:, 0]
    return logits, EncDecState(pos=offset + S, self_kv=state.self_kv, cross_kv=cross)


def decode(
    params: Params, cfg: ArchConfig, tokens: torch.Tensor, state: EncDecState
) -> Tuple[torch.Tensor, EncDecState]:
    """One token for every slot: self-attention over the slot's rows at or
    below its position (``attention.decode``), cross-attention over every
    cross K/V row; the self K/V are updated in place."""
    pos = state.pos
    x = _dec_embed(params, cfg, tokens, pos)
    for i, lp in enumerate(params["decoder"]):
        h = layers.apply_norm(lp["norm1"], cfg, x)
        x = x + attention.decode(lp["self_attn"], cfg, h, _layer(state.self_kv, i), pos)
        x = _cross_and_mlp(lp, cfg, x, _layer(state.cross_kv, i))
    x = layers.apply_norm(params["dec_norm"], cfg, x)
    logits = layers.lm_logits(params["embed"], cfg, x)[:, 0]
    return logits, EncDecState(pos=pos + 1, self_kv=state.self_kv, cross_kv=state.cross_kv)
