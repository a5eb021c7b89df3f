"""Model API of the port and its analytic parameter counts.

The JAX package counts parameters by tracing ``init`` with
``jax.eval_shape``; the port counts them from the config, and its tests hold
the two counts equal."""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm
from repro_torch.models.blocks import block_kinds


class ModelApi(NamedTuple):
    """The model's functions on the serving path (see ``models.lm`` and
    ``models.encdec``).  The packed, paged, chunked and fused calls raise
    for a stack with Mamba layers, as the reference's assert; an
    encoder-decoder arch has none of them (None), as in the reference, and
    the engine serves it per request with dense decode."""

    init: Callable[..., Any]
    init_state: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    prefill_packed: Optional[Callable[..., Any]] = None
    decode_paged: Optional[Callable[..., Any]] = None
    prefill_chunked: Optional[Callable[..., Any]] = None
    prefill_fused: Optional[Callable[..., Any]] = None


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family == "encdec":
        return ModelApi(init=encdec.init, init_state=encdec.init_state,
                        prefill=encdec.prefill, decode=encdec.decode)
    return ModelApi(
        init=lm.init, init_state=lm.init_state, prefill=lm.prefill, decode=lm.decode,
        prefill_packed=lm.prefill_packed, decode_paged=lm.decode_paged,
        prefill_chunked=lm.prefill_chunked, prefill_fused=lm.prefill_fused,
    )


def _norm_params(cfg: ArchConfig) -> int:
    return cfg.d_model * (2 if cfg.norm_type == "layernorm" else 1)  # scale (and bias)


def _mlp_params(cfg: ArchConfig) -> int:
    D, F = cfg.d_model, cfg.d_ff
    return 2 * D * F + F + D if cfg.mlp_type == "gelu" else 3 * D * F


def _mixer_params(cfg: ArchConfig, mixer: str) -> int:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if mixer == "m":
        s = cfg.ssm
        d_in, n_h = s.d_inner(D), s.n_ssm_heads(D)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        return (D * (d_in + conv_dim + n_h)  # in_proj (z | xBC | dt)
                + (s.d_conv + 1) * conv_dim  # conv weight and bias
                + 3 * n_h  # A_log, D_skip, dt_bias
                + d_in + d_in * D)  # the gated norm, out_proj
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    return attn + (H * hd + 2 * KV * hd if cfg.qkv_bias else 0)


def _ffn_params(cfg: ArchConfig, ffn: str) -> int:
    D = cfg.d_model
    if ffn == "moe":  # norm2, the f32 router and E SwiGLU experts
        return D + D * cfg.moe.n_experts + cfg.moe.n_experts * 3 * D * cfg.d_ff
    return _norm_params(cfg) + _mlp_params(cfg) if ffn == "mlp" else 0  # norm2 and the MLP


@functools.lru_cache(maxsize=None)
def count_params(cfg: ArchConfig) -> int:
    """Exact parameter count of the implemented model (padded embedding
    table, biases and norms included), summed over the block kinds of one
    period (``blocks.block_kinds``) times the periods; an encoder-decoder
    arch's over its encoder and decoder layers."""
    embed = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    norm, attn, mlp = _norm_params(cfg), _mixer_params(cfg, "a"), _mlp_params(cfg)
    if cfg.family == "encdec":  # decoder positions, the encoder, the decoder, two norms
        return (embed + cfg.decoder_seq_len * cfg.d_model
                + cfg.n_encoder_layers * (2 * norm + attn + mlp)
                + cfg.n_layers * (3 * norm + 2 * attn + mlp) + 2 * norm)
    kinds = block_kinds(cfg)
    period = sum(_norm_params(cfg) + _mixer_params(cfg, k.mixer) + _ffn_params(cfg, k.ffn)
                 for k in kinds)  # norm1, the mixer and the FFN of each layer
    return embed + cfg.n_layers // len(kinds) * period + _norm_params(cfg)  # final norm


@functools.lru_cache(maxsize=None)
def count_active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: only ``top_k`` of ``n_experts``
    experts count), as ``PerfModel`` prices every prefill, decode and load."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    return total - _moe_layer_count(cfg) * (cfg.moe.n_experts - cfg.moe.top_k) * per_expert


def _moe_layer_count(cfg: ArchConfig) -> int:
    """MoE layers of the stack: the MoE positions of one period
    (``blocks.block_kinds``) times the periods."""
    kinds = block_kinds(cfg)
    return sum(k.ffn == "moe" for k in kinds) * (cfg.n_layers // len(kinds))
