"""Model API of the port and its analytic parameter counts.

The JAX package counts parameters by tracing ``init`` with
``jax.eval_shape``; the port counts them from the config, and its tests hold
the two counts equal."""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


class ModelApi(NamedTuple):
    """The model's functions on the serving path (see ``models.lm``).  The
    packed, paged, chunked and fused calls raise for an SSM stack, as the
    reference's assert."""

    init: Callable[..., Any]
    init_state: Callable[..., Any]
    prefill: Callable[..., Any]
    prefill_packed: Callable[..., Any]
    decode: Callable[..., Any]
    decode_paged: Callable[..., Any]
    prefill_chunked: Callable[..., Any]
    prefill_fused: Callable[..., Any]


def _check_ported(cfg: ArchConfig) -> None:
    if (cfg.family not in ("dense", "moe", "ssm") or cfg.norm_type != "rmsnorm"
            or cfg.mlp_type != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: only dense, MoE and SSM RMSNorm/SwiGLU archs are ported yet; "
            "hybrid, encoder-decoder, VLM, LayerNorm and GELU archs are ROADMAP queue A "
            "item 9"
        )


def get_model(cfg: ArchConfig) -> ModelApi:
    _check_ported(cfg)
    return ModelApi(
        init=lm.init, init_state=lm.init_state, prefill=lm.prefill,
        prefill_packed=lm.prefill_packed, decode=lm.decode, decode_paged=lm.decode_paged,
        prefill_chunked=lm.prefill_chunked, prefill_fused=lm.prefill_fused,
    )


@functools.lru_cache(maxsize=None)
def count_params(cfg: ArchConfig) -> int:
    """Exact parameter count of the implemented model (padded embedding
    table, biases and norms included)."""
    _check_ported(cfg)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    embed = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in, n_h = s.d_inner(D), s.n_ssm_heads(D)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        mixer = (D * (d_in + conv_dim + n_h)  # in_proj (z | xBC | dt)
                 + (s.d_conv + 1) * conv_dim  # conv weight and bias
                 + 3 * n_h  # A_log, D_skip, dt_bias
                 + d_in + d_in * D)  # the gated norm, out_proj
    else:
        mixer = D * H * hd + 2 * D * KV * hd + H * hd * D
        if cfg.qkv_bias:
            mixer += H * hd + 2 * KV * hd
    if cfg.moe is not None:  # norm2, the f32 router and E SwiGLU experts
        ffn = D + D * cfg.moe.n_experts + cfg.moe.n_experts * 3 * D * cfg.d_ff
    else:
        ffn = D + 3 * D * cfg.d_ff if cfg.d_ff else 0  # norm2 and SwiGLU
    return embed + cfg.n_layers * (D + mixer + ffn) + D  # norm1 per layer, final norm


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
    """MoE layers of the stack: every layer of the uniform MoE family."""
    return cfg.n_layers
