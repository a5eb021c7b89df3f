"""Model API of the port and its analytic parameter counts.

The JAX package counts parameters by tracing ``init`` with
``jax.eval_shape``; the port counts them from the config, and its tests hold
the two counts equal."""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.blocks import block_kinds


class ModelApi(NamedTuple):
    """The model's functions on the serving path (see ``models.lm``).  The
    packed, paged, chunked and fused calls raise for a stack with Mamba
    layers, as the reference's assert."""

    init: Callable[..., Any]
    init_state: Callable[..., Any]
    prefill: Callable[..., Any]
    prefill_packed: Callable[..., Any]
    decode: Callable[..., Any]
    decode_paged: Callable[..., Any]
    prefill_chunked: Callable[..., Any]
    prefill_fused: Callable[..., Any]


def _check_ported(cfg: ArchConfig) -> None:
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid") or cfg.norm_type != "rmsnorm"
            or cfg.mlp_type != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: only dense, MoE, SSM and hybrid RMSNorm/SwiGLU archs are ported "
            "yet; encoder-decoder, VLM, LayerNorm and GELU archs are ROADMAP queue A item 9"
        )


def get_model(cfg: ArchConfig) -> ModelApi:
    _check_ported(cfg)
    return ModelApi(
        init=lm.init, init_state=lm.init_state, prefill=lm.prefill,
        prefill_packed=lm.prefill_packed, decode=lm.decode, decode_paged=lm.decode_paged,
        prefill_chunked=lm.prefill_chunked, prefill_fused=lm.prefill_fused,
    )


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
    return D + 3 * D * cfg.d_ff if ffn == "mlp" else 0  # norm2 and SwiGLU


@functools.lru_cache(maxsize=None)
def count_params(cfg: ArchConfig) -> int:
    """Exact parameter count of the implemented model (padded embedding
    table, biases and norms included), summed over the block kinds of one
    period (``blocks.block_kinds``) times the periods."""
    _check_ported(cfg)
    kinds = block_kinds(cfg)
    embed = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    period = sum(cfg.d_model + _mixer_params(cfg, k.mixer) + _ffn_params(cfg, k.ffn)
                 for k in kinds)  # norm1, the mixer and the FFN of each layer
    return embed + cfg.n_layers // len(kinds) * period + cfg.d_model  # final norm


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
