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
    """The dense family's functions on the serving path (see ``models.lm``)."""

    init: Callable[..., Any]
    init_state: Callable[..., Any]
    prefill_packed: Callable[..., Any]
    decode: Callable[..., Any]


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.norm_type != "rmsnorm" or cfg.mlp_type != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: only dense RMSNorm/SwiGLU archs are ported yet "
            "(ROADMAP queue A item 12)"
        )


def get_model(cfg: ArchConfig) -> ModelApi:
    _check_dense(cfg)
    return ModelApi(
        init=lm.init, init_state=lm.init_state,
        prefill_packed=lm.prefill_packed, decode=lm.decode,
    )


@functools.lru_cache(maxsize=None)
def count_params(cfg: ArchConfig) -> int:
    """Exact parameter count of the implemented model (padded embedding
    table, biases and norms included)."""
    _check_dense(cfg)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    embed = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.qkv_bias:
        attn += H * hd + 2 * KV * hd
    layer = 2 * D + attn + 3 * D * cfg.d_ff  # two norms, attention, SwiGLU
    return embed + cfg.n_layers * layer + D  # + final norm


def count_active_params(cfg: ArchConfig) -> int:
    """Active parameters per token: every parameter, for a dense arch."""
    return count_params(cfg)
