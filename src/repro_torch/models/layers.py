"""Core layers: RoPE, the sinusoidal table, RMSNorm and LayerNorm, the
embedding, the LM head, and the SwiGLU and GELU MLPs.

The embedding, the LM head and the MLP take the ``model`` axis's process
group as ``group``: their weights are then this rank's shards
(``sharding.param_specs``: vocab rows or columns, FFN columns and rows),
and ``distributed.tensor_parallel``'s operators join the ranks' parts.
Without a group each takes its whole-weight path."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import common
from repro_torch.models.common import Params


# --------------------------------------------------------------------------- #
# Rotary position embedding (Llama rotate-half convention), computed in f32
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    freqs = (theta ** (-np.arange(0, half) / half)).astype(np.float32)
    return torch.from_numpy(freqs).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (absolute token positions)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, d_model: int, device) -> torch.Tensor:
    """The transformer's sinusoidal table ``[max_len, d_model]`` (Whisper's
    encoder positions), built in numpy as the reference builds it, in f32."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d_model)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def init_norm(cfg: ArchConfig, device) -> Params:
    pdtype = common.resolve_dtype(cfg.param_dtype)
    p = {"scale": torch.ones(cfg.d_model, dtype=pdtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=pdtype, device=device)
    return p


def apply_norm(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return common.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return common.rms_norm(x, p["scale"], cfg.norm_eps)


# --------------------------------------------------------------------------- #
# Embedding / LM head
# --------------------------------------------------------------------------- #
def init_embedding(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    pdtype = common.resolve_dtype(cfg.param_dtype)
    params: Params = {
        "table": common.embed_init(gen, (cfg.padded_vocab, cfg.d_model), pdtype, device)
    }
    if not cfg.tie_embeddings:
        params["head"] = common.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), pdtype, device, fan_in=cfg.d_model
        )
    return params


def vocab_slice(p: Params, cfg: ArchConfig, group: Any):
    """(first id, ids) of this rank's vocab shard of ``p``'s table.  The
    padded vocab is a multiple of 128, so every model axis of a power of
    two up to 128 splits it; a table ``param_specs`` leaves whole on more
    than one rank raises."""
    rows = p["table"].shape[0]
    if tp.shard_count(rows, cfg.padded_vocab, group) != tp.group_size(group):
        raise ValueError(f"{cfg.name}: a vocab of {cfg.padded_vocab} does not split over "
                         f"{tp.group_size(group)} model ranks")
    return tp.group_rank(group) * rows, rows


def local_ids(ids: torch.Tensor, first: int, n: int):
    """(index into a shard of ``n`` ids from ``first``, clamped, and whether
    the shard holds the id) for every id of ``ids``."""
    local = ids.long() - first
    owned = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), owned


def embed_tokens(p: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 group: Any = None) -> torch.Tensor:
    """The tokens' rows of the table, in ``cfg.dtype``; with ``group`` and a
    vocab-sharded table each rank gives the rows it holds and zeros
    elsewhere, summed over the ranks."""
    dt = common.resolve_dtype(cfg.dtype)
    if group is None:
        return p["table"][tokens.long()].to(dt)
    first, n = vocab_slice(p, cfg, group)
    idx, owned = local_ids(tokens, first, n)
    rows = p["table"][idx].to(dt)
    return tp.reduce_from_model(torch.where(owned[..., None], rows, torch.zeros_like(rows)),
                                group)


def lm_logits(p: Params, cfg: ArchConfig, x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Final hidden -> vocab logits, in f32; with ``group``, this rank's
    vocab columns (the hidden read through ``copy_to_model`` in f32, so the
    ranks' partial input gradients sum in f32)."""
    if group is not None:
        vocab_slice(p, cfg, group)
    x = tp.copy_to_model(x.float(), group)
    if cfg.tie_embeddings:
        return x @ p["table"].float().T
    return x @ p["head"].float()


# --------------------------------------------------------------------------- #
# MLP: SwiGLU, or the two-matrix GELU form with biases (granite, Whisper)
# --------------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    pdtype = common.resolve_dtype(cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "gelu":
        return {
            "w1": common.dense_init(gen, (D, F), pdtype, device),
            "b1": torch.zeros(F, dtype=pdtype, device=device),
            "w2": common.dense_init(gen, (F, D), pdtype, device, fan_in=F),
            "b2": torch.zeros(D, dtype=pdtype, device=device),
        }
    return {
        "w_gate": common.dense_init(gen, (D, F), pdtype, device),
        "w_up": common.dense_init(gen, (D, F), pdtype, device),
        "w_down": common.dense_init(gen, (F, D), pdtype, device, fan_in=F),
    }


def apply_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """With ``group`` and FFN-sharded weights: the first matrices
    column-parallel, the last row-parallel, its partial sums summed over
    the ranks (before the GELU form's output bias)."""
    dt = x.dtype
    up_w = p["w1"] if cfg.mlp_type == "gelu" else p["w_up"]
    if group is not None and tp.shard_count(up_w.shape[1], cfg.d_ff, group) == 1:
        group = None  # replicated weights: the whole product on every rank
    x = tp.copy_to_model(x, group)
    if cfg.mlp_type == "gelu":
        # jax.nn.gelu's default is the tanh approximation; the biases are
        # added in the activation dtype, as the reference adds them
        h = x @ p["w1"].to(dt) + p["b1"].to(dt)
        h = torch.nn.functional.gelu(h, approximate="tanh")
        return tp.reduce_from_model(h @ p["w2"].to(dt), group) + p["b2"].to(dt)
    gate = x @ p["w_gate"].to(dt)
    up = x @ p["w_up"].to(dt)
    return tp.reduce_from_model(common.swiglu(gate, up) @ p["w_down"].to(dt), group)
