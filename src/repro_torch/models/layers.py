"""Core layers: RoPE, the sinusoidal table, RMSNorm and LayerNorm, the
embedding, the LM head, and the SwiGLU and GELU MLPs."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
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


def embed_tokens(p: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()].to(common.resolve_dtype(cfg.dtype))


def lm_logits(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final hidden -> vocab logits, in f32."""
    if cfg.tie_embeddings:
        return x.float() @ p["table"].float().T
    return x.float() @ p["head"].float()


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


def apply_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_type == "gelu":
        # jax.nn.gelu's default is the tanh approximation; the biases are
        # added in the activation dtype, as the reference adds them
        h = x @ p["w1"].to(dt) + p["b1"].to(dt)
        h = torch.nn.functional.gelu(h, approximate="tanh")
        return h @ p["w2"].to(dt) + p["b2"].to(dt)
    gate = x @ p["w_gate"].to(dt)
    up = x @ p["w_up"].to(dt)
    return common.swiglu(gate, up) @ p["w_down"].to(dt)
