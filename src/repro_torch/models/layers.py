"""Core layers of the dense decoder: RoPE, RMSNorm, embedding, LM head, MLP."""
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


# --------------------------------------------------------------------------- #
# Norm
# --------------------------------------------------------------------------- #
def init_norm(cfg: ArchConfig, device) -> Params:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError("LayerNorm archs are not ported yet (ROADMAP queue A item 9)")
    return {"scale": torch.ones(cfg.d_model, dtype=common.resolve_dtype(cfg.param_dtype),
                                device=device)}


def apply_norm(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
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
# MLP (SwiGLU)
# --------------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError("GELU MLPs are not ported yet (ROADMAP queue A item 9)")
    pdtype = common.resolve_dtype(cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": common.dense_init(gen, (D, F), pdtype, device),
        "w_up": common.dense_init(gen, (D, F), pdtype, device),
        "w_down": common.dense_init(gen, (F, D), pdtype, device, fan_in=F),
    }


def apply_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = x @ p["w_gate"].to(dt)
    up = x @ p["w_up"].to(dt)
    return common.swiglu(gate, up) @ p["w_down"].to(dt)
