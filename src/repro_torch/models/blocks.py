"""The dense decoder block: attention mixer + SwiGLU MLP, pre-norm."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers
from repro_torch.models.common import Params


class BlockCache(NamedTuple):
    """One layer kind's cache.  ``mamba`` is always None in the port: the
    field keeps stored artifacts in the reference's tree structure, so their
    byte counts and checksums agree."""

    attn: Optional[attention.KVCache]
    mamba: None = None


def init_block(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    return {
        "norm1": layers.init_norm(cfg, device),
        "attn": attention.init_attention(gen, cfg, device),
        "norm2": layers.init_norm(cfg, device),
        "ffn": layers.init_mlp(gen, cfg, device),
    }


def _apply_ffn(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return x + layers.apply_mlp(p["ffn"], cfg, layers.apply_norm(p["norm2"], cfg, x))


def prefill_packed(
    p: Params, cfg: ArchConfig, x: torch.Tensor, cache: attention.KVCache, **layout
) -> torch.Tensor:
    """Packed ragged prefill of one block (``attention.prefill_packed``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill_packed(p["attn"], cfg, h, cache, **layout)
    return _apply_ffn(p, cfg, x)


def decode(
    p: Params, cfg: ArchConfig, x: torch.Tensor, cache: attention.KVCache,
    pos: torch.Tensor,
) -> torch.Tensor:
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.decode(p["attn"], cfg, h, cache, pos)
    return _apply_ffn(p, cfg, x)
