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


def prefill(
    p: Params, cfg: ArchConfig, x: torch.Tensor, cache: attention.KVCache,
    offset: torch.Tensor,
) -> torch.Tensor:
    """Full or suffix prefill of one block (``attention.prefill``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill(p["attn"], cfg, h, cache, offset)
    return _apply_ffn(p, cfg, x)


def prefill_packed(
    p: Params, cfg: ArchConfig, x: torch.Tensor, cache: attention.KVCache, **layout
) -> torch.Tensor:
    """Packed ragged prefill of one block (``attention.prefill_packed``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill_packed(p["attn"], cfg, h, cache, **layout)
    return _apply_ffn(p, cfg, x)


def prefill_fused(
    p: Params, cfg: ArchConfig, x: torch.Tensor, cache: attention.KVCache, **layout
) -> torch.Tensor:
    """Selective-recompute fused prefill of one block (``attention.prefill_fused``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill_fused(p["attn"], cfg, h, cache, **layout)
    return _apply_ffn(p, cfg, x)


def decode(
    p: Params, cfg: ArchConfig, x: torch.Tensor, cache: attention.KVCache,
    pos: torch.Tensor,
) -> torch.Tensor:
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.decode(p["attn"], cfg, h, cache, pos)
    return _apply_ffn(p, cfg, x)


def decode_paged(
    p: Params, cfg: ArchConfig, x: torch.Tensor, pool: attention.KVCache,
    block_table: torch.Tensor, pos: torch.Tensor, *, block: int,
) -> torch.Tensor:
    """Paged decode of one block (``attention.decode_paged``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.decode_paged(p["attn"], cfg, h, pool, block_table, pos, block=block)
    return _apply_ffn(p, cfg, x)


def prefill_chunked(
    p: Params, cfg: ArchConfig, x: torch.Tensor, pool: attention.KVCache,
    block_table: torch.Tensor, q_pos: torch.Tensor, *, block: int,
) -> torch.Tensor:
    """Chunked prefill of one block over the pool (``attention.prefill_chunked``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill_chunked(p["attn"], cfg, h, pool, block_table, q_pos,
                                      block=block)
    return _apply_ffn(p, cfg, x)
