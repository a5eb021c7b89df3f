"""Decoder blocks: (attention | mamba) mixer + optional (MLP | MoE) FFN,
pre-norm.

A block is described by a static :class:`BlockKind`, as in the reference's
``models/blocks.py``: the dense and VLM (``("a", "mlp")``), MoE (``("a",
"moe")``) and SSM (``("m", "none")``) kinds, and the hybrid family's mix of
``a`` and ``m`` mixers with MLP and MoE FFNs.  The MoE FFN's aux
loss is a training term: ``forward`` (the training forward) returns it, and
the serving paths drop it, as the reference's ``lm.py`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.common import Params


class BlockKind(NamedTuple):
    mixer: str  # "a" (attention) | "m" (mamba)
    ffn: str  # "mlp" | "moe" | "none"


def block_kinds(cfg: ArchConfig) -> Tuple[BlockKind, ...]:
    """Static per-layer block kinds of one period: length 1 for the uniform
    families; the whole ``hybrid_period`` for a hybrid arch, with MoE on
    period index ``i`` where ``i % moe.every == moe.offset`` and an MLP
    elsewhere."""
    if cfg.family == "hybrid":
        assert cfg.hybrid_period is not None and cfg.moe is not None
        return tuple(
            BlockKind(mixer, "moe" if i % cfg.moe.every == cfg.moe.offset else "mlp")
            for i, mixer in enumerate(cfg.hybrid_period)
        )
    if cfg.family == "ssm":
        return (BlockKind("m", "none" if cfg.d_ff == 0 else "mlp"),)
    if cfg.family == "moe":
        assert cfg.moe is not None and cfg.moe.every == 1, (
            "uniform stacks need MoE on every layer; use family='hybrid' otherwise"
        )
        return (BlockKind("a", "moe"),)
    return (BlockKind("a", "mlp"),)  # dense and VLM (the encoder-decoder: models.encdec)


class BlockCache(NamedTuple):
    """One layer kind's cache; the member of the other mixer is None.  Both
    fields keep stored artifacts in the reference's tree structure, so their
    byte counts and checksums agree."""

    attn: Optional[attention.KVCache]
    mamba: Optional[ssm.MambaState] = None


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: BlockKind, device) -> Params:
    p: Params = {"norm1": layers.init_norm(cfg, device)}
    if kind.mixer == "a":
        p["attn"] = attention.init_attention(gen, cfg, device)
    else:
        p["mamba"] = ssm.init_mamba(gen, cfg, device)
    if kind.ffn != "none":
        p["norm2"] = layers.init_norm(cfg, device)
        p["ffn"] = (moe.init_moe(gen, cfg, device) if kind.ffn == "moe"
                    else layers.init_mlp(gen, cfg, device))
    return p


def init_block_cache(cfg: ArchConfig, kind: BlockKind, n: int, batch: int, max_len: int,
                     device, dtype: torch.dtype) -> BlockCache:
    """The caches of ``n`` layers of ``kind``, stacked on a leading axis:
    K/V ``[n, B, L, KV, hd]`` with ``L = min(max_len, window)`` on a
    sliding-window arch (a ring, ``attention._ring``) and ``max_len``
    otherwise, or the mamba state ``conv [n, B, d_conv-1, conv_dim]``
    (``dtype``) and ``ssd [n, B, H, P, S]`` (f32)."""
    if kind.mixer == "a":
        length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        shape = (n, batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
        return BlockCache(attention.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                                            torch.zeros(shape, dtype=dtype, device=device)))
    one = ssm.init_mamba_state(cfg, batch, device, dtype)
    return BlockCache(None, ssm.MambaState(*(t.expand(n, *t.shape).clone() for t in one)))


def _ffn(p: Params, cfg: ArchConfig, kind: BlockKind,
         x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN's residual step and its aux loss (the MoE's load-balancing
    term; 0 for an MLP or none), f32 scalar."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind.ffn == "none":
        return x, zero
    h = layers.apply_norm(p["norm2"], cfg, x)
    if kind.ffn == "moe":
        out, aux = moe.apply_moe(p["ffn"], cfg, h)
        return x + out, aux
    return x + layers.apply_mlp(p["ffn"], cfg, h), zero


def _apply_ffn(p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor) -> torch.Tensor:
    return _ffn(p, cfg, kind, x)[0]


# --------------------------------------------------------------------------- #
# Training forward (no cache)
# --------------------------------------------------------------------------- #
def forward(
    p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over the call's own tokens (attention causally at
    ``positions``, or the Mamba mixer from a zero state), returning ``(x,
    aux)`` (the reference's ``blocks.forward``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    if kind.mixer == "a":
        x = x + attention.forward(p["attn"], cfg, h, positions=positions)
    else:
        x = x + ssm.forward(p["mamba"], cfg, h)[0]
    return _ffn(p, cfg, kind, x)


def _write_state(dst: ssm.MambaState, src: ssm.MambaState) -> None:
    """Land a layer's new mamba state in the model state, in place."""
    dst.conv.copy_(src.conv)
    dst.ssd.copy_(src.ssd)


def prefill(
    p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor, cache: BlockCache,
    offset: torch.Tensor,
) -> torch.Tensor:
    """Full or suffix prefill of one block: ``attention.prefill`` writes the
    new K/V rows, or the mamba mixer's new state replaces the layer's, in
    place."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    if kind.mixer == "a":
        x = x + attention.prefill(p["attn"], cfg, h, cache.attn, offset)
    else:
        out, st = ssm.forward(p["mamba"], cfg, h, state=cache.mamba)
        _write_state(cache.mamba, st)
        x = x + out
    return _apply_ffn(p, cfg, kind, x)


def decode(
    p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor, cache: BlockCache,
    pos: torch.Tensor,
) -> torch.Tensor:
    h = layers.apply_norm(p["norm1"], cfg, x)
    if kind.mixer == "a":
        x = x + attention.decode(p["attn"], cfg, h, cache.attn, pos)
    else:
        out, st = ssm.decode(p["mamba"], cfg, h, cache.mamba)
        _write_state(cache.mamba, st)
        x = x + out
    return _apply_ffn(p, cfg, kind, x)


# --------------------------------------------------------------------------- #
# Attention-only modes (SSM state mixes along the sequence: it cannot be
# packed, fused, paged or chunked)
# --------------------------------------------------------------------------- #
def prefill_packed(
    p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor, cache: attention.KVCache,
    **layout,
) -> torch.Tensor:
    """Packed ragged prefill of one block (``attention.prefill_packed``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill_packed(p["attn"], cfg, h, cache, **layout)
    return _apply_ffn(p, cfg, kind, x)


def prefill_fused(
    p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor, cache: attention.KVCache,
    **layout,
) -> torch.Tensor:
    """Selective-recompute fused prefill of one block (``attention.prefill_fused``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill_fused(p["attn"], cfg, h, cache, **layout)
    return _apply_ffn(p, cfg, kind, x)


def decode_paged(
    p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor, pool: attention.KVCache,
    block_table: torch.Tensor, pos: torch.Tensor, *, block: int,
) -> torch.Tensor:
    """Paged decode of one block (``attention.decode_paged``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.decode_paged(p["attn"], cfg, h, pool, block_table, pos, block=block)
    return _apply_ffn(p, cfg, kind, x)


def prefill_chunked(
    p: Params, cfg: ArchConfig, kind: BlockKind, x: torch.Tensor, pool: attention.KVCache,
    block_table: torch.Tensor, q_pos: torch.Tensor, *, block: int,
) -> torch.Tensor:
    """Chunked prefill of one block over the pool (``attention.prefill_chunked``)."""
    h = layers.apply_norm(p["norm1"], cfg, x)
    x = x + attention.prefill_chunked(p["attn"], cfg, h, pool, block_table, q_pos,
                                      block=block)
    return _apply_ffn(p, cfg, kind, x)
