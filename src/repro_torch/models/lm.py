"""Decoder-only dense LM: the serving path's packed prefill and decode.

API:
  init(cfg, seed=0, device=None) -> params
  init_state(cfg, batch, max_len, device=None) -> LMState
  prefill_packed(params, cfg, tokens, caches, **layout) -> (logits [n, V], caches)
  decode(params, cfg, tokens [B, 1], state) -> (logits [B, V], LMState)

Layer weights are one dict per layer (the JAX package stacks them over
periods for ``lax.scan``; ``models.convert`` unstacks them).  Caches keep the
reference's stacked layout ``[n_layers, B, L, KV, hd]``, so a stored context
is the same array tree in both packages.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, layers
from repro_torch.models.attention import KVCache
from repro_torch.models.common import Params, resolve_device, resolve_dtype


class LMState(NamedTuple):
    """Decode context state: cached token counts and the slotted caches."""

    pos: torch.Tensor  # [B] int32 — tokens already in the caches
    caches: Tuple[blocks.BlockCache, ...]  # one entry (dense: one layer kind)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} archs are not ported yet (ROADMAP queue A item 12)"
        )


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init(cfg: ArchConfig, seed: int = 0, device=None) -> Params:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (the card unless the caller asks for the CPU)."""
    _check_dense(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "embed": layers.init_embedding(gen, cfg, device),
        "layers": [blocks.init_block(gen, cfg, device) for _ in range(cfg.n_layers)],
        "final_norm": layers.init_norm(cfg, device),
    }


def init_state(cfg: ArchConfig, batch: int, max_len: int, device=None,
               dtype=None) -> LMState:
    _check_dense(cfg)
    device = resolve_device(device)
    dtype = dtype or resolve_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = KVCache(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
    return LMState(
        pos=torch.zeros(batch, dtype=torch.int32, device=device),
        caches=(blocks.BlockCache(cache),),
    )


def _layer(cache: KVCache, i: int) -> KVCache:
    return KVCache(cache.k[i], cache.v[i])


# --------------------------------------------------------------------------- #
# Packed ragged prefill (many requests, one launch per layer)
# --------------------------------------------------------------------------- #
def prefill_packed(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # [1, Sq] new tokens of every segment, concatenated
    caches: Tuple[blocks.BlockCache, ...],  # packed buffers (paged.build_packed_caches)
    *,
    q_pos: torch.Tensor,  # [1, Sq] int32
    q_seg: torch.Tensor,  # [1, Sq] int32
    q_rows: torch.Tensor,  # [1, Sq] int64
    kv_pos: torch.Tensor,  # [1, Skv] int32
    kv_seg: torch.Tensor,  # [1, Skv] int32
    last_idx: torch.Tensor,  # [n] q index of each segment's last token
) -> Tuple[torch.Tensor, Tuple[blocks.BlockCache, ...]]:
    """Suffix-prefill of several requests as ONE packed sequence.  Returns
    the logits ``[n, V]`` at ``last_idx`` and the packed caches, with every
    new token's K/V written in."""
    _check_dense(cfg)
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    cache = caches[0].attn
    for i, lp in enumerate(params["layers"]):
        x = blocks.prefill_packed(
            lp, cfg, x, _layer(cache, i), q_pos=q_pos, q_seg=q_seg, q_rows=q_rows,
            kv_pos=kv_pos, kv_seg=kv_seg,
        )
    x = x[0, last_idx.long()]
    x = layers.apply_norm(params["final_norm"], cfg, x)
    return layers.lm_logits(params["embed"], cfg, x), caches


# --------------------------------------------------------------------------- #
# Decode (one token per sequence)
# --------------------------------------------------------------------------- #
def decode(
    params: Params, cfg: ArchConfig, tokens: torch.Tensor, state: LMState
) -> Tuple[torch.Tensor, LMState]:
    """One token for every slot; the caches are updated in place."""
    _check_dense(cfg)
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    cache = state.caches[0].attn
    for i, lp in enumerate(params["layers"]):
        x = blocks.decode(lp, cfg, x, _layer(cache, i), state.pos)
    x = layers.apply_norm(params["final_norm"], cfg, x)
    logits = layers.lm_logits(params["embed"], cfg, x)[:, 0]
    return logits, LMState(pos=state.pos + 1, caches=state.caches)
