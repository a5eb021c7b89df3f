"""Grouped-query self-attention against a slotted dense KV cache.

Two call modes of the serving path share one weight set:
  * ``prefill_packed`` — several requests' new tokens packed into one
    sequence; their K/V land in a packed buffer holding each request's
    reused context KV, and attention isolates the segments.
  * ``decode`` — one token per sequence against the slotted cache.

Cache layout: k/v ``[B, L_cache, KV_heads, head_dim]``.  Unlike the JAX
package, which returns new cache arrays, both modes write the new rows into
the cache tensors in place: the dense cache of a full-width model is
gigabytes, and a copy per layer per step would double it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import Params
from repro_torch.models.layers import apply_rope


class KVCache(NamedTuple):
    """Slotted KV cache: ``[n_layers, B, L_cache, KV, hd]`` in a model state,
    ``[B, L_cache, KV, hd]`` per layer."""

    k: torch.Tensor
    v: torch.Tensor


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def init_attention(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    pdtype = common.resolve_dtype(cfg.param_dtype)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p: Params = {
        "wq": common.dense_init(gen, (D, H, hd), pdtype, device, fan_in=D),
        "wk": common.dense_init(gen, (D, KV, hd), pdtype, device, fan_in=D),
        "wv": common.dense_init(gen, (D, KV, hd), pdtype, device, fan_in=D),
        "wo": common.dense_init(gen, (H, hd, D), pdtype, device, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=pdtype, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=pdtype, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=pdtype, device=device)
    return p


def _qkv(p: Params, cfg: ArchConfig, x: torch.Tensor):
    dt = x.dtype
    B, S, D = x.shape
    q = (x @ p["wq"].to(dt).reshape(D, -1)).view(B, S, cfg.n_heads, -1)
    k = (x @ p["wk"].to(dt).reshape(D, -1)).view(B, S, cfg.n_kv_heads, -1)
    v = (x @ p["wv"].to(dt).reshape(D, -1)).view(B, S, cfg.n_kv_heads, -1)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _out(p: Params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    wo = p["wo"].to(o.dtype)
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _no_ring(cfg: ArchConfig, L: int) -> None:
    if cfg.sliding_window and L >= cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window ring caches are not ported yet (ROADMAP queue A item 12)"
        )


# --------------------------------------------------------------------------- #
# Packed ragged (suffix-)prefill: many requests, one kernel launch
# --------------------------------------------------------------------------- #
def prefill_packed(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [1, Sq, D] — new tokens of ALL segments, concatenated
    cache: KVCache,  # [1, Skv + 1, KV, hd]: packed buffer + one scratch row
    *,
    q_pos: torch.Tensor,  # [1, Sq] int32 segment-local positions
    q_seg: torch.Tensor,  # [1, Sq] int32 segment id (-1 = padding)
    q_rows: torch.Tensor,  # [1, Sq] int64 buffer row of each token's KV (Skv = scratch)
    kv_pos: torch.Tensor,  # [1, Skv] int32 segment-local position (-1 invalid)
    kv_seg: torch.Tensor,  # [1, Skv] int32 segment id per kv row
) -> torch.Tensor:
    """Suffix-prefill of several requests in one attention call.

    Each segment owns a row span of the packed buffer holding [its reused
    context KV ++ its new KV] (``kvcache.paged.pack_layout``).  New-token
    K/V land at ``q_rows``; padding tokens carry row ``Skv``, the scratch
    row past the buffer, which attention never reads.  Every query then
    attends its own segment only, causally at segment-local positions.
    """
    Skv = kv_pos.shape[1]
    _no_ring(cfg, Skv)
    q, k_new, v_new = _qkv(p, cfg, x)
    if cfg.rope_theta is not None:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k_new = apply_rope(k_new, q_pos, cfg.rope_theta)
    cache.k[0].index_copy_(0, q_rows[0], k_new[0])
    cache.v[0].index_copy_(0, q_rows[0], v_new[0])
    o = ops.packed_attention(
        q, cache.k[:, :Skv], cache.v[:, :Skv], q_pos=q_pos, kv_pos=kv_pos,
        q_seg=q_seg, kv_seg=kv_seg, causal=True, window=cfg.sliding_window,
    )
    return _out(p, o)


# --------------------------------------------------------------------------- #
# Decode (one token)
# --------------------------------------------------------------------------- #
def decode(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, 1, D]
    cache: KVCache,  # [B, L, KV, hd], written in place
    pos: torch.Tensor,  # [B] int32 — position of this token (== cached length)
) -> torch.Tensor:
    B = x.shape[0]
    L = cache.k.shape[1]
    _no_ring(cfg, L)
    q, k_new, v_new = _qkv(p, cfg, x)
    positions = pos[:, None].to(torch.int32).contiguous()  # [B, 1]
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    cache.k[rows, pos.long()] = k_new[:, 0]
    cache.v[rows, pos.long()] = v_new[:, 0]
    idx = torch.arange(L, dtype=torch.int32, device=x.device)[None]
    kv_pos = torch.where(idx <= positions, idx, -1).to(torch.int32)
    o = ops.decode_attention(
        q.contiguous(), cache.k, cache.v, q_pos=positions, kv_pos=kv_pos,
        window=cfg.sliding_window,
    )
    return _out(p, o)
