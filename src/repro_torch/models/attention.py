"""Grouped-query self-attention against the slotted KV cache or the shared
block pool, plain self-attention without a cache, and cross-attention.

Seven call modes share one weight set:
  * ``forward`` — attention over the call's own tokens, causal or not, with
    no cache (the Whisper encoder's self-attention).
  * ``prefill`` — ``S`` new tokens per sequence written at ``offset`` into
    the slotted cache, attending causally over ``[0, offset+S)``; with
    ``offset > 0`` this is the paper's suffix prefill over reused context.
  * ``prefill_packed`` — several requests' new tokens packed into one
    sequence; their K/V land in a packed buffer holding each request's
    reused context KV, and attention isolates the segments.
  * ``decode`` — one token per sequence against the slotted cache.
  * ``decode_paged`` — one token per sequence against the shared block
    pool, through each sequence's block table.
  * ``prefill_chunked`` — up to ``C`` tokens per sequence against the
    shared block pool: the unified step's mix of decode, prefill-chunk and
    idle rows.
  * ``prefill_fused`` — the recompute tokens of a fused (CacheBlend-style)
    reuse admission, at gappy positions, against one assembled buffer whose
    reused spans were preloaded from storage.

Cross-attention (the Whisper decoder's) computes its K/V once from the
encoder's output (``cross_kv``) and attends them non-causally
(``cross_attend``): the K/V of one audio context are the reusable state.

Cache layout: k/v ``[B, L_cache, KV_heads, head_dim]`` (the pool: ``[N_rows,
KV_heads, head_dim]``).  Unlike the JAX package, which returns new cache
arrays, every mode writes the new rows into the cache tensors in place: the
dense cache of a full-width model is gigabytes, and a copy per layer per
step would double it.

With ``kv_group`` (a process group over the mesh's ``model`` axis)
``prefill`` and ``decode`` run KV-length-sharded, the reference's route
under ``REPRO_ATTN_KV_SHARD=1``: each rank holds rows ``[r L/m, (r+1) L/m)``
of every cache (``sharding.state_specs(kv_shard=True)``; ``shard_rows``
cuts them), writes only the new rows it owns, and attends over its own rows
through ``ops.flash_attention`` / ``ops.decode_attention(kv_group=...)``,
whose merge gives every rank the attention over all ``L`` rows.  The
activations stay whole on every rank.  Where the attended rows do not
divide over the group (a ring prefill's ``[ring ++ new]``), the ring's
shards are gathered and attention runs unsharded, as the reference's
``_mesh_axes_for_kv_shard`` returns None there.

Sliding-window archs keep ``L_cache = min(max_len, window)`` rows.  When
``L_cache == window`` the slotted cache is a ring: position ``p`` lives in
row ``p % window`` and ``_ring_positions`` says which position each row
holds, so ``prefill`` and ``decode`` attend by those positions (the
reference's ring branch).  The packed and fused buffers stay linear, as in
the reference: the engine packs only when ``window >= max_len``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
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


def _ring_positions(length: torch.Tensor, window: int, batch: int) -> torch.Tensor:
    """Absolute position held by each ring row once ``length [B]`` tokens
    were seen: row ``j`` holds the largest ``p < length`` with ``p % window
    == j``, or -1 if no token ever landed there.  Returns ``[batch, window]``
    int32 (the reference's ``_ring_positions``)."""
    j = torch.arange(window, dtype=torch.int32, device=length.device)[None]  # [1, W]
    ln = length.to(torch.int32).reshape(batch, 1)  # [B, 1]
    p = ln - 1 - torch.remainder(ln - 1 - j, window)
    return torch.where((p >= 0) & (ln > 0), p, -1).to(torch.int32)


def _ring(cfg: ArchConfig, L: int) -> bool:
    """Whether a slotted cache of ``L`` rows is a ring (the reference's
    condition: a window exactly as long as the cache)."""
    return bool(cfg.sliding_window) and L == cfg.sliding_window


def _ring_write(cache: torch.Tensor, positions: torch.Tensor, new: torch.Tensor) -> None:
    """Write the new rows ``new [B, S, ...]`` at ``positions [B, S]`` into the
    ring ``cache [B, W, ...]`` in place, keeping each ring row's last
    occurrence only.  The reference scatters every row and sends the
    earlier occurrences to a dropped scratch row (``_scatter_rows_padded``);
    those are the first ``S - W`` tokens of every sequence, so writing the
    last ``min(S, W)`` tokens keeps the same rows and hands the scatter
    ``min(S, W)`` distinct ring rows per sequence, never a duplicate index
    (on CUDA a duplicate would keep an arbitrary one of its writes)."""
    B, S = positions.shape
    W = cache.shape[1]
    n = min(S, W)
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, (positions[:, S - n:] % W).long()] = new[:, S - n:]


# --------------------------------------------------------------------------- #
# The KV-length-sharded layout
# --------------------------------------------------------------------------- #
def shard_rows(t: torch.Tensor, group: Any, dim: int = 1) -> torch.Tensor:
    """This rank's rows of a cache ``t`` along ``dim`` (the length) under
    the KV-length-sharded layout: the ``r``-th of ``m`` equal parts for
    rank ``r`` of ``group``, a view.  The length must divide."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    n = t.shape[dim]
    if n % m:
        raise ValueError(f"shard_rows: {n} rows do not divide over {m} ranks")
    return t.narrow(dim, r * (n // m), n // m)


def _shard_origin(cache: torch.Tensor, group: Any):
    """(m ranks, this rank r, its n local rows): it holds global rows
    ``[r n, (r+1) n)`` of ``m n``; with no group, one rank holds them all."""
    if group is None:
        return 1, 0, cache.shape[1]
    return dist.get_world_size(group), dist.get_rank(group), cache.shape[1]


def _gather_rows(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Every rank's rows of ``t [B, n, ...]`` in rank order (an
    all-gather)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _land_rows(cache: torch.Tensor, src: torch.Tensor, new: torch.Tensor,
               valid: torch.Tensor) -> None:
    """Row ``i`` of ``cache [B, n, ...]`` takes ``new[b, src[b, i]]`` where
    ``valid[b, i]``, in place: every local row written once, so no two
    writes meet in one row (a scatter of the rows another rank owns would
    need a row to drop them in)."""
    S = new.shape[1]
    idx = src.clamp(0, S - 1).long()
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache.copy_(torch.where(valid[..., None, None], new[rows, idx], cache))


def _prefill_sharded(p, cfg, q, k_new, v_new, cache, offset, positions, group):
    """``prefill``'s attention and cache writes on this rank's rows."""
    B, S = positions.shape
    m, r, n = _shard_origin(cache.k, group)
    L, first = n * m, r * n
    g = first + torch.arange(n, dtype=torch.int32, device=q.device)[None]  # [1, n] global rows
    if _ring(cfg, L):
        end = offset + S  # [B, 1]
        # the position each local ring row holds after the call: the last new
        # token landing there, if any
        last = end - 1 - torch.remainder(end - 1 - g, L)
        old_pos = _ring_positions(offset[:, 0], L, B)[:, first:first + n]
        if S % m == 0:  # (L + S) rows divide: each rank attends its ring rows ++ S / m new
            c = S // m
            j = slice(r * c, (r + 1) * c)
            o = ops.flash_attention(
                q.contiguous(), torch.cat([cache.k, k_new[:, j]], dim=1),
                torch.cat([cache.v, v_new[:, j]], dim=1), q_pos=positions.contiguous(),
                kv_pos=torch.cat([old_pos, positions[:, j]], dim=1).contiguous(),
                causal=True, window=cfg.sliding_window, kv_group=group)
        else:  # the reference's unsharded route: the whole ring on every rank
            k_ring, v_ring = (_gather_rows(t, group) for t in (cache.k, cache.v))
            o = ops.flash_attention(
                q.contiguous(), torch.cat([k_ring, k_new], dim=1),
                torch.cat([v_ring, v_new], dim=1), q_pos=positions.contiguous(),
                kv_pos=torch.cat([_ring_positions(offset[:, 0], L, B), positions],
                                 dim=1).contiguous(),
                causal=True, window=cfg.sliding_window)
        src = last - offset
        _land_rows(cache.k, src, k_new, src >= 0)
        _land_rows(cache.v, src, v_new, src >= 0)
        return _out(p, o)
    src = g - offset  # [B, n]: the new token landing on each local row
    valid = (src >= 0) & (src < S)
    _land_rows(cache.k, src, k_new, valid)
    _land_rows(cache.v, src, v_new, valid)
    kv_pos = torch.where(g < offset + S, g, -1).to(torch.int32)
    o = ops.flash_attention(
        q.contiguous(), cache.k, cache.v, q_pos=positions, kv_pos=kv_pos.contiguous(),
        causal=True, window=cfg.sliding_window, kv_group=group)
    return _out(p, o)


# --------------------------------------------------------------------------- #
# Forward over the call's own tokens (no cache)
# --------------------------------------------------------------------------- #
def _kv_heads_of(t: torch.Tensor, first: int, n_q: int, G: int) -> torch.Tensor:
    """The kv heads of ``t [B, S, KV, hd]`` that query heads ``first ..
    first + n_q - 1`` read (``G`` query heads a kv head): a contiguous run
    where each of its heads serves an equal run of those queries, else one
    kv head per query head."""
    lo, hi = first // G, (first + n_q - 1) // G + 1
    per = n_q // (hi - lo)
    if per * (hi - lo) == n_q and all((first + i) // G - lo == i // per for i in range(n_q)):
        return t[:, :, lo:hi]
    idx = torch.tensor([(first + i) // G for i in range(n_q)], device=t.device)
    return t.index_select(2, idx)


def _split(shape: Any, heads: int, hd: int, group: Any) -> str:
    """How ``param_specs`` laid out this rank's shard of an attention
    weight whose (heads, head_dim) dims have local sizes ``shape``: over its
    ``"heads"``, its ``"head_dim"``, or ``"whole"`` (replicated)."""
    if tp.shard_count(shape[0], heads, group) > 1:
        return "heads"
    return "head_dim" if tp.shard_count(shape[1], hd, group) > 1 else "whole"


def _forward_tp(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                causal: bool, group: Any) -> torch.Tensor:
    """``forward``'s body on this rank's shards of the weights, as
    ``param_specs`` lays them out (read from the local shapes; with no
    group, or one rank, every weight is whole and no operator issues
    anything):

    * (a) query and kv heads split: each rank projects its heads (through
      ``copy_to_model``), attends them and multiplies its rows of ``wo``;
    * (b) query heads split, the kv heads' head_dim split (or whole): ``k``
      and ``v`` are gathered whole and each rank takes the kv heads its
      query heads read (``copy_to_model`` first: the ranks' reads of one kv
      head sum in the backward);
    * (c) every head_dim split (or whole): ``q``, ``k`` and ``v`` gathered,
      attention on every head on every rank, the output's head_dim slice
      (``split_last_dim``) meets ``wo``'s rows.

    RoPE runs after any gather (it pairs elements across head_dim); the
    partial sums of ``wo`` meet in ``reduce_from_model``."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    xc = tp.copy_to_model(x, group)  # one all-reduce of the projections' input gradients
    proj = {}
    for name, bias, n in (("wq", "bq", H), ("wk", "bk", KV), ("wv", "bv", KV)):
        w = p[name]
        how = _split(w.shape[1:], n, hd, group)
        y = (x if how == "whole" else xc) @ w.to(x.dtype).reshape(x.shape[-1], -1)
        y = y.view(*x.shape[:2], w.shape[1], -1)
        if cfg.qkv_bias:
            y = y + p[bias].to(x.dtype)
        proj[name] = (tp.gather_last_dim(y, group) if how == "head_dim" else y, how)
    (q, q_how), (k, k_how), (v, _) = proj["wq"], proj["wk"], proj["wv"]
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if q_how == "heads" and k_how != "heads":  # (b)
        first = tp.group_rank(group) * q.shape[2]
        k, v = (_kv_heads_of(tp.copy_to_model(t, group), first, q.shape[2], H // KV)
                for t in (k, v))
    o = ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), q_pos=positions, kv_pos=positions,
        causal=causal, window=cfg.sliding_window,
    )
    if q_how == "heads":  # (a), (b): this rank's heads meet their rows of wo
        return tp.reduce_from_model(_out(p, o), group)
    if _split(p["wo"].shape[:2], H, hd, group) == "head_dim":  # (c)
        return tp.reduce_from_model(_out(p, tp.split_last_dim(o, group)), group)
    return _out(p, o)  # every attention weight whole


def forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, S, D]
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,  # [B, S] int32; 0 .. S-1 if not given
    model_group: Any = None,
) -> torch.Tensor:
    """Every token attends the call's tokens at ``positions`` (causally, or
    all of them), through ``ops.flash_attention``; with ``model_group``, on
    this rank's shards of the weights (``_forward_tp``)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    positions = positions.to(torch.int32).contiguous()
    return _forward_tp(p, cfg, x, positions, causal, model_group)


# --------------------------------------------------------------------------- #
# Prefill (full or suffix) against the slotted cache
# --------------------------------------------------------------------------- #
def prefill(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, S, D] — the new (non-reused) tokens
    cache: KVCache,  # [B, L, KV, hd], written in place (this rank's rows with kv_group)
    offset: torch.Tensor,  # [B] int32 — tokens already in the cache
    kv_group: Any = None,
) -> torch.Tensor:
    """Write the new tokens' K/V at rows ``[offset, offset+S)`` and attend
    every row below ``offset+S`` causally at absolute positions (with
    ``kv_group``, KV-length-sharded: see the module docstring).

    On a ring (``_ring``) a query early in the call needs rows that later
    tokens of the same call overwrite, so attention runs over ``[the ring
    as it was ++ the new K/V]`` at ``[_ring_positions(offset) ++
    positions]`` with the window, and only then does each ring row take the
    last new token that maps to it (the reference's ring branch)."""
    B, S, _ = x.shape
    L = cache.k.shape[1]
    q, k_new, v_new = _qkv(p, cfg, x)
    offset = offset.to(torch.int32)[:, None]  # [B, 1]
    positions = offset + torch.arange(S, dtype=torch.int32, device=x.device)[None]  # [B, S]
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    if kv_group is not None:
        return _prefill_sharded(p, cfg, q, k_new, v_new, cache, offset, positions, kv_group)
    if _ring(cfg, L):
        # the concatenations copy the ring before any of its rows is written
        k_all = torch.cat([cache.k, k_new], dim=1)
        v_all = torch.cat([cache.v, v_new], dim=1)
        kv_pos = torch.cat([_ring_positions(offset[:, 0], L, B), positions], dim=1)
        o = ops.flash_attention(
            q.contiguous(), k_all, v_all, q_pos=positions.contiguous(),
            kv_pos=kv_pos.contiguous(), causal=True, window=cfg.sliding_window,
        )
        _ring_write(cache.k, positions, k_new)
        _ring_write(cache.v, positions, v_new)
        return _out(p, o)
    rows = torch.arange(B, device=x.device)[:, None]
    cache.k[rows, positions.long()] = k_new
    cache.v[rows, positions.long()] = v_new
    idx = torch.arange(L, dtype=torch.int32, device=x.device)[None]
    kv_pos = torch.where(idx < offset + S, idx, -1).to(torch.int32)  # [B, L]
    o = ops.flash_attention(
        q.contiguous(), cache.k, cache.v, q_pos=positions, kv_pos=kv_pos, causal=True,
        window=cfg.sliding_window,
    )
    return _out(p, o)


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
# Fused selective-recompute prefill (CacheBlend-style non-prefix reuse)
# --------------------------------------------------------------------------- #
def prefill_fused(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [1, Sq, D] — ONLY the tokens chosen for recompute
    cache: KVCache,  # [1, Skv + 1, KV, hd]: assembled buffer + one scratch row
    *,
    q_pos: torch.Tensor,  # [1, Sq] int32 absolute positions (gappy; -2^30 padding)
    q_rows: torch.Tensor,  # [1, Sq] int64 buffer row of each token's KV (Skv = scratch)
    kv_pos: torch.Tensor,  # [1, Skv] int32 row positions (-1 invalid)
) -> torch.Tensor:
    """Selective-recompute prefill of one request over an assembled buffer.

    ``cache`` holds the context KV in query order, with reused chunk spans
    preloaded from storage (``kvcache.fusion.build_fused_caches``) and zeros
    at the recompute rows.  The recompute tokens (a gappy subset of
    positions, not a suffix) get fresh K/V written at ``q_rows``; padding
    tokens carry row ``Skv``, the scratch row past the buffer, which
    attention never reads (the reference's ``_scatter_rows_padded``).  Then
    they attend causally over the whole buffer at their absolute positions
    (``ops.fused_prefill``).  At r=1.0 every row is overwritten and this is
    ``prefill`` of the whole sequence."""
    Skv = kv_pos.shape[1]
    q, k_new, v_new = _qkv(p, cfg, x)
    if cfg.rope_theta is not None:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k_new = apply_rope(k_new, q_pos, cfg.rope_theta)
    cache.k[0].index_copy_(0, q_rows[0], k_new[0])
    cache.v[0].index_copy_(0, q_rows[0], v_new[0])
    o = ops.fused_prefill(
        q.contiguous(), cache.k[:, :Skv], cache.v[:, :Skv], q_pos=q_pos, kv_pos=kv_pos,
        window=cfg.sliding_window,
    )
    return _out(p, o)


# --------------------------------------------------------------------------- #
# Decode (one token)
# --------------------------------------------------------------------------- #
def decode(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, 1, D]
    cache: KVCache,  # [B, L, KV, hd], written in place (this rank's rows with kv_group)
    pos: torch.Tensor,  # [B] int32 — position of this token (== cached length)
    kv_group: Any = None,
) -> torch.Tensor:
    """One token per sequence: its K/V row lands at row ``pos`` (on a ring,
    ``pos % window``), then it attends every row the cache holds at or
    below ``pos``, by position (on a ring, ``_ring_positions(pos + 1)``);
    with ``kv_group``, KV-length-sharded (see the module docstring): the
    rank that owns the new row writes it, and every other rank rewrites
    that sequence's row with its own values."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x)
    positions = pos[:, None].to(torch.int32).contiguous()  # [B, 1]
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    m, r, n = _shard_origin(cache.k, kv_group)
    L, first = n * m, r * n
    ring = _ring(cfg, L)
    local = (pos % L if ring else pos).to(torch.int32) - first
    owned = ((local >= 0) & (local < n))[:, None, None]
    rows = torch.arange(B, device=x.device)
    idx = local.clamp(0, n - 1).long()
    for c, new in ((cache.k, k_new), (cache.v, v_new)):
        c[rows, idx] = torch.where(owned, new[:, 0], c[rows, idx])
    if ring:
        kv_pos = _ring_positions(pos + 1, L, B)[:, first:first + n]
    else:
        g = first + torch.arange(n, dtype=torch.int32, device=x.device)[None]
        kv_pos = torch.where(g <= positions, g, -1).to(torch.int32)
    o = ops.decode_attention(
        q.contiguous(), cache.k, cache.v, q_pos=positions, kv_pos=kv_pos.contiguous(),
        window=cfg.sliding_window, kv_group=kv_group,
    )
    return _out(p, o)


# --------------------------------------------------------------------------- #
# Paged decode (one token per sequence against the shared block pool)
# --------------------------------------------------------------------------- #
def decode_paged(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, 1, D]
    pool: KVCache,  # k/v [N_rows, KV, hd]: the shared block pool, written in place
    block_table: torch.Tensor,  # [B, nb] int32 pool block per sequence block
    pos: torch.Tensor,  # [B] int32 — position of this token (== cached length)
    *,
    block: int,
) -> torch.Tensor:
    """``decode`` over the paged layout: the new token's K/V row lands in
    the pool at ``table[pos // block] * block + pos % block`` and attention
    reads each sequence's live blocks through its table.  A slot whose table
    is zeroed (freed or inactive) writes onto the dump block's rows, never
    into a block that may belong to another sequence."""
    q, k_new, v_new = _qkv(p, cfg, x)
    positions = pos[:, None].to(torch.int32).contiguous()  # [B, 1]
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    table = block_table.to(torch.int32).contiguous()
    pos64 = pos.long()
    blk = table.long().gather(1, (pos64 // block)[:, None])[:, 0]
    rows = blk * block + pos64 % block  # [B]: dump rows where blk == 0
    pool.k.index_copy_(0, rows, k_new[:, 0])
    pool.v.index_copy_(0, rows, v_new[:, 0])
    o = ops.paged_decode(
        q.contiguous(), pool.k, pool.v, block_table=table, q_pos=positions,
        block=block, window=cfg.sliding_window,
    )
    return _out(p, o)


# --------------------------------------------------------------------------- #
# Chunked prefill (mixed prefill-chunk + decode rows over the block pool)
# --------------------------------------------------------------------------- #
def prefill_chunked(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, C, D] up to C new tokens per sequence
    pool: KVCache,  # k/v [N_rows, KV, hd]: the shared block pool, written in place
    block_table: torch.Tensor,  # [B, nb] int32 pool block per sequence block
    q_pos: torch.Tensor,  # [B, C] int32 token positions (-2^30 = padding)
    *,
    block: int,
) -> torch.Tensor:
    """``decode_paged`` generalised to a chunk of up to ``C`` tokens per
    sequence: every valid token's K/V row lands in the pool at
    ``table[pos // block] * block + pos % block``, then each query attends
    causally at its absolute position.  Padding tokens get rope position 0
    and write onto row 0 of the dump block, which no valid query attends
    (its positions lie past every query's).  Several padding tokens share
    that row, so on CUDA ``index_copy_`` leaves any one of them there: only
    garbage lands on it either way."""
    B, C, _ = x.shape
    q, k_new, v_new = _qkv(p, cfg, x)
    q_pos = q_pos.to(torch.int32)
    valid = q_pos >= 0
    positions = torch.where(valid, q_pos, 0)
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    table = block_table.to(torch.int32).contiguous()
    pos64 = positions.long()
    blk = table.long().gather(1, pos64 // block)  # [B, C]
    rows = torch.where(valid, blk * block + pos64 % block, 0).reshape(B * C)
    KVh, hd = pool.k.shape[1], pool.k.shape[2]
    pool.k.index_copy_(0, rows, k_new.reshape(B * C, KVh, hd))
    pool.v.index_copy_(0, rows, v_new.reshape(B * C, KVh, hd))
    o = ops.chunked_prefill(
        q.contiguous(), pool.k, pool.v, block_table=table, q_pos=q_pos.contiguous(),
        block=block, window=cfg.sliding_window,
    )
    return _out(p, o)


# --------------------------------------------------------------------------- #
# Cross-attention (Whisper decoder): K/V computed once from the encoder output
# --------------------------------------------------------------------------- #
def init_cross_attention(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    return init_attention(gen, cfg, device)


def cross_kv(p: Params, cfg: ArchConfig, enc_out: torch.Tensor) -> KVCache:
    """The cross-attention K/V ``[B, S_enc, KV, hd]`` of the encoder output
    ``[B, S_enc, D]``."""
    dt = enc_out.dtype
    B, S, D = enc_out.shape
    k = (enc_out @ p["wk"].to(dt).reshape(D, -1)).view(B, S, cfg.n_kv_heads, -1)
    v = (enc_out @ p["wv"].to(dt).reshape(D, -1)).view(B, S, cfg.n_kv_heads, -1)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return KVCache(k, v)


def cross_attend(p: Params, cfg: ArchConfig, x: torch.Tensor, ckv: KVCache) -> torch.Tensor:
    """The decoder tokens ``x [B, S, D]`` attend every row of the cross K/V,
    non-causally (queries at position 0, rows at 0 .. S_enc-1, as the
    reference places them), through ``ops.flash_attention``: at a decode
    step that is one query row per sequence.  ``ops.decode_attention``
    would keep only the rows at or below the query's position, here row 0
    alone."""
    B, S, D = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt).reshape(D, -1)).view(B, S, cfg.n_heads, -1)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    Skv = ckv.k.shape[1]
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=x.device)[None].expand(B, Skv)
    o = ops.flash_attention(q.contiguous(), ckv.k, ckv.v, q_pos=q_pos,
                            kv_pos=kv_pos.contiguous(), causal=False)
    return _out(p, o)
