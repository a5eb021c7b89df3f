"""Decoder-only LM over block kinds (attention or Mamba2 mixers, MLP or MoE
FFNs, one kind or a hybrid period of them): per-request, packed, fused and
chunked prefill, dense and paged decode.

API:
  init(cfg, seed=0, device=None) -> params
  forward(params, cfg, tokens [B, S], embeds=None) -> (logits [B, E + S, V], aux)
  cross_entropy(logits, labels, mask=None) -> loss
  init_state(cfg, batch, max_len, device=None) -> LMState
  prefill(params, cfg, tokens [B, S], state, embeds=None) -> (last logits [B, V], LMState)
  prefill_packed(params, cfg, tokens, caches, **layout) -> (logits [n, V], caches)
  prefill_fused(params, cfg, tokens, caches, q_pos=, q_rows=, kv_pos=, last_idx=)
      -> (logits [1, V], caches)
  decode(params, cfg, tokens [B, 1], state) -> (logits [B, V], LMState)
  decode_paged(params, cfg, tokens [B, 1], caches, block_table=, pos=, block=)
      -> (logits [B, V], caches)
  prefill_chunked(params, cfg, tokens [B, C], caches, block_table=, q_pos=,
      last_idx=, block=) -> (logits [B, V], caches)

``prefill`` is a suffix prefill whenever ``state.pos > 0``: positions
``[0, state.pos)`` of the caches are reused context state (the paper's
technique) and are not recomputed.

Layer weights are one dict per layer (the JAX package stacks them over
periods for ``lax.scan``; ``models.convert`` unstacks them).  Caches keep the
reference's stacked layout, one ``BlockCache`` per period position stacked
over the ``n_periods = n_layers / len(period)`` periods: ``[n_periods, B, L,
KV, hd]`` K/V for an attention position, the mamba state ``conv [n_periods,
B, d_conv-1, conv_dim]`` and ``ssd [n_periods, B, H, P, S]`` (f32) for a
Mamba position (``attn`` None there), so a stored context is the same array
tree in both packages.  Packed, fused, paged and chunked calls need attention-only
stacks (SSM state mixes along the sequence).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, layers
from repro_torch.models.attention import KVCache
from repro_torch.models.common import Params, resolve_device, resolve_dtype
from repro_torch.models.ssm import MambaState


class LMState(NamedTuple):
    """Decode context state: cached token counts and the slotted caches."""

    pos: torch.Tensor  # [B] int32 — tokens already in the caches
    caches: Tuple[blocks.BlockCache, ...]  # one per period position, stacked over periods


def _layout(cfg: ArchConfig):
    kinds = blocks.block_kinds(cfg)
    assert cfg.n_layers % len(kinds) == 0, (cfg.name, cfg.n_layers, len(kinds))
    return kinds, cfg.n_layers // len(kinds)


def _attention_only(cfg: ArchConfig, what: str):
    """The reference's assert of the packed, fused, paged and chunked calls."""
    kinds, _ = _layout(cfg)
    if any(k.mixer != "a" for k in kinds):
        raise ValueError(f"{what} requires attention-only stacks ({cfg.name})")
    return kinds


def _layers(params: Params, kinds):
    """(layer params, kind, period position, period index) of every layer."""
    for i, lp in enumerate(params["layers"]):
        j = i % len(kinds)
        yield lp, kinds[j], j, i // len(kinds)


def _layer(cache: KVCache, i: int) -> KVCache:
    return KVCache(cache.k[i], cache.v[i])


def _block_cache(c: blocks.BlockCache, i: int) -> blocks.BlockCache:
    """Layer ``i``'s views of a stacked ``BlockCache``."""
    if c.attn is not None:
        return blocks.BlockCache(_layer(c.attn, i))
    return blocks.BlockCache(None, MambaState(c.mamba.conv[i], c.mamba.ssd[i]))


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init(cfg: ArchConfig, seed: int = 0, device=None) -> Params:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (the card unless the caller asks for the CPU)."""
    kinds, _ = _layout(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "embed": layers.init_embedding(gen, cfg, device),
        "layers": [blocks.init_block(gen, cfg, kinds[i % len(kinds)], device)
                   for i in range(cfg.n_layers)],
        "final_norm": layers.init_norm(cfg, device),
    }


def init_state(cfg: ArchConfig, batch: int, max_len: int, device=None,
               dtype=None) -> LMState:
    kinds, n_periods = _layout(cfg)
    device = resolve_device(device)
    dtype = dtype or resolve_dtype(cfg.dtype)
    return LMState(
        pos=torch.zeros(batch, dtype=torch.int32, device=device),
        caches=tuple(blocks.init_block_cache(cfg, k, n_periods, batch, max_len, device, dtype)
                     for k in kinds),
    )


# --------------------------------------------------------------------------- #
# Training forward (no cache) and loss
# --------------------------------------------------------------------------- #
def forward(
    params: Params, cfg: ArchConfig, tokens: Optional[torch.Tensor] = None, embeds=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: every position attends causally over the
    call's tokens (``embeds [B, E, D]`` first where given); returns the f32
    logits ``[B, E + S, V]`` and the summed MoE aux loss (the reference's
    ``lm.forward``).  Layers run in order over ``params["layers"]``, one
    period at a time; with ``cfg.remat`` "dots" or "full" each period runs
    under ``torch.utils.checkpoint`` and is recomputed in the backward.
    The reference's "dots" keeps the matmul outputs and "full" keeps
    nothing; here both keep only the period's input.  The math is the same
    either way and only memory differs.  A Mamba layer's scan gets its
    gradient through ``ops.SSDChunkedFn``, an attention layer's through
    ``ops.FlashAttentionFn``; the encoder-decoder's training forward is
    ``encdec.forward``."""
    kinds, _ = _layout(cfg)
    x = _embed_inputs(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    def period_fn(x, *layer_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, kind in zip(layer_params, kinds):
            x, a = blocks.forward(lp, cfg, kind, x, positions=positions)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    period = len(kinds)
    for i in range(0, cfg.n_layers, period):
        layer_params = params["layers"][i:i + period]
        if cfg.remat == "none":
            x, a = period_fn(x, *layer_params)
        else:
            x, a = torch.utils.checkpoint.checkpoint(period_fn, x, *layer_params,
                                                     use_reentrant=False)
        aux = aux + a
    x = layers.apply_norm(params["final_norm"], cfg, x)
    return layers.lm_logits(params["embed"], cfg, x), aux


def cross_entropy(
    logits: torch.Tensor,  # [B, S, V] (upcast to f32 here)
    labels: torch.Tensor,  # [B, S] int
    mask: Optional[torch.Tensor] = None,  # [B, S] float or bool
) -> torch.Tensor:
    """Mean next-token negative log-likelihood in f32: log-sum-exp minus the
    label's logit, averaged over the positions ``mask`` keeps (all where
    none is given; the reference's ``lm.cross_entropy``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# --------------------------------------------------------------------------- #
# Prefill (full when state.pos == 0; suffix when state.pos > 0)
# --------------------------------------------------------------------------- #
def _embed_inputs(params: Params, cfg: ArchConfig, tokens: Optional[torch.Tensor],
                  embeds) -> torch.Tensor:
    """The token embeddings, after the precomputed ``embeds [B, E, D]`` (a
    VLM's image patches; a tensor or an array) cast to ``cfg.dtype`` where
    given (the reference's ``_embed_inputs``)."""
    parts = []
    if embeds is not None:
        device = params["embed"]["table"].device
        parts.append(torch.as_tensor(embeds, device=device).to(resolve_dtype(cfg.dtype)))
    if tokens is not None:
        parts.append(layers.embed_tokens(params["embed"], cfg, tokens))
    if not parts:
        raise ValueError("the model needs tokens, embeds or both")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def prefill(
    params: Params, cfg: ArchConfig, tokens: Optional[torch.Tensor], state: LMState,
    embeds=None,
) -> Tuple[torch.Tensor, LMState]:
    """Prefill ``tokens`` [B, S] after the ``state.pos`` tokens already in
    the caches (written in place), with ``embeds [B, E, D]`` before them
    where given (positions ``pos .. pos + E - 1``); returns the last
    position's logits [B, V] and the state with ``pos + E + S``."""
    kinds, _ = _layout(cfg)
    x = _embed_inputs(params, cfg, tokens, embeds)
    S = x.shape[1]
    for lp, kind, j, i in _layers(params, kinds):
        x = blocks.prefill(lp, cfg, kind, x, _block_cache(state.caches[j], i), state.pos)
    x = layers.apply_norm(params["final_norm"], cfg, x[:, -1:])
    logits = layers.lm_logits(params["embed"], cfg, x)[:, 0]
    return logits, LMState(pos=state.pos + S, caches=state.caches)


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
    kinds = _attention_only(cfg, "packed prefill")
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    for lp, kind, j, i in _layers(params, kinds):
        x = blocks.prefill_packed(
            lp, cfg, kind, x, _layer(caches[j].attn, i), q_pos=q_pos, q_seg=q_seg,
            q_rows=q_rows, kv_pos=kv_pos, kv_seg=kv_seg,
        )
    x = x[0, last_idx.long()]
    x = layers.apply_norm(params["final_norm"], cfg, x)
    return layers.lm_logits(params["embed"], cfg, x), caches


# --------------------------------------------------------------------------- #
# Fused selective-recompute prefill (non-prefix chunk reuse)
# --------------------------------------------------------------------------- #
def prefill_fused(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # [1, Sq] the recompute tokens, in position order
    caches: Tuple[blocks.BlockCache, ...],  # assembled buffers (fusion.build_fused_caches)
    *,
    q_pos: torch.Tensor,  # [1, Sq] int32 absolute positions (gappy; padding -2^30)
    q_rows: torch.Tensor,  # [1, Sq] int64 buffer row per token (padding -> scratch)
    kv_pos: torch.Tensor,  # [1, Skv] int32 row positions (-1 invalid)
    last_idx: torch.Tensor,  # [1] q index of the final (prompt) token
) -> Tuple[torch.Tensor, Tuple[blocks.BlockCache, ...]]:
    """Selective-recompute prefill over a chunk-composite KV assembly.

    The CacheBlend-style execute path: reused chunk spans sit preloaded in
    ``caches`` and only the selected r-fraction of tokens (plus every prompt
    token) flows through the layer stack, each attending the whole assembled
    buffer at its absolute position.  Everything outside attention is
    positionwise, so the gappy token subset is transparent to norms and MLP.
    Returns the last-token logits ``[1, V]`` and the caches, with every
    recompute token's K/V written in place: rows ``[0, total)`` are then the
    full context+prompt state.  At ``recompute_frac=1.0`` the token set is
    the whole sequence and the result is ``prefill``'s."""
    kinds = _attention_only(cfg, "fused prefill")
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    for lp, kind, j, i in _layers(params, kinds):
        x = blocks.prefill_fused(lp, cfg, kind, x, _layer(caches[j].attn, i), q_pos=q_pos,
                                 q_rows=q_rows, kv_pos=kv_pos)
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
    kinds, _ = _layout(cfg)
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    for lp, kind, j, i in _layers(params, kinds):
        x = blocks.decode(lp, cfg, kind, x, _block_cache(state.caches[j], i), state.pos)
    x = layers.apply_norm(params["final_norm"], cfg, x)
    logits = layers.lm_logits(params["embed"], cfg, x)[:, 0]
    return logits, LMState(pos=state.pos + 1, caches=state.caches)


# --------------------------------------------------------------------------- #
# Paged decode (one token per sequence over the shared KV block pool)
# --------------------------------------------------------------------------- #
def decode_paged(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # [B, 1]
    caches: Tuple[blocks.BlockCache, ...],  # the pool (paged.init_pool_caches)
    *,
    block_table: torch.Tensor,  # [B, nb] int32 pool block per sequence block
    pos: torch.Tensor,  # [B] int32 cached length per slot (freed slots: 0,
    # with zeroed tables routing their writes to the dump block)
    block: int = 128,
) -> Tuple[torch.Tensor, Tuple[blocks.BlockCache, ...]]:
    """``decode`` against the shared block pool instead of slotted caches;
    the pool is updated in place.  Positions and tables are the caller's
    (the serving engine's ``PagedSlots``), so only the pool flows through:
    returns (logits [B, V], caches)."""
    kinds = _attention_only(cfg, "paged decode")
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    for lp, kind, j, i in _layers(params, kinds):
        x = blocks.decode_paged(lp, cfg, kind, x, _layer(caches[j].attn, i), block_table, pos,
                                block=block)
    x = layers.apply_norm(params["final_norm"], cfg, x)
    logits = layers.lm_logits(params["embed"], cfg, x)[:, 0]
    return logits, caches


# --------------------------------------------------------------------------- #
# Chunked prefill (mixed prefill-chunk + decode rows over the block pool)
# --------------------------------------------------------------------------- #
def prefill_chunked(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # [B, C] up to C new tokens per slot (0 on padding)
    caches: Tuple[blocks.BlockCache, ...],  # the pool (paged.init_pool_caches)
    *,
    block_table: torch.Tensor,  # [B, nb] int32 pool block per sequence block
    q_pos: torch.Tensor,  # [B, C] int32 token positions (-2^30 = padding)
    last_idx: torch.Tensor,  # [B] chunk index of each row's last valid token
    block: int = 128,
) -> Tuple[torch.Tensor, Tuple[blocks.BlockCache, ...]]:
    """The unified continuous-batching step: one launch per layer over the
    shared block pool whose rows mix prefill chunks (up to ``C`` new tokens
    each), decode rows (one token at the live length) and idle rows (all
    padding).  Every valid token's K/V lands in the pool blocks its slot's
    table names (in place), then attends causally at its absolute position.
    Returns the logits ``[B, V]`` at ``last_idx`` (meaningful for rows that
    finish a prefill or carry a decode token) and the caches."""
    kinds = _attention_only(cfg, "chunked prefill")
    x = layers.embed_tokens(params["embed"], cfg, tokens)
    for lp, kind, j, i in _layers(params, kinds):
        x = blocks.prefill_chunked(lp, cfg, kind, x, _layer(caches[j].attn, i), block_table,
                                   q_pos, block=block)
    x = x[torch.arange(x.shape[0], device=x.device), last_idx.long()][:, None]
    x = layers.apply_norm(params["final_norm"], cfg, x)
    logits = layers.lm_logits(params["embed"], cfg, x)[:, 0]
    return logits, caches
