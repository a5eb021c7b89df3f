"""Plain PyTorch versions of the kernels on the port's path.

These are the semantics contract, the counterparts of the reference's
``kernels/ref.py``: every hand-written kernel of this package must agree
with the function here (``chip_smoke.py`` holds each against it on the
card), and on the CPU the kernel wrappers' callers run these functions.

Shared conventions: a finite ``NEG_INF`` (no NaN from ``-inf - -inf``), f32
accumulation, ``1/sqrt(hd)`` scaling, the ``1e-30`` clamp on the softmax
denominator, zeros for a query that every key masks, and ``kv_pos < 0``
marking an invalid kv row.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _masked_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, Sq, Skv] bool
) -> torch.Tensor:
    return _masked_attention_lse(q, k, v, mask)[0]


def _masked_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    with_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``_masked_attention``'s output and, with ``with_lse``, each row's
    log-sum-exp of the scaled scores ``[B, KV, G, Sq]`` f32 (-inf where
    every key is masked), from the one score product."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    m = mask[:, None, None]  # [B, 1, 1, Sq, Skv]
    lse = torch.logsumexp(scores.masked_fill(~m, -math.inf), dim=-1) if with_lse else None
    scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    scores = scores - scores.amax(dim=-1, keepdim=True)
    w = torch.where(m, torch.exp(scores), torch.zeros_like(scores))
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype), lse


def _position_mask(
    q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: Optional[int]
) -> torch.Tensor:
    qp = q_pos.long()[:, :, None]  # [B, Sq, 1]
    sp = kv_pos.long()[:, None, :]  # [B, 1, Skv]
    mask = sp >= 0
    if causal:
        mask = mask & (sp <= qp)
    if window is not None:
        mask = mask & (sp > qp - window)
    return mask


def attention_ref(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # [B, Sq] absolute positions of the query tokens
    kv_pos: torch.Tensor,  # [B, Skv] absolute positions of the kv rows
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,  # [B, Skv] bool
) -> torch.Tensor:
    """Grouped-query attention with position-based masking: key position s
    is kept for query position p iff ``s >= 0``, ``s <= p`` (causal),
    ``s > p - window`` (window) and ``kv_valid[s]``."""
    mask = _position_mask(q_pos, kv_pos, causal, window)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, :]
    return _masked_attention(q, k, v, mask)


# The plain path's peak-memory guard (the reference's ``ops.py``
# ``CHUNKED_THRESHOLD``): attention of ``Sq * Skv`` at or above it runs in
# query chunks, so no ``Sq x Skv`` score tensor is ever held whole, as the
# kernels hold none.
CHUNKED_THRESHOLD = 2048 * 8192
Q_CHUNK = 512


def q_chunks(sq: int, skv: int):
    """The query slices the plain path runs ``Sq x Skv`` attention in: one
    slice below ``CHUNKED_THRESHOLD``, slices of ``Q_CHUNK`` rows (the last
    one shorter) at or above it."""
    if sq * skv < CHUNKED_THRESHOLD:
        return [slice(0, sq)]
    return [slice(i, min(i + Q_CHUNK, sq)) for i in range(0, sq, Q_CHUNK)]


def attention_ref_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """``attention_ref`` over ``q_chunk`` (default ``Q_CHUNK``) queries at a
    time: the same values, with ``O(q_chunk * Skv)`` scores held at once.
    The counterpart of the reference's ``attention_ref_chunked`` (which pads
    the last chunk where this one runs it short), held against it by the
    tests; the plain path itself slices by ``q_chunks``."""
    q_chunk = q_chunk or Q_CHUNK
    kw = dict(kv_pos=kv_pos, causal=causal, window=window, kv_valid=kv_valid)
    outs = [attention_ref(q[:, i:i + q_chunk], k, v, q_pos=q_pos[:, i:i + q_chunk], **kw)
            for i in range(0, q.shape[1], q_chunk)]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, causal: bool = True, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The flash kernel's plain path: ``attention_ref`` over each query
    slice of ``q_chunks`` (one slice below ``CHUNKED_THRESHOLD``: the
    reference's ``ops.flash_attention`` choice, on every device), as the
    plain forward and backward of ``flash_backward`` slice them."""
    kw = dict(kv_pos=kv_pos, causal=causal, window=window, kv_valid=kv_valid)
    outs = [attention_ref(q[:, c], k, v, q_pos=q_pos[:, c], **kw)
            for c in q_chunks(q.shape[1], k.shape[1])]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def packed_attention_ref(
    q: torch.Tensor,  # [B, Sq, H, hd] — token runs of several requests, packed
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # [B, Sq] segment-local positions
    kv_pos: torch.Tensor,  # [B, Skv] segment-local positions (-1 = invalid)
    q_seg: torch.Tensor,  # [B, Sq] segment id per query token
    kv_seg: torch.Tensor,  # [B, Skv] segment id per kv row
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``attention_ref`` over a packed ragged batch, plus segment isolation:
    a query attends only kv rows of its own segment (``q_seg == kv_seg``)."""
    mask = _position_mask(q_pos, kv_pos, causal, window)
    mask = mask & (q_seg.long()[:, :, None] == kv_seg.long()[:, None, :])
    return _masked_attention(q, k, v, mask)


def fused_prefill_ref(
    q: torch.Tensor,  # [B, Sq, H, hd] the selectively recomputed tokens only
    k: torch.Tensor,  # [B, Skv, KV, hd] the assembled context buffer
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # [B, Sq] absolute (gappy, ascending) positions; -2^30 padding
    kv_pos: torch.Tensor,  # [B, Skv] row positions (-1 = invalid row)
    window: Optional[int] = None,
) -> torch.Tensor:
    """Selective-recompute (CacheBlend-style) fused prefill attention.

    ``k``/``v`` hold one query-ordered buffer assembled from reused chunk
    spans plus the recompute tokens' fresh K/V (scattered in by the caller
    at their ``q_pos`` rows).  The queries are only the recompute tokens, a
    gappy subset of positions, and each attends causally over the whole
    buffer at its absolute position: key position ``s`` is kept for query
    position ``p`` iff ``s >= 0``, ``s <= p`` (and ``s > p - window``).  With
    every position recomputed this is ``attention_ref`` of a full prefill."""
    return _masked_attention(q, k, v, _position_mask(q_pos, kv_pos, True, window))


def paged_decode_ref(
    q: torch.Tensor,  # [B, 1, H, hd] one query token per sequence
    k_pool: torch.Tensor,  # [N_rows, KV, hd] the shared block pool, flat rows
    v_pool: torch.Tensor,
    *,
    block_table: torch.Tensor,  # [B, nb] int32 pool-block id per sequence block
    q_pos: torch.Tensor,  # [B, 1] position of the query token (live length - 1)
    block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over the paged layout: a sequence's cache is the
    concatenation, in table order, of the ``block``-row pool blocks its
    ``block_table`` row names.  Row ``r`` of table entry ``j`` holds
    position ``j*block + r``, so validity is positional: rows past
    ``q_pos`` (the boundary block's tail, table padding pointing at the
    dump block 0) are masked as a dense cache's unwritten tail is.  The
    gathered rows then go through ``attention_ref``, so the result is
    bit-identical to dense decode over a cache of the same padded length."""
    B, nb = block_table.shape
    dev = k_pool.device
    rows = (
        block_table.long()[:, :, None] * block
        + torch.arange(block, device=dev)[None, None, :]
    ).reshape(B, nb * block)
    k = k_pool[rows]  # [B, nb*block, KV, hd]
    v = v_pool[rows]
    idx = torch.arange(nb * block, dtype=torch.int32, device=dev)[None]
    kv_pos = torch.where(idx <= q_pos.to(torch.int32), idx, -1)
    return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True, window=window)


def chunked_prefill_ref(
    q: torch.Tensor,  # [B, C, H, hd] up to C new tokens per sequence (a chunk)
    k_pool: torch.Tensor,  # [N_rows, KV, hd] the shared block pool, flat rows
    v_pool: torch.Tensor,
    *,
    block_table: torch.Tensor,  # [B, nb] int32 pool-block id per sequence block
    q_pos: torch.Tensor,  # [B, C] positions of the chunk tokens (-2^30 padding)
    block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the paged layout: ``paged_decode_ref``
    with up to ``C`` queries per sequence.  The chunk's own K/V already sit
    in the pool (the caller lands them first), so the query at position
    ``p`` attends the rows at positions ``[0, p]``: its reused context plus
    the chunk's causal prefix.  A decode row is one valid query at the live
    length, an idle row is all padding (``q_pos`` -2^30 masks every key and
    gives zeros).  Validity is positional only: row ``r`` of table entry
    ``j`` holds position ``j*block + r``, and rows past a query's position
    (the boundary block's tail, table padding on the dump block) mask out
    causally.  A C=1 call gives ``paged_decode_ref``'s bits."""
    B, nb = block_table.shape
    dev = k_pool.device
    rows = (
        block_table.long()[:, :, None] * block
        + torch.arange(block, device=dev)[None, None, :]
    ).reshape(B, nb * block)
    k = k_pool[rows]  # [B, nb*block, KV, hd]
    v = v_pool[rows]
    kv_pos = torch.arange(nb * block, dtype=torch.int32, device=dev)[None].expand(B, -1)
    return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True, window=window)


# --------------------------------------------------------------------------- #
# Mamba2 / SSD: sequential state-space scan (exact oracle)
# --------------------------------------------------------------------------- #
def ssd_scan_ref(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H]   (already softplus'd, > 0)
    A: torch.Tensor,  # [H]          (negative)
    B_: torch.Tensor,  # [B, L, G, S]
    C: torch.Tensor,  # [B, L, G, S]
    *,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, S]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective state-space recurrence
        h_t = exp(dt_t * A) * h_{t-1} + dt_t * (x_t ⊗ B_t)
        y_t = h_t · C_t
    as a plain sequential scan over time, in f32 (in f64 for f64 inputs):
    the exactness oracle of the chunked SSD scan.  Returns (y [B,L,H,P] in
    x's dtype, final state [B,H,P,S] in the scan's type)."""
    Bsz, L, H, P = x.shape
    G, S = B_.shape[2], B_.shape[3]
    rep = H // G
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Af = x.to(acc), dt.to(acc), A.to(acc)
    Bf = B_.to(acc).repeat_interleave(rep, dim=2)  # [B, L, H, S]
    Cf = C.to(acc).repeat_interleave(rep, dim=2)
    h = (torch.zeros((Bsz, H, P, S), dtype=acc, device=x.device)
         if initial_state is None else initial_state.to(acc))
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af[None, :])[:, :, None, None]  # [B,H,1,1]
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, :, None, :]
        h = h * decay + upd
        ys.append(torch.einsum("bhps,bhs->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, H, P))
    return y.to(x.dtype), h


def ssd_decode_ref(
    state: torch.Tensor,  # [B, H, P, S]
    x_t: torch.Tensor,  # [B, H, P]
    dt_t: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    B_t: torch.Tensor,  # [B, G, S]
    C_t: torch.Tensor,  # [B, G, S]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update (the O(1) decode step)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bf = B_t.float().repeat_interleave(rep, dim=1)  # [B, H, S]
    Cf = C_t.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(dt_t.float() * A.float()[None, :])
    upd = (dt_t.float()[:, :, None] * x_t.float())[..., None] * Bf[:, :, None, :]
    new_state = state.float() * decay[:, :, None, None] + upd
    y = torch.einsum("bhps,bhs->bhp", new_state, Cf).to(x_t.dtype)
    return y, new_state


# --------------------------------------------------------------------------- #
# KV-cache int8 compression (storage / transfer tier)
# --------------------------------------------------------------------------- #
def kv_quant_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation over the last (channel) axis.

    x: [..., hd]  ->  (q int8 [..., hd], scale f32 [..., 1]).  True IEEE
    divisions (not products with a reciprocal) and ``torch.round``'s
    half-to-even rounding, as the reference's ``jnp`` version computes them
    eagerly.  The 127 is a tensor, not a Python scalar: on CUDA, PyTorch
    divides by a scalar as a product with its reciprocal, one ulp off the
    division in some rows (XLA's jit rewrites the reference's the same way)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def kv_dequant_ref(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``."""
    return (q.float() * scale.float()).to(dtype)


# --------------------------------------------------------------------------- #
# MoE: dense loop-over-experts oracle (tests only: O(E) compute)
# --------------------------------------------------------------------------- #
def moe_ref(
    x: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,  # [D, E]
    w_gate: torch.Tensor,  # [E, D, F]
    w_up: torch.Tensor,  # [E, D, F]
    w_down: torch.Tensor,  # [E, F, D]
    top_k: int,
) -> torch.Tensor:
    """Exact dropless top-k MoE in f32: every token through each of its
    top-k experts (every expert computed densely over every token, then
    weighted by the renormalised router weights)."""
    xf = x.float()
    probs = torch.softmax(xf @ router_w.float(), dim=-1)  # [T, E]
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    weight = torch.zeros_like(probs).scatter_(1, top_i, top_p)  # [T, E]
    out = torch.zeros_like(xf)
    for e in range(router_w.shape[1]):
        g = xf @ w_gate[e].float()
        u = xf @ w_up[e].float()
        out = out + (torch.nn.functional.silu(g) * u) @ w_down[e].float() * weight[:, e:e + 1]
    return out.to(x.dtype)
