"""Plain PyTorch versions of the attention kernels on the port's path.

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
from typing import Optional

import torch

NEG_INF = -1e30


def _masked_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, Sq, Skv] bool
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    m = mask[:, None, None]  # [B, 1, 1, Sq, Skv]
    scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    scores = scores - scores.amax(dim=-1, keepdim=True)
    w = torch.where(m, torch.exp(scores), torch.zeros_like(scores))
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


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
