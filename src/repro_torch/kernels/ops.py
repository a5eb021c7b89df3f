"""Kernel entry points of the port, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain version; there is no other switch and no size threshold (unlike the
JAX package's ``ops.py``, whose reference path also serves ``Sq < 128``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import chunked_prefill as cpk
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_prefill as fk
from repro_torch.kernels import fused_prefill as fuk
from repro_torch.kernels import kv_quant as kq
from repro_torch.kernels import packed_prefill as pk
from repro_torch.kernels import paged_decode as pdk
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssk


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, causal: bool = True, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Position-masked GQA attention (see ``ref.attention_ref``): the
    per-request prefill's attention."""
    fn = fk.flash_attention if q.is_cuda else fk.flash_attention_plain
    return fn(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
              kv_valid=kv_valid)


def packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, q_seg: torch.Tensor, kv_seg: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """Segment-masked attention over a packed ragged batch (see
    ``ref.packed_attention_ref``)."""
    fn = pk.packed_flash_attention if q.is_cuda else pk.packed_flash_attention_plain
    return fn(q, k, v, q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg,
              causal=causal, window=window)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One query token per sequence against the dense cache (see
    ``ref.attention_ref``)."""
    fn = dk.decode_attention if q.is_cuda else dk.decode_attention_plain
    return fn(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window, kv_valid=kv_valid)


def paged_decode(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, *,
    block_table: torch.Tensor, q_pos: torch.Tensor, block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query token per sequence against the shared block pool, through
    each sequence's block table (see ``ref.paged_decode_ref``)."""
    fn = pdk.paged_decode_attention if q.is_cuda else pdk.paged_decode_attention_plain
    return fn(q, k_pool, v_pool, block_table=block_table, q_pos=q_pos, block=block,
              window=window)


def chunked_prefill(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, *,
    block_table: torch.Tensor, q_pos: torch.Tensor, block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Up to ``C`` query tokens per sequence against the shared block pool,
    through each sequence's block table: the unified step's mixed launch of
    decode, prefill-chunk and idle rows (see ``ref.chunked_prefill_ref``)."""
    fn = cpk.chunked_prefill_attention if q.is_cuda else cpk.chunked_prefill_attention_plain
    return fn(q, k_pool, v_pool, block_table=block_table, q_pos=q_pos, block=block,
              window=window)


def fused_prefill(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, window: Optional[int] = None,
) -> torch.Tensor:
    """Selective-recompute attention of fused (CacheBlend-style) reuse: the
    recompute tokens at gappy positions ``q_pos`` against the assembled
    buffer (see ``ref.fused_prefill_ref``)."""
    fn = fuk.fused_flash_attention if q.is_cuda else fuk.fused_flash_attention_plain
    return fn(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)


def kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation over the last axis: ``(q int8,
    scale f32 [..., 1])`` (see ``ref.kv_quant_ref``).  Any head_dim >= 1: the
    reference's ``hd >= 8`` threshold does not carry over."""
    return (kq.kv_quant if x.is_cuda else kq.kv_quant_plain)(x)


def kv_dequant(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """``q * scale`` cast to ``dtype`` (see ``ref.kv_dequant_ref``)."""
    return (kq.kv_dequant if q.is_cuda else kq.kv_dequant_plain)(q, scale, dtype)


def ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C: torch.Tensor,
    *, chunk: int = 256, initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 SSD chunked scan: ``(y [B,L,H,P], final state [B,H,P,S]
    f32)``, exact against the sequential ``ref.ssd_scan_ref`` (see
    ``ssd_scan.ssd_chunked_plain``)."""
    fn = ssk.ssd_chunked if x.is_cuda else ssk.ssd_chunked_plain
    return fn(x, dt, A, B_, C, chunk=chunk, initial_state=initial_state)


def ssd_decode(
    state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor, A: torch.Tensor,
    B_t: torch.Tensor, C_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(1) single-token SSD update, plain PyTorch on every device (the
    reference's is plain jnp, not a kernel: ``ref.ssd_decode_ref``)."""
    return ref.ssd_decode_ref(state, x_t, dt_t, A, B_t, C_t)
