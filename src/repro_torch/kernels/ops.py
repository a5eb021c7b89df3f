"""Attention entry points of the model, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain version; there is no other switch and no size threshold (unlike the
JAX package's ``ops.py``, whose reference path also serves ``Sq < 128``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import packed_prefill as pk


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
