"""Packed ragged suffix-prefill attention: the CUDA kernel and its plain
version.

The port's counterpart of the Pallas kernel ``packed_flash_attention``
(``src/repro/kernels/packed_prefill.py``).  Batched admission concatenates
several requests' token runs into one sequence; each query attends only kv
rows of its own segment, causally at segment-local positions.  The kernel
is ``csrc/packed_prefill.cu`` (its header says what bounds it and how its
design answers that); ``packed_flash_attention_plain`` is the same function
in plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import HEAD_DIMS, cuda_operands, dtype_code, int32, require

NAME = "packed_flash_attention"


def packed_flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, q_seg: torch.Tensor, kv_seg: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``ref.packed_attention_ref``)."""
    return ref.packed_attention_ref(
        q, k, v, q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg,
        causal=causal, window=window,
    )


def packed_flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # [B, Sq] int32 segment-local positions
    kv_pos: torch.Tensor,  # [B, Skv] int32 (-1 = invalid row)
    q_seg: torch.Tensor,  # [B, Sq] int32 segment id per query token
    kv_seg: torch.Tensor,  # [B, Skv] int32 segment id per kv row
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (there is no fallback)."""
    require(q.is_cuda, NAME, "q must be a CUDA tensor")
    B, Sq, H, hd = q.shape
    require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == hd, NAME, f"k shape {tuple(k.shape)}")
    Skv, KV = k.shape[1], k.shape[2]
    require(v.shape == k.shape, NAME, "v must have k's shape")
    require(KV > 0 and H % KV == 0, NAME, f"H={H} not a multiple of KV={KV}")
    require(hd in HEAD_DIMS, NAME, f"head_dim {hd} not in {HEAD_DIMS}")
    require(k.dtype == q.dtype and v.dtype == q.dtype, NAME, "q, k, v dtypes differ")
    require(q_pos.shape == (B, Sq) and q_seg.shape == (B, Sq), NAME, "q_pos/q_seg shape")
    require(kv_pos.shape == (B, Skv) and kv_seg.shape == (B, Skv), NAME, "kv_pos/kv_seg shape")
    int32(NAME, q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg)
    code = dtype_code(NAME, q)
    cuda_operands(NAME, q.device, q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos,
                  q_seg=q_seg, kv_seg=kv_seg)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    launch = build.launcher("packed_prefill")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, hd, code, int(causal), int(window is not None),
            int(window or 0), float(hd) ** -0.5, stream,
        )
    build.check(status, NAME)
    packed_flash_attention.launches += 1
    return out


packed_flash_attention.launches = 0
