"""Selective-recompute fused prefill attention: the CUDA kernel and its plain
version.

The port's counterpart of the Pallas kernel ``fused_flash_attention``
(``src/repro/kernels/fused_prefill.py``), the attention of a CacheBlend-style
fused reuse admission: the tokens chosen for recompute (a gappy, ascending
subset of positions ``q_pos``, -2^30 for padding) attend causally over one
assembled KV buffer whose row ``j`` sits at position ``kv_pos[j]`` (-1 for an
invalid row), within an optional window.  The kernel is
``csrc/fused_prefill.cu``: bf16 on the tensor-core tile of
``csrc/flash_mma.cuh``, f32 on the CUDA-core tile of ``csrc/flash_tile.cuh``
(their headers say what bounds each and how its design answers that);
``fused_flash_attention_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import (
    MAX_HEAD_DIM, cuda_operands, dtype_code, int32, require, split_scratch,
)

NAME = "fused_flash_attention"


def fused_flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``ref.fused_prefill_ref``)."""
    return ref.fused_prefill_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)


def split_count(q: torch.Tensor, k: torch.Tensor) -> int:
    """S, the number of parts the kernel splits the kv tiles of these shapes
    into (chosen by the C launcher from the kv length; 1 in f32)."""
    return build.splits("fused_prefill", k.shape[1], q.shape[-1], dtype_code(NAME, q))


def fused_flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd] recompute tokens only
    k: torch.Tensor,  # [B, Skv, KV, hd] assembled buffer
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # [B, Sq] int32 gappy ascending positions (-2^30 = padding)
    kv_pos: torch.Tensor,  # [B, Skv] int32 row positions (-1 = invalid row)
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (there is no fallback)."""
    require(q.is_cuda, NAME, "q must be a CUDA tensor")
    require(q.dim() == 4, NAME, f"q shape {tuple(q.shape)}")
    B, Sq, H, hd = q.shape
    require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == hd, NAME,
            f"k shape {tuple(k.shape)}")
    Skv, KV = k.shape[1], k.shape[2]
    require(v.shape == k.shape, NAME, "v must have k's shape")
    require(KV > 0 and H % KV == 0, NAME, f"H={H} not a multiple of KV={KV}")
    require(1 <= hd <= MAX_HEAD_DIM, NAME, f"head_dim {hd} not in [1, {MAX_HEAD_DIM}]")
    require(k.dtype == q.dtype and v.dtype == q.dtype, NAME, "q, k, v dtypes differ")
    require(q_pos.shape == (B, Sq) and kv_pos.shape == (B, Skv), NAME, "q_pos/kv_pos shape")
    int32(NAME, q_pos=q_pos, kv_pos=kv_pos)
    code = dtype_code(NAME, q)
    cuda_operands(NAME, q.device, q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
    out = torch.empty_like(q)
    if q.numel() == 0 or Skv == 0:
        return out.zero_()
    launch = build.launcher("fused_prefill")
    # scratch holds the split partials until the launch is enqueued
    scratch, part_acc, part_ml = split_scratch(split_count(q, k), out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            out.data_ptr(), part_acc, part_ml, B, Sq, Skv, H, KV, hd,
            code, int(window is not None), int(window or 0), float(hd) ** -0.5, stream,
        )
    build.check(status, NAME)
    fused_flash_attention.launches += 1
    return out


fused_flash_attention.launches = 0
