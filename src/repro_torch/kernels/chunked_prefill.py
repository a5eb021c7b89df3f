"""Chunked-prefill attention over the shared KV block pool: the CUDA kernel
and its plain version.

The port's counterpart of the Pallas kernel ``chunked_prefill_attention``
(``src/repro/kernels/chunked_prefill.py``), the launch of the unified
continuous-batching step: up to ``C`` query tokens per sequence against the
pool ``[N_rows, KV, hd]`` shared by every batch slot, each sequence's rows
named block by block by its ``block_table`` row.  One launch mixes decode
rows (one valid query at the live length), prefill-chunk rows (up to ``C``
new tokens whose K/V the caller has already landed in the pool) and idle
rows (all padding, ``q_pos`` -2^30, output zeros).  Validity is positional
(row ``r`` of table entry ``j`` is position ``j*block + r``).  The kernel is
``csrc/chunked_prefill.cu``: bf16 on the tensor-core tile of
``csrc/flash_mma.cuh``, f32 on the CUDA-core tile of ``csrc/flash_tile.cuh``
(their headers say what bounds each and how its design answers that);
``chunked_prefill_attention_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import (
    MAX_HEAD_DIM, cuda_operands, dtype_code, int32, require, split_scratch,
)

NAME = "chunked_prefill_attention"


def chunked_prefill_attention_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, *,
    block_table: torch.Tensor, q_pos: torch.Tensor, block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``ref.chunked_prefill_ref``)."""
    return ref.chunked_prefill_ref(
        q, k_pool, v_pool, block_table=block_table, q_pos=q_pos, block=block,
        window=window,
    )


def split_count(q: torch.Tensor, block_table: torch.Tensor, block: int) -> int:
    """S, the number of parts the kernel splits the kv tiles of these shapes
    into (chosen by the C launcher from the kv length; 1 in f32)."""
    return build.splits("chunked_prefill", block_table.shape[1], block, q.shape[-1],
                        dtype_code(NAME, q))


def chunked_prefill_attention(
    q: torch.Tensor,  # [B, C, H, hd]
    k_pool: torch.Tensor,  # [N_rows, KV, hd], N_rows = n_blocks * block
    v_pool: torch.Tensor,
    *,
    block_table: torch.Tensor,  # [B, nb] int32 pool block per sequence block
    q_pos: torch.Tensor,  # [B, C] int32 query positions (-2^30 = padding)
    block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (there is no fallback).  Every table entry a valid query
    reaches must name a pool block: the kernel traps on one that does not."""
    require(q.is_cuda, NAME, "q must be a CUDA tensor")
    require(q.dim() == 4 and q.shape[1] > 0, NAME, f"q shape {tuple(q.shape)}")
    B, C, H, hd = q.shape
    require(k_pool.dim() == 3 and k_pool.shape[2] == hd, NAME,
            f"k_pool shape {tuple(k_pool.shape)}")
    N_rows, KV = k_pool.shape[0], k_pool.shape[1]
    require(v_pool.shape == k_pool.shape, NAME, "v_pool must have k_pool's shape")
    require(block > 0 and N_rows % block == 0 and N_rows > 0, NAME,
            f"pool rows {N_rows} not a positive multiple of block {block}")
    require(KV > 0 and H % KV == 0, NAME, f"H={H} not a multiple of KV={KV}")
    require(1 <= hd <= MAX_HEAD_DIM, NAME, f"head_dim {hd} not in [1, {MAX_HEAD_DIM}]")
    require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype, NAME, "q, k, v dtypes differ")
    require(block_table.dim() == 2 and block_table.shape[0] == B and block_table.shape[1] > 0,
            NAME, f"block_table shape {tuple(block_table.shape)}")
    require(q_pos.shape == (B, C), NAME, "q_pos shape")
    int32(NAME, block_table=block_table, q_pos=q_pos)
    code = dtype_code(NAME, q)
    cuda_operands(NAME, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
                  block_table=block_table, q_pos=q_pos)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    nb = block_table.shape[1]
    launch = build.launcher("chunked_prefill")
    # scratch holds the split partials until the launch is enqueued
    scratch, part_acc, part_ml = split_scratch(split_count(q, block_table, block), out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), part_acc, part_ml, B, C, nb,
            N_rows // block, block, H, KV, hd, code, int(window is not None), int(window or 0),
            float(hd) ** -0.5, stream,
        )
    build.check(status, NAME)
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0
