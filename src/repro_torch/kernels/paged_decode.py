"""Paged decode attention over the shared KV block pool: the CUDA kernel
and its plain version.

The port's counterpart of the Pallas kernel ``paged_decode_attention``
(``src/repro/kernels/paged_decode.py``): one query token per sequence
against the pool ``[N_rows, KV, hd]`` shared by every batch slot, each
sequence's rows named block by block by its ``block_table`` row.  Validity
is positional (row ``r`` of table entry ``j`` is position ``j*block + r``),
so table padding pointing at the dump block 0 masks itself.  The kernel is
``csrc/paged_decode.cu`` over the decode body of ``csrc/decode_block.cuh``
(its header says what bounds it and how its design answers that): it
splits the positions ``[0, nb * block)`` into the dense decode kernel's
parts over the same positions, so over the same rows both give the same
bits.  ``paged_decode_attention_plain`` is the same function in plain
PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels._checks import (
    MAX_HEAD_DIM, cuda_operands, dtype_code, int32, require, split_scratch,
)

NAME = "paged_decode_attention"


def part_count(nb: int, block: int) -> int:
    """The parts the kernel splits a table of ``nb`` entries of ``block``
    rows into: the dense kernel's over the same ``nb * block`` positions."""
    return dk.part_count(nb * block)


def paged_decode_attention_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, *,
    block_table: torch.Tensor, q_pos: torch.Tensor, block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``ref.paged_decode_ref``)."""
    return ref.paged_decode_ref(
        q, k_pool, v_pool, block_table=block_table, q_pos=q_pos, block=block,
        window=window,
    )


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_pool: torch.Tensor,  # [N_rows, KV, hd], N_rows = n_blocks * block
    v_pool: torch.Tensor,
    *,
    block_table: torch.Tensor,  # [B, nb] int32 pool block per sequence block
    q_pos: torch.Tensor,  # [B, 1] int32 position of the query token
    block: int = 128,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (there is no fallback).  Every table entry the query reaches
    must name a pool block: the kernel traps on one that does not."""
    require(q.is_cuda, NAME, "q must be a CUDA tensor")
    require(q.dim() == 4 and q.shape[1] == 1, NAME, "decode takes one query token per sequence")
    B, _, H, hd = q.shape
    require(k_pool.dim() == 3 and k_pool.shape[2] == hd, NAME,
            lambda: f"k_pool shape {tuple(k_pool.shape)}")
    N_rows, KV = k_pool.shape[0], k_pool.shape[1]
    require(v_pool.shape == k_pool.shape, NAME, "v_pool must have k_pool's shape")
    require(block > 0 and N_rows % block == 0 and N_rows > 0, NAME,
            lambda: f"pool rows {N_rows} not a positive multiple of block {block}")
    require(KV > 0 and H % KV == 0, NAME, lambda: f"H={H} not a multiple of KV={KV}")
    require(1 <= hd <= MAX_HEAD_DIM, NAME, lambda: f"head_dim {hd} not in [1, {MAX_HEAD_DIM}]")
    require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype, NAME, "q, k, v dtypes differ")
    require(block_table.dim() == 2 and block_table.shape[0] == B and block_table.shape[1] > 0,
            NAME, lambda: f"block_table shape {tuple(block_table.shape)}")
    require(q_pos.shape == (B, 1), NAME, "q_pos shape")
    int32(NAME, block_table=block_table, q_pos=q_pos)
    code = dtype_code(NAME, q)
    cuda_operands(NAME, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
                  block_table=block_table, q_pos=q_pos)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    nb = block_table.shape[1]
    launch = build.launcher("paged_decode")
    parts = part_count(nb, block)
    # scratch holds the parts' partials until the launch is enqueued
    scratch, part_acc, part_ml = split_scratch(parts, out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), part_acc, part_ml, B, nb, N_rows // block,
            block, H, KV, hd, code, int(window is not None), int(window or 0), parts,
            float(hd) ** -0.5, stream,
        )
    build.check(status, NAME)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
