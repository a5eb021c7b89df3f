"""Position-masked GQA flash attention: the CUDA kernel and its plain
version.

The port's counterpart of the Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_prefill.py``), the attention of the per-request
(suffix-)prefill ``lm.prefill``: queries at absolute positions ``q_pos``
attend kv rows at ``kv_pos`` causally (or not, for cross-attention), within
an optional window, with ``kv_pos < 0`` or a false ``kv_valid`` marking an
invalid row.  The kernel is ``csrc/flash_prefill.cu``: bf16 on the
tensor-core tile of ``csrc/flash_mma.cuh``, f32 on the CUDA-core tile of
``csrc/flash_tile.cuh`` (their headers say what bounds each and how its
design answers that); ``flash_attention_plain`` is the same function in
plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import (
    MAX_HEAD_DIM, cuda_operands, dtype_code, int32, require, split_scratch,
)

NAME = "flash_attention"


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, causal: bool = True, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``ref.attention_plain``:
    ``ref.attention_ref``, q-chunked at large ``Sq * Skv``)."""
    return ref.attention_plain(
        q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
        kv_valid=kv_valid,
    )


def split_count(q: torch.Tensor, k: torch.Tensor) -> int:
    """S, the number of parts the kernel splits the kv tiles of these shapes
    into (chosen by the C launcher from the kv length; 1 in f32)."""
    return build.splits("flash_prefill", k.shape[1], q.shape[-1], dtype_code(NAME, q))


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # [B, Sq] int32 absolute query positions
    kv_pos: torch.Tensor,  # [B, Skv] int32 (-1 = invalid row)
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,  # [B, Skv] bool
    lse: Optional[torch.Tensor] = None,  # [B, Sq, H] f32, written when given
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (there is no fallback).  With ``lse`` the launch also writes
    each row's log-sum-exp of the scaled scores there (-inf for a row that
    every key masks): the training forward keeps it for the backward
    (``flash_backward``).  The output's bits are the same either way."""
    require(q.is_cuda, NAME, "q must be a CUDA tensor")
    require(q.dim() == 4, NAME, f"q shape {tuple(q.shape)}")
    B, Sq, H, hd = q.shape
    require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == hd, NAME, f"k shape {tuple(k.shape)}")
    Skv, KV = k.shape[1], k.shape[2]
    require(v.shape == k.shape, NAME, "v must have k's shape")
    require(KV > 0 and H % KV == 0, NAME, f"H={H} not a multiple of KV={KV}")
    require(1 <= hd <= MAX_HEAD_DIM, NAME, f"head_dim {hd} not in [1, {MAX_HEAD_DIM}]")
    require(k.dtype == q.dtype and v.dtype == q.dtype, NAME, "q, k, v dtypes differ")
    require(q_pos.shape == (B, Sq) and kv_pos.shape == (B, Skv), NAME, "q_pos/kv_pos shape")
    int32(NAME, q_pos=q_pos, kv_pos=kv_pos)
    code = dtype_code(NAME, q)
    operands = dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
    if kv_valid is not None:
        require(kv_valid.dtype == torch.bool and kv_valid.shape == (B, Skv), NAME,
                "kv_valid must be bool [B, Skv]")
        operands["kv_valid"] = kv_valid
    if lse is not None:
        require(lse.dtype == torch.float32 and lse.shape == (B, Sq, H), NAME,
                "lse must be f32 [B, Sq, H]")
        operands["lse"] = lse
    cuda_operands(NAME, q.device, **operands)
    out = torch.empty_like(q)
    if q.numel() == 0 or Skv == 0:
        if lse is not None:
            lse.fill_(-float("inf"))
        return out.zero_()
    launch = build.launcher("flash_prefill")
    # scratch holds the split partials until the launch is enqueued
    scratch, part_acc, part_ml = split_scratch(split_count(q, k), out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(), part_acc,
            part_ml, None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KV, hd, code,
            int(causal), int(window is not None), int(window or 0), float(hd) ** -0.5, stream,
        )
    build.check(status, NAME)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
