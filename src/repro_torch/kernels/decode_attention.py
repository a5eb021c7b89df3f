"""Dense-cache decode attention: the CUDA kernel and its plain version.

The port's counterpart of the Pallas kernel ``decode_attention``
(``src/repro/kernels/decode_attention.py``): one query token per sequence
against the slotted cache ``[B, L, KV, hd]``, masked by position, an
optional window and an optional ``kv_valid``.  The kernel is
``csrc/decode_attention.cu`` (its header says what bounds it and how its
design answers that); ``decode_attention_plain`` is the same function in
plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import HEAD_DIMS, cuda_operands, dtype_code, int32, require

NAME = "decode_attention"
MAX_GROUP = 8  # query heads per kv head the kernel is built for


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (causal ``ref.attention_ref``)."""
    return ref.attention_ref(
        q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True, window=window,
        kv_valid=kv_valid,
    )


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k: torch.Tensor,  # [B, L, KV, hd]
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # [B, 1] int32
    kv_pos: torch.Tensor,  # [B, L] int32 (-1 = never written)
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,  # [B, L] bool
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (there is no fallback)."""
    require(q.is_cuda, NAME, "q must be a CUDA tensor")
    B, one, H, hd = q.shape
    require(one == 1, NAME, "decode takes one query token per sequence")
    require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == hd, NAME, f"k shape {tuple(k.shape)}")
    L, KV = k.shape[1], k.shape[2]
    require(v.shape == k.shape, NAME, "v must have k's shape")
    require(KV > 0 and H % KV == 0 and H // KV <= MAX_GROUP, NAME,
            f"H={H}, KV={KV}: need H % KV == 0 and H / KV <= {MAX_GROUP}")
    require(hd in HEAD_DIMS, NAME, f"head_dim {hd} not in {HEAD_DIMS}")
    require(k.dtype == q.dtype and v.dtype == q.dtype, NAME, "q, k, v dtypes differ")
    require(q_pos.shape == (B, 1) and kv_pos.shape == (B, L), NAME, "q_pos/kv_pos shape")
    int32(NAME, q_pos=q_pos, kv_pos=kv_pos)
    code = dtype_code(NAME, q)
    operands = dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
    if kv_valid is not None:
        require(kv_valid.dtype == torch.bool and kv_valid.shape == (B, L), NAME,
                "kv_valid must be bool [B, L]")
        operands["kv_valid"] = kv_valid
    cuda_operands(NAME, q.device, **operands)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    launch = build.launcher("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), None if kv_valid is None else kv_valid.data_ptr(),
            out.data_ptr(), B, L, H, KV, hd, code, int(window is not None),
            int(window or 0), float(hd) ** -0.5, stream,
        )
    build.check(status, NAME)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
