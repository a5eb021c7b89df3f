"""The backward of the position-masked GQA flash attention: the CUDA kernel
and its plain version, and the forward's plain version with its
log-sum-exp.

It belongs to the Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_prefill.py:91``) but replaces no Pallas kernel:
the JAX package differentiates through that call and has no backward
kernel.  The port's forward kernel (``flash_prefill.flash_attention``) has
no gradient, so the training forward (``ops.FlashAttentionFn``) runs the
forward kernel with its ``lse`` output and this backward, and a CUDA tensor
never falls back to plain PyTorch.  The kernel is
``csrc/flash_backward.cu`` (its header says what bounds it and how its
design answers that): bf16 launches run on the tensor cores, f32 launches
on the CUDA cores; ``flash_attention_bwd_plain`` writes out the same
formulas in plain PyTorch, so that the CPU tests check the algorithm the
kernel runs (not autograd of the plain forward).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import (
    MAX_HEAD_DIM, cuda_operands, dtype_code, int32, require,
)

NAME = "flash_attention_bwd"


def _mask(q_pos, kv_pos, causal, window, kv_valid) -> torch.Tensor:
    """[B, Sq, Skv] bool: the forward's kept (query, key) pairs."""
    mask = ref._position_mask(q_pos, kv_pos, causal, window)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, :]
    return mask


def _grouped(x: torch.Tensor, KV: int) -> torch.Tensor:
    """[B, Sq, H, ...] -> [B, Sq, KV, G, ...] in f32."""
    B, Sq, H = x.shape[:3]
    return x.float().reshape(B, Sq, KV, H // KV, *x.shape[3:])


def _per_row(x: torch.Tensor, KV: int) -> torch.Tensor:
    """A per-(query, head) value [B, Sq, H] as [B, KV, G, Sq, 1]."""
    return _grouped(x, KV).permute(0, 2, 3, 1)[..., None]


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, causal: bool = True, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's output (``ref.attention_plain``'s bits) and each row's
    log-sum-exp of the scaled scores ``lse [B, Sq, H]`` f32, -inf for a row
    that every key masks: what the forward kernel writes under training,
    both from one score product, in the query chunks of ``ref.q_chunks``
    (no whole ``Sq x Skv`` scores at large shapes)."""
    B, Sq, H, _ = q.shape
    outs, lses = [], []
    for c in ref.q_chunks(Sq, k.shape[1]):
        mask = _mask(q_pos[:, c], kv_pos, causal, window, kv_valid)
        out, lse = ref._masked_attention_lse(q[:, c], k, v, mask, with_lse=True)
        outs.append(out)
        lses.append(lse.permute(0, 3, 1, 2).reshape(B, -1, H))  # [B, KV, G, c] -> [B, c, H]

    def cat(parts):
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    return cat(outs), cat(lses).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, lse: torch.Tensor, *, q_pos: torch.Tensor, kv_pos: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the kernel's formulas in f32: P = exp(S·scale -
    lse) on kept pairs, D = rowsum(dO·O), dS = P·(dO Vᵀ - D)·scale, dQ = dS
    K, dK = dSᵀ Q, dV = Pᵀ dO, with dK and dV summed over each kv head's
    query heads; cast to the inputs' dtype.  Query chunks as
    ``ref.q_chunks`` gives them, dK and dV summed over the chunks in f32."""
    KV = k.shape[2]
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float(), v.float()
    dqs, dk, dv = [], None, None
    for c in ref.q_chunks(q.shape[1], k.shape[1]):
        kept = _mask(q_pos[:, c], kv_pos, causal, window, kv_valid)[:, None, None]
        qg, dog = _grouped(q[:, c], KV), _grouped(dout[:, c], KV)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)
        row_lse = _per_row(lse[:, c], KV)
        row_lse = torch.where(torch.isfinite(row_lse), row_lse, torch.zeros_like(row_lse))
        p = torch.where(kept, torch.exp(s * scale - row_lse), torch.zeros_like(s))
        d = _per_row((dout[:, c].float() * out[:, c].float()).sum(-1), KV)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
        ds = p * (dp - d) * scale
        dqs.append(torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(q[:, c].shape))
        dk_c = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
        dv_c = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
        dk = dk_c if dk is None else dk + dk_c
        dv = dv_c if dv is None else dv + dv_c
    dq = torch.cat(dqs, dim=1) if len(dqs) > 1 else dqs[0]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    out: torch.Tensor,  # [B, Sq, H, hd] the forward's output
    dout: torch.Tensor,  # [B, Sq, H, hd]
    lse: torch.Tensor,  # [B, Sq, H] f32, the forward kernel's
    *,
    q_pos: torch.Tensor,  # [B, Sq] int32
    kv_pos: torch.Tensor,  # [B, Skv] int32 (-1 = invalid row)
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,  # [B, Skv] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA backward on CUDA tensors: ``(dq, dk, dv)`` in the
    inputs' dtype; raises on anything it does not take (there is no
    fallback)."""
    require(q.is_cuda, NAME, "q must be a CUDA tensor")
    require(q.dim() == 4, NAME, f"q shape {tuple(q.shape)}")
    B, Sq, H, hd = q.shape
    require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == hd, NAME,
            f"k shape {tuple(k.shape)}")
    Skv, KV = k.shape[1], k.shape[2]
    require(v.shape == k.shape, NAME, "v must have k's shape")
    require(out.shape == q.shape and dout.shape == q.shape, NAME, "out/dout must have q's shape")
    require(KV > 0 and H % KV == 0, NAME, f"H={H} not a multiple of KV={KV}")
    require(1 <= hd <= MAX_HEAD_DIM, NAME, f"head_dim {hd} not in [1, {MAX_HEAD_DIM}]")
    require(all(t.dtype == q.dtype for t in (k, v, out, dout)), NAME,
            "q, k, v, out, dout dtypes differ")
    require(lse.dtype == torch.float32 and lse.shape == (B, Sq, H), NAME,
            "lse must be f32 [B, Sq, H]")
    require(q_pos.shape == (B, Sq) and kv_pos.shape == (B, Skv), NAME, "q_pos/kv_pos shape")
    int32(NAME, q_pos=q_pos, kv_pos=kv_pos)
    code = dtype_code(NAME, q)
    operands = dict(q=q, k=k, v=v, out=out, dout=dout, lse=lse, q_pos=q_pos, kv_pos=kv_pos)
    if kv_valid is not None:
        require(kv_valid.dtype == torch.bool and kv_valid.shape == (B, Skv), NAME,
                "kv_valid must be bool [B, Skv]")
        operands["kv_valid"] = kv_valid
    cuda_operands(NAME, q.device, **operands)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    d = torch.empty(B, Sq, H, dtype=torch.float32, device=q.device)  # rowsum(dO·O)
    # bf16 with G > 1: each query head's partial dK and dV, summed per kv
    # head in head order by the kernel's reduce
    parts = (None, None)
    if q.dtype == torch.bfloat16 and H > KV:
        parts = tuple(torch.empty(B, Skv, H, hd, dtype=torch.float32, device=q.device)
                      for _ in range(2))
    launch = build.launcher("flash_backward")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(), lse.data_ptr(), d.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(None if p is None else p.data_ptr() for p in parts), B, Sq, Skv, H, KV, hd, code,
            int(causal), int(window is not None), int(window or 0), float(hd) ** -0.5, stream,
        )
    build.check(status, NAME)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
