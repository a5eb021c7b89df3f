"""Kernel entry points of the port, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel, a CPU (or ``meta``) tensor
to the kernel's plain version; there is no other switch and no size
threshold between them (unlike the JAX package's ``ops.py``, whose
reference path also serves ``Sq < 128``).  Inside the plain flash paths
(forward, forward with ``lse``, backward) the reference's
``CHUNKED_THRESHOLD`` picks query chunks (``ref.q_chunks``), so no
``Sq x Skv`` score tensor is held whole, on the CPU or in the dry run.

``flash_attention`` and ``ssd_chunked`` are the entry points with a
gradient: under grad mode with an operand that requires grad they run
``FlashAttentionFn`` and ``SSDChunkedFn``, whose backwards are kernels too
(``flash_backward``, ``ssd_backward``).  Everywhere else (every serving path
runs under ``torch.inference_mode()``) they launch what they launched
before.

``flash_attention`` and ``decode_attention`` with ``kv_group`` take the
KV-length-sharded route (the reference's ``_kv_sharded_attention``): each
rank of the group holds its own rows of the cache, runs the flash kernel
with its ``lse`` output over them (``flash_pieces``), and the ranks merge
the pieces with two all-reduces of statistics and one of the output
(``_combine``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import chunked_prefill as cpk
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_backward as fbk
from repro_torch.kernels import flash_prefill as fk
from repro_torch.kernels import fused_prefill as fuk
from repro_torch.kernels import kv_quant as kq
from repro_torch.kernels import packed_prefill as pk
from repro_torch.kernels import paged_decode as pdk
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_backward as sbk
from repro_torch.kernels import ssd_scan as ssk


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient.  The forward runs the forward
    kernel with its ``lse`` output (``flash_backward.flash_attention_fwd_plain``
    on the CPU) and keeps q, k, v, the output, ``lse`` and the positions;
    the backward runs ``flash_backward.flash_attention_bwd`` (its plain
    version on the CPU).  The positions, flags and ``kv_valid`` get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, kv_valid):
        kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window, kv_valid=kv_valid)
        if q.is_cuda:
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
            out = fk.flash_attention(q, k, v, lse=lse, **kw)
        else:
            out, lse = fbk.flash_attention_fwd_plain(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos, kv_valid)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos, kv_valid = ctx.saved_tensors
        fn = fbk.flash_attention_bwd if q.is_cuda else fbk.flash_attention_bwd_plain
        dq, dk, dv = fn(q, k, v, out, dout.contiguous(), lse, q_pos=q_pos, kv_pos=kv_pos,
                        causal=ctx.causal, window=ctx.window, kv_valid=kv_valid)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, causal: bool = True, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None, kv_group: Any = None,
) -> torch.Tensor:
    """Position-masked GQA attention (see ``ref.attention_ref``): the
    per-request prefill's attention, and the training forward's through
    ``FlashAttentionFn`` when a gradient is wanted.  With ``kv_group`` (a
    process group) ``k``, ``v``, ``kv_pos`` and ``kv_valid`` are this rank's
    shard of the kv rows and every rank of the group gets the attention
    over all of them (no gradient on that route)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if kv_group is not None:
        if grad:
            raise ValueError("flash_attention: the KV-sharded route has no gradient")
        return _kv_sharded(q, k, v, kv_group, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                           window=window, kv_valid=kv_valid)
    if grad:
        return FlashAttentionFn.apply(q, k, v, q_pos, kv_pos, causal, window, kv_valid)
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
    kv_valid: Optional[torch.Tensor] = None, kv_group: Any = None,
) -> torch.Tensor:
    """One query token per sequence against the dense cache (see
    ``ref.attention_ref``).  With ``kv_group`` the cache is length-sharded
    over the group, as in ``flash_attention``, and each rank's rows go
    through the flash kernel (one query row a sequence), as the reference's
    sharded decode runs its flash pieces."""
    if kv_group is not None:
        return _kv_sharded(q, k, v, kv_group, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                           window=window, kv_valid=kv_valid)
    fn = dk.decode_attention if q.is_cuda else dk.decode_attention_plain
    return fn(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window, kv_valid=kv_valid)


# --------------------------------------------------------------------------- #
# KV-length-sharded attention
# --------------------------------------------------------------------------- #
def flash_pieces(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos: torch.Tensor,
    kv_pos: torch.Tensor, causal: bool = True, window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over one shard of the kv rows and each row's log-sum-exp
    of its scaled scores, ``(out [B, Sq, H, hd], lse [B, Sq, H] f32)``, -inf
    where the shard keeps no key for the row (its output is 0 there): the
    flash kernel with its ``lse`` on a CUDA tensor, the plain forward on a
    CPU one."""
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window, kv_valid=kv_valid)
    if q.is_cuda:
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        return fk.flash_attention(q, k, v, lse=lse, **kw), lse
    return fbk.flash_attention_fwd_plain(q, k, v, **kw)


def _combine(out: torch.Tensor, lse: torch.Tensor, all_max: Callable, all_sum: Callable
             ) -> torch.Tensor:
    """The pieces' merge in f32: lse* = logsumexp over shards of lse_i (a
    max, then a sum), o = sum over shards of o_i exp(lse_i - lse*).  A shard
    that keeps no key for a row (lse_i = -inf) weighs 0 there; a row that
    keeps none anywhere gets 0, as the reference's ``o / max(l, 1e-30)``.
    ``all_max`` and ``all_sum`` reduce over the shards.  With one shard the
    weight is exactly 1, so the merge returns the piece's own values."""
    m = all_max(lse)
    m = torch.where(torch.isinf(m), 0.0, m)  # -inf only where every shard is empty
    s = all_sum(torch.exp(lse - m))
    w = torch.where(s > 0, torch.exp(lse - (m + torch.log(s))), 0.0)
    return all_sum(out.float() * w[..., None])


def combine_pieces(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """``flash_pieces`` of every shard, in one process, merged into the
    attention over all the rows (cast to the pieces' dtype)."""
    merged = _combine(torch.stack(list(outs)), torch.stack(list(lses)),
                      lambda t: t.amax(0), lambda t: t.sum(0))
    return merged.to(outs[0].dtype)


def _kv_sharded(q, k, v, group, **kw) -> torch.Tensor:
    out, lse = flash_pieces(q, k, v, **kw)

    def reduce(op):
        def fn(t):
            t = t.clone()
            dist.all_reduce(t, op=op, group=group)
            return t
        return fn

    return _combine(out, lse, reduce(dist.ReduceOp.MAX), reduce(dist.ReduceOp.SUM)).to(q.dtype)


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


class SSDChunkedFn(torch.autograd.Function):
    """``ssd_chunked`` with a gradient.  The forward runs the scan (the
    kernel on the card, ``ssd_scan.ssd_chunked_plain`` on the CPU) and keeps
    its inputs; the backward runs ``ssd_backward.ssd_chunked_bwd`` (on the
    CPU ``ssd_scan.ssd_chunked_bwd_plain`` at the forward's chunk) with the
    gradients of y and of the final state (None where the caller used
    neither)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, chunk, initial_state):
        fn = ssk.ssd_chunked if x.is_cuda else ssk.ssd_chunked_plain
        y, hT = fn(x, dt, A, B_, C, chunk=chunk, initial_state=initial_state)
        ctx.save_for_backward(x, dt, A, B_, C, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, B_, C, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dhT = None if dhT is None else dhT.contiguous()
        if x.is_cuda:
            grads = sbk.ssd_chunked_bwd(x, dt, A, B_, C, dy, dhT, initial_state=h0)
        else:
            grads = ssk.ssd_chunked_bwd_plain(x, dt, A, B_, C, dy, dhT, chunk=ctx.chunk,
                                              initial_state=h0)
        dx, ddt, dA, dB, dC, dh0 = grads
        return dx, ddt, dA, dB, dC, None, dh0


def ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C: torch.Tensor,
    *, chunk: int = 256, initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 SSD chunked scan: ``(y [B,L,H,P], final state [B,H,P,S]
    f32)``, exact against the sequential ``ref.ssd_scan_ref`` (see
    ``ssd_scan.ssd_chunked_plain``); through ``SSDChunkedFn`` when a
    gradient is wanted."""
    operands = (x, dt, A, B_, C, initial_state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return SSDChunkedFn.apply(x, dt, A, B_, C, chunk, initial_state)
    fn = ssk.ssd_chunked if x.is_cuda else ssk.ssd_chunked_plain
    return fn(x, dt, A, B_, C, chunk=chunk, initial_state=initial_state)


def ssd_decode(
    state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor, A: torch.Tensor,
    B_t: torch.Tensor, C_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(1) single-token SSD update, plain PyTorch on every device (the
    reference's is plain jnp, not a kernel: ``ref.ssd_decode_ref``)."""
    return ref.ssd_decode_ref(state, x_t, dt_t, A, B_t, C_t)
