"""The backward of the Mamba2 SSD chunked scan: the CUDA kernel.

It belongs to the Pallas kernel ``ssd_chunked``
(``src/repro/kernels/ssd_scan.py:91``) but replaces no Pallas kernel: the
JAX package differentiates through its scan and has no backward kernel.
The port's forward kernel (``ssd_scan.ssd_chunked``) has no gradient, so
the training forward (``ops.SSDChunkedFn``) runs it and then this backward,
and a CUDA tensor never falls back to plain PyTorch.  The kernel is
``csrc/ssd_backward.cu`` (its header says what bounds it and how its design
answers that): it rebuilds the states before each chunk of
``ssd_scan.CHUNK`` tokens and runs the reverse state pass, then the chunk
gradient products, through a scratch of ``scratch_floats`` floats, with no
atomics.  In bf16 the products run on the tensor cores and dB, dC are
summed over slices of ``SLICE_HEADS`` heads, then over the slices; in f32
they run on the CUDA cores.  Its plain version is
``ssd_scan.ssd_chunked_bwd_plain``, the same equations in plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import cuda_operands, dtype_code, require
from repro_torch.kernels.ssd_scan import CHUNK, chunk_count

NAME = "ssd_chunked_bwd"


# heads of a slice of a group: the bf16 kernel sums dB and dC over each
# slice's heads in order, then over the slices (csrc/ssd_backward.cu's HEADS)
SLICE_HEADS = 8


def scratch_floats(Bsz: int, L: int, H: int, P: int, G: int, S: int, dtype: torch.dtype) -> int:
    """The f32 scratch of a launch (``csrc/ssd_backward.cu``'s layouts): per
    (batch, head, chunk) the state before the chunk and the gradient of the
    state after it, ``[P, S16]`` each, the chunk's decay and its dA term;
    then in bf16 the chunk's cum and dt and its d dt terms (``4 + P16/64 +
    S16/64`` vectors of ``CHUNK``), and the slices' f32 partial dB and dC
    (``[slices, B, L, G, S]`` each); in f32 the chunk's masked, decayed
    ``C Bᵀ`` and ``dY Xᵀ`` (``[CHUNK, CHUNK]`` each) and its ``e`` and ``w``
    vectors."""
    s16 = -(-S // 16) * 16
    bhn = Bsz * H * chunk_count(L)
    if dtype == torch.float32:
        return bhn * (2 * P * s16 + 2 * CHUNK * CHUNK + 2 * CHUNK + 2)
    terms = 4 + -(-P // 64) + -(-s16 // 64)
    slices = -(-(H // G) // SLICE_HEADS)
    return bhn * (2 * P * s16 + 2 + (2 + terms) * CHUNK) + 2 * slices * Bsz * L * G * S


def ssd_chunked_bwd(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] f32
    A: torch.Tensor,  # [H] f32
    B_: torch.Tensor,  # [B, L, G, S]
    C: torch.Tensor,  # [B, L, G, S]
    dy: torch.Tensor,  # [B, L, H, P] x's dtype
    dhT: Optional[torch.Tensor] = None,  # [B, H, P, S] f32
    *,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, S] f32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[torch.Tensor]]:
    """Launch the CUDA backward on CUDA tensors: ``(dx, ddt, dA, dB, dC,
    dh0)`` as ``ssd_scan.ssd_chunked_bwd_plain`` returns them (dh0 None
    without an ``initial_state``), in chunks of ``CHUNK`` tokens whatever
    chunk the forward was asked for (the chunked form is exact for any);
    raises on anything it does not take (there is no fallback)."""
    require(x.is_cuda, NAME, "x must be a CUDA tensor")
    require(x.dim() == 4 and dt.dim() == 3 and A.dim() == 1 and B_.dim() == 4, NAME,
            lambda: f"shapes x{tuple(x.shape)} dt{tuple(dt.shape)} A{tuple(A.shape)} "
            f"B{tuple(B_.shape)}")
    Bsz, L, H, P = x.shape
    G, S = B_.shape[2], B_.shape[3]
    require(L >= 1, NAME, "needs at least one token")
    require(H % G == 0, NAME, lambda: f"H={H} is not a multiple of G={G}")
    require(P <= 256 and S <= 256, NAME, lambda: f"P={P} and S={S} must be <= 256")
    require(tuple(dt.shape) == (Bsz, L, H) and tuple(A.shape) == (H,), NAME,
            lambda: f"dt{tuple(dt.shape)} and A{tuple(A.shape)} do not match x{tuple(x.shape)}")
    require(tuple(B_.shape) == (Bsz, L, G, S) and C.shape == B_.shape, NAME,
            lambda: f"B{tuple(B_.shape)} and C{tuple(C.shape)} do not match x{tuple(x.shape)}")
    require(dy.shape == x.shape, NAME, lambda: f"dy{tuple(dy.shape)} is not x's shape")
    code = dtype_code(NAME, x)
    require(all(t.dtype == x.dtype for t in (B_, C, dy)), NAME,
            lambda: f"B, C and dy must be {x.dtype}, got {B_.dtype}, {C.dtype}, {dy.dtype}")
    require(dt.dtype == torch.float32 and A.dtype == torch.float32, NAME,
            lambda: f"dt and A must be float32, got {dt.dtype} and {A.dtype}")
    operands = dict(x=x, dt=dt, A=A, B=B_, C=C, dy=dy)
    for name, t in (("initial_state", initial_state), ("dhT", dhT)):
        if t is not None:
            require(tuple(t.shape) == (Bsz, H, P, S) and t.dtype == torch.float32, NAME,
                    lambda: f"{name} must be float32 {(Bsz, H, P, S)}, got {t.dtype} "
                    f"{tuple(t.shape)}")
            operands[name] = t
    cuda_operands(NAME, x.device, **operands)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B_), torch.empty_like(C)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dh0 = torch.empty((Bsz, H, P, S), dtype=torch.float32, device=x.device)
    floats = scratch_floats(Bsz, L, H, P, G, S, x.dtype)
    # held until the launch is enqueued; the caching allocator then reuses
    # its memory only in stream order
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    launch = build.launcher("ssd_backward")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(), dy.data_ptr(),
            None if dhT is None else dhT.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
            floats, Bsz, L, H, P, G, S, chunk_count(L), code, stream)
    build.check(status, NAME)
    ssd_chunked_bwd.launches += 1
    return dx, ddt, dA, dB, dC, (dh0 if initial_state is not None else None)


ssd_chunked_bwd.launches = 0
