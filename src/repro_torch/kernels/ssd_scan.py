"""Mamba2 SSD chunked scan: the CUDA kernel and its plain version.

The port's counterpart of the Pallas kernel ``ssd_chunked``
(``src/repro/kernels/ssd_scan.py``), the mixer of every SSM layer's prefill:
the selective scan in its state-space-dual chunked form, returning ``y
[B, L, H, P]`` and the final state ``[B, H, P, S]`` (f32).  The kernel is
``csrc/ssd_scan.cu`` (its header says what bounds it and how its design
answers that): in bf16 three launches over chunks of ``CHUNK`` tokens (the
chunks' states on the tensor cores, a state pass in chunk order, the
chunks' outputs on the tensor cores) through a scratch of
``scratch_floats`` floats.  ``ssd_chunked_plain`` is the same function in
plain PyTorch, an op-by-op transcription of the JAX package's
``ops.ssd_chunked_jnp``, which is what the JAX engine runs on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import dtype_code, require

NAME = "ssd_chunked"
# tokens of the bf16 kernels' chunk (csrc/ssd_scan.cu's ssd::CHUNK, which the
# launcher checks against the chunk count it is given)
CHUNK = 128


def chunk_count(L: int) -> int:
    """The chunks the bf16 kernels split ``L`` tokens into, from token 0."""
    return max(1, -(-L // CHUNK))


def scratch_floats(Bsz: int, L: int, H: int, P: int, S: int) -> int:
    """The f32 scratch of a bf16 launch: for every (batch, head) each
    chunk's state ``[P, S16]`` (replaced in place by the state before the
    chunk) and its decay; ``S16`` is S rounded up to 16."""
    s16 = -(-S // 16) * 16
    return Bsz * H * chunk_count(L) * (P * s16 + 1)


def supported(x, dt, A, B_, C, *, chunk: int = 256) -> bool:
    """The shapes the reference's Pallas kernel takes (``ssd_scan.supported``)."""
    H, P = x.shape[2], x.shape[3]
    G = B_.shape[2]
    return H % G == 0 and P <= 256 and B_.shape[3] <= 256


def ssd_chunked_plain(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] (softplus'd, >= 0)
    A: torch.Tensor,  # [H] (negative)
    B_: torch.Tensor,  # [B, L, G, S]
    C: torch.Tensor,  # [B, L, G, S]
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, S]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk quadratic terms plus a cross-chunk state recurrence, in
    f32 (the reference's ``ops.ssd_chunked_jnp``).  Returns (y [B,L,H,P] in
    x's dtype, final state [B,H,P,S] f32)."""
    Bsz, L, H, P = x.shape
    G, S = B_.shape[2], B_.shape[3]
    rep = H // G

    pad = (-L) % chunk
    if pad:
        # dt = 0 on padding => decay exp(0)=1 and zero update: state-safe.
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B_ = torch.nn.functional.pad(B_, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // chunk

    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    Bf = B_.float().repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, S)
    Cf = C.float().repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, S)
    Af = A.float()

    a = dtf * Af[None, None, None, :]  # [B,nc,Q,H], <= 0
    cum = torch.cumsum(a, dim=2)  # inclusive cumsum within chunk

    # Within-chunk ("diagonal") term: y[t] += sum_{s<=t} (C_t.B_s) e^{cum_t-cum_s} dt_s x_s
    CB = torch.einsum("bnqhs,bnkhs->bnhqk", Cf, Bf)  # [B,nc,H,Q,Q]
    ct = cum.permute(0, 1, 3, 2)  # [B,nc,H,Q]
    dmat = ct[:, :, :, :, None] - ct[:, :, :, None, :]  # cum_t - cum_s
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    dmat = dmat.masked_fill(~tri, float("-inf"))
    decay = torch.exp(dmat)  # [B,nc,H,Q,Q]
    M = CB * decay * dtf.permute(0, 1, 3, 2)[:, :, :, None, :]  # * dt_s
    y_diag = torch.einsum("bnhqk,bnkhp->bnqhp", M, xf)

    # Per-chunk end-state contribution: sum_s e^{cum_{Q-1}-cum_s} dt_s x_s ⊗ B_s
    end_decay = torch.exp(ct[:, :, :, -1:] - ct)  # [B,nc,H,Q]
    weighted_x = xf * (dtf * end_decay.permute(0, 1, 3, 2))[..., None]  # [B,nc,Q,H,P]
    chunk_states = torch.einsum("bnqhp,bnqhs->bnhps", weighted_x, Bf)

    # Cross-chunk recurrence over nc chunks.
    chunk_decay = torch.exp(ct[:, :, :, -1])  # [B,nc,H] total decay of each chunk
    h = (torch.zeros((Bsz, H, P, S), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    h_inits = []
    for n in range(nc):
        h_inits.append(h)  # state BEFORE this chunk
        h = h * chunk_decay[:, n, :, None, None] + chunk_states[:, n]
    h_inits = torch.stack(h_inits, dim=1)  # [B,nc,H,P,S]

    # Off-diagonal term: y[t] += e^{cum_t} * (C_t · h_init)
    y_off = torch.einsum("bnqhs,bnhps->bnqhp", Cf, h_inits)
    y_off = y_off * torch.exp(cum)[..., None]

    y = (y_diag + y_off).reshape(Bsz, Lp, H, P)[:, :L]
    return y.to(x.dtype), h


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked_plain``'s function through the CUDA kernel: x, B, C in
    f32 or bf16 (one type), dt, A and ``initial_state`` in f32, all
    contiguous on one card; any ``H % G == 0``, ``P <= 256``, ``S <= 256``,
    ``L >= 1``.  bf16 runs in chunks of ``CHUNK`` tokens, f32 in chunks of
    ``min(chunk, 64)``: the chunked form is exact for any chunk length.
    Launches the kernel; raises on anything it does not take (there is no
    fallback)."""
    require(x.is_cuda, NAME, "x must be a CUDA tensor")
    require(x.dim() == 4 and dt.dim() == 3 and A.dim() == 1 and B_.dim() == 4, NAME,
            lambda: f"shapes x{tuple(x.shape)} dt{tuple(dt.shape)} A{tuple(A.shape)} "
            f"B{tuple(B_.shape)}")
    Bsz, L, H, P = x.shape
    G, S = B_.shape[2], B_.shape[3]
    require(L >= 1, NAME, "needs at least one token")
    require(H % G == 0, NAME, lambda: f"H={H} is not a multiple of G={G}")
    require(P <= 256 and S <= 256, NAME, lambda: f"P={P} and S={S} must be <= 256")
    require(chunk >= 1, NAME, lambda: f"chunk={chunk} must be >= 1")
    require(tuple(dt.shape) == (Bsz, L, H) and tuple(A.shape) == (H,), NAME,
            lambda: f"dt{tuple(dt.shape)} and A{tuple(A.shape)} do not match x{tuple(x.shape)}")
    require(tuple(B_.shape) == (Bsz, L, G, S) and C.shape == B_.shape, NAME,
            lambda: f"B{tuple(B_.shape)} and C{tuple(C.shape)} do not match x{tuple(x.shape)}")
    code = dtype_code(NAME, x)
    require(B_.dtype == x.dtype and C.dtype == x.dtype, NAME,
            lambda: f"B and C must be {x.dtype}, got {B_.dtype} and {C.dtype}")
    require(dt.dtype == torch.float32 and A.dtype == torch.float32, NAME,
            lambda: f"dt and A must be float32, got {dt.dtype} and {A.dtype}")
    ins = {"x": x, "dt": dt, "A": A, "B": B_, "C": C}
    if initial_state is not None:
        require(tuple(initial_state.shape) == (Bsz, H, P, S), NAME,
                lambda: f"initial_state{tuple(initial_state.shape)} is not {(Bsz, H, P, S)}")
        require(initial_state.dtype == torch.float32, NAME, "initial_state must be float32")
        ins["initial_state"] = initial_state
    for name, t in ins.items():
        require(t.device == x.device, NAME, lambda: f"{name} is on {t.device}, expected {x.device}")
        require(t.is_contiguous(), NAME, lambda: f"{name} must be contiguous")
    y = torch.empty_like(x)
    hT = torch.empty((Bsz, H, P, S), dtype=torch.float32, device=x.device)
    scratch, floats, n_chunks = None, 0, 0
    if x.dtype == torch.bfloat16:
        # held until the launch is enqueued; the caching allocator then
        # reuses its memory only in stream order
        n_chunks = chunk_count(L)
        floats = scratch_floats(Bsz, L, H, P, S)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    launch = build.launcher("ssd_scan")
    h0 = initial_state.data_ptr() if initial_state is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C.data_ptr(),
                        h0, y.data_ptr(), hT.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), floats, Bsz, L, H, P,
                        G, S, chunk, n_chunks, code, stream)
    build.check(status, NAME)
    ssd_chunked.launches += 1
    return y, hT


ssd_chunked.launches = 0
