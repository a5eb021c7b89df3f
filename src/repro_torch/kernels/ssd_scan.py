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


def ssd_chunked_bwd_plain(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H]
    A: torch.Tensor,  # [H]
    B_: torch.Tensor,  # [B, L, G, S]
    C: torch.Tensor,  # [B, L, G, S]
    dy: torch.Tensor,  # [B, L, H, P] the gradient of y
    dhT: Optional[torch.Tensor] = None,  # [B, H, P, S] the gradient of the final state
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, S]
    precision: torch.dtype = torch.float64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[torch.Tensor]]:
    """``(dx, ddt, dA, dB, dC, dh0)`` of ``ssd_chunked_plain`` from the chunk
    equations in ``precision`` (f64), written out (not autograd): per
    (batch, head) and chunk, with ``L[t,s] = exp(cum_t - cum_s)`` (s <=
    t), ``M = (C Bᵀ) ⊙ L ⊙ dt_s``, ``dM = dY Xᵀ``, ``e_t = exp(cum_t)`` and
    ``w_s = exp(cum_last - cum_s)``:

      dh_in = exp(cum_last) dh_out + Σ_t e_t dy_t ⊗ C_t   (in reverse chunk
              order from dhT, or zero; dh0 is the first chunk's dh_in)
      dx_s  = dt_s [Σ_t (C_t·B_s) L[t,s] dy_t + w_s dh_out B_s]
      dC_t  = Σ_s L[t,s] dt_s (dy_t·x_s) B_s + e_t dy_tᵀ h_in
      dB_s  = dt_s [Σ_t L[t,s] (dy_t·x_s) C_t + w_s dh_outᵀ x_s]
      d dt_s (direct) = the two sums of dx_s dotted with x_s, over dt_s

    and ``cum`` collects ``rowsum(W) - colsum(W)`` (``W = dM ⊙ M``), ``dy_t
    · y_off_t`` and, with ``u_s = w_s dt_s x_s·(dh_out B_s)``, ``Σ_s u_s +
    exp(cum_last) <dh_out, h_in>`` at the chunk's last token and ``-u_s``
    at token s; ``da`` is its reverse cumsum in the chunk, ``d dt += da
    A_h`` and ``dA_h = Σ da ⊙ dt``.  dB and dC sum over each group's heads.
    dx, dB and dC come in the inputs' dtype, ddt, dA and dh0 in f32; dh0
    is None without an ``initial_state``.  f64 by default because ``d dt`` sums terms
    that largely cancel (``rowsum(W) - colsum(W)``, then a reverse cumsum):
    in f32 this version alone moved a reduced jamba's ``in_proj_dt``
    gradient by ~5e-6 of its largest value, half the port's gradient
    tolerance against the JAX package.  ``precision=torch.float32`` at the
    kernel's chunk is the CUDA kernel's own arithmetic (every product in
    f32), which its numerics test takes."""
    Bsz, L, H, P = x.shape
    G, S = B_.shape[2], B_.shape[3]
    rep = H // G

    pad = (-L) % chunk
    if pad:  # dt = 0 and dy = 0 on padding: it adds nothing either way
        x, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B_, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (B_, C))
    Lp = L + pad
    nc = Lp // chunk

    xf = x.to(precision).reshape(Bsz, nc, chunk, H, P)
    dyf = dy.to(precision).reshape(Bsz, nc, chunk, H, P)
    dtf = dt.to(precision).reshape(Bsz, nc, chunk, H)
    Bf = B_.to(precision).repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, S)
    Cf = C.to(precision).repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, S)
    Af = A.to(precision)

    cum = torch.cumsum(dtf * Af, dim=2)  # [B,nc,Q,H]
    ct = cum.permute(0, 1, 3, 2)  # [B,nc,H,Q]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    decay = torch.exp((ct[..., :, None] - ct[..., None, :]).masked_fill(~tri, float("-inf")))
    e = torch.exp(cum)  # [B,nc,Q,H]
    w = torch.exp(cum[:, :, -1:] - cum)  # [B,nc,Q,H]
    last = torch.exp(ct[..., -1])  # [B,nc,H]

    # the states before each chunk (the forward's recurrence) ...
    states = torch.einsum("bnqhp,bnqhs->bnhps", xf * (dtf * w)[..., None], Bf)
    h = (torch.zeros((Bsz, H, P, S), dtype=precision, device=x.device)
         if initial_state is None else initial_state.to(precision))
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = h * last[:, n, :, None, None] + states[:, n]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,S]
    # ... and the gradients of the states after them, in reverse chunk order
    local = torch.einsum("bnqhp,bnqhs->bnhps", dyf * e[..., None], Cf)
    g = (torch.zeros((Bsz, H, P, S), dtype=precision, device=x.device)
         if dhT is None else dhT.to(precision))
    dh_out = [None] * nc
    for n in reversed(range(nc)):
        dh_out[n] = g
        g = g * last[:, n, :, None, None] + local[:, n]
    dh_out = torch.stack(dh_out, dim=1)  # [B,nc,H,P,S]

    CBL = torch.einsum("bnthk,bnshk->bnhts", Cf, Bf) * decay  # (C_t·B_s) L[t,s]
    dM = torch.einsum("bnthp,bnshp->bnhts", dyf, xf)  # dy_t·x_s
    dML = dM * decay
    dts = dtf.permute(0, 1, 3, 2)  # [B,nc,H,Q]
    Z = torch.einsum("bnshk,bnhpk->bnshp", Bf, dh_out)  # dh_out B_s
    dx = dtf[..., None] * (torch.einsum("bnhts,bnthp->bnshp", CBL, dyf) + w[..., None] * Z)
    dC = (torch.einsum("bnhts,bnshk->bnthk", dML * dts[..., None, :], Bf)
          + e[..., None] * torch.einsum("bnthp,bnhpk->bnthk", dyf, h_in))
    dB = dtf[..., None] * (torch.einsum("bnhts,bnthk->bnshk", dML, Cf)
                           + w[..., None] * torch.einsum("bnshp,bnhpk->bnshk", xf, dh_out))

    v = w * (xf * Z).sum(-1)  # [B,nc,Q,H]: x_s·(w_s dh_out B_s)
    q = (CBL * dM).sum(-2)  # [B,nc,H,Q]: Σ_t (C_t·B_s) L[t,s] (dy_t·x_s)
    W = CBL * dM * dts[..., None, :]  # dM ⊙ M
    y_off = e[..., None] * torch.einsum("bnthk,bnhpk->bnthp", Cf, h_in)
    u = dts * v.permute(0, 1, 3, 2)  # [B,nc,H,Q]
    dcum = W.sum(-1) - W.sum(-2) + (dyf * y_off).sum(-1).permute(0, 1, 3, 2) - u
    dcum[..., -1] += u.sum(-1) + last * (dh_out * h_in).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))  # [B,nc,H,Q]
    ddt = q + v.permute(0, 1, 3, 2) + da * Af[:, None]
    dA = (da * dts).sum((0, 1, 3))

    def tokens(t):  # [B,nc,Q,H,...] -> [B,L,H,...]
        return t.reshape(Bsz, Lp, *t.shape[3:])[:, :L]

    def grouped(t):  # [B,nc,Q,H,S] -> [B,L,G,S], summed over each group's heads
        return tokens(t.reshape(Bsz, nc, chunk, G, rep, S).sum(4))

    dh0 = None if initial_state is None else g
    return (tokens(dx).to(x.dtype), tokens(ddt.permute(0, 1, 3, 2)).float().contiguous(),
            dA.float(), grouped(dB).to(B_.dtype), grouped(dC).to(C.dtype),
            None if dh0 is None else dh0.float())


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
