"""The bf16 and f32 arithmetic of the SSD backward kernel, emulated on the
CPU, against its plain version.

``csrc/ssd_backward.cu`` runs the chunk equations of
``ssd_scan.ssd_chunked_bwd_plain`` over chunks of ``ssd_scan.CHUNK`` tokens.
An f32 launch runs every product in f32 on the CUDA cores;
``ssd_chunked_bwd_plain(..., precision=torch.float32)`` at that chunk is that
arithmetic in another summation order.  A bf16 launch runs its chunk
products on the tensor cores: x, dy, B and C are bf16, so C Bᵀ and dY Xᵀ
are exact products summed in f32, and the f32 operands enter as bf16 parts
(hi = bf16(v), mid = bf16(v - hi)): two for the masked, decayed scores
((C Bᵀ) ⊙ L for dx, (dY Xᵀ) ⊙ L ⊙ dt_s for dB and dC) and two for the
states h_in and dh_out (dh_out B_s, X dh_out, dY h_in); the states
themselves (and the local dh term) come from the forward's tensor-core
kernel with three parts, f32 to ~2^-26.  ``_emulate`` redoes that
arithmetic in f32 (hi + mid is exact in f32; only the order of the f32 sums
differs from the kernel's), with dy_t·y_off_t taken as C_t·(e_t dy_tᵀ
h_in) and the column sums of W as dt_s q_s, as the kernel takes them.
These tests hold both to the plain version (f64, at the model's chunk of
256) within half of the tolerances that ``chip_smoke.py`` and the ``gpu``
tests hold the kernel to, set here before the kernel first ran on the card:

  * an output in the inputs' bf16 (dx, dB, dC of a bf16 launch): max|k -
    p| <= 2^-7 max|p|, one bf16 step at the largest magnitude (both sides
    round their f32 or f64 sums to bf16: where the two sums straddle a
    rounding boundary they part by one step); the f32 emulation reads <=
    1.6e-3, the two-part emulation <= 1.6e-3;
  * an f32 output (d dt, dA, dh0, and every output of an f32 launch):
    max|k - p| <= 1e-4 max|p|; the emulations read <= 1.7e-5 (d dt, whose
    sums largely cancel), the others <= 1e-5.

One part fewer breaks the half gate: one bf16 part for the scores moves
dx, dB and dC past it at mamba2-1.3b's heads, one for the states moves
d dt past it ten times over.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan as ssk  # noqa: E402

torch.set_num_threads(1)
BF16_RTOL = 2.0**-7
F32_RTOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")

# (B, L, H, P, G, S): mamba2-1.3b's heads (P 64, S 128, G 1), jamba's (P 128,
# S 16), two groups over a padded last chunk
SHAPES = {"mamba2 heads": (1, 512, 8, 64, 1, 128), "jamba heads": (1, 512, 8, 128, 1, 16),
          "groups, padded": (1, 300, 6, 64, 2, 128)}


def inputs(B, L, H, P, G, S, dtype, states, seed=0):
    """Seeded operands at the model's scales: dt = softplus(N(0, 1) - 2), A
    from -1 to -16 (the init's), x, B, C and dy unit normal."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=g) - 2)
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = (torch.randn(B, L, G, S, generator=g).to(dtype) for _ in range(2))
    dy = torch.randn(B, L, H, P, generator=g).to(dtype)
    h0, dhT = ((torch.randn(B, H, P, S, generator=g), torch.randn(B, H, P, S, generator=g))
               if states else (None, None))
    return (x, dt, A, Bm, Cm, dy, dhT), h0


def tolerance(name: str, dtype) -> float:
    return BF16_RTOL if dtype == torch.bfloat16 and name in ("dx", "dB", "dC") else F32_RTOL


@pytest.mark.parametrize("states", [False, True], ids=["no state", "state and dhT"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_arithmetic_is_within_half_the_card_tolerance(shape, dtype, states):
    ins, h0 = inputs(*SHAPES[shape], dtype, states)
    want = ssk.ssd_chunked_bwd_plain(*ins, chunk=256, initial_state=h0)
    emu = ssk.ssd_chunked_bwd_plain(*ins, chunk=ssk.CHUNK, initial_state=h0,
                                    precision=torch.float32)
    assert (emu[-1] is None) == (h0 is None)
    for name, g, w in zip(NAMES, emu, want):
        if w is None:
            continue
        assert g.dtype == w.dtype, name
        err = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert err <= tolerance(name, dtype) / 2, (name, err)


def _parts(v, n):
    """v as the sum of its first ``n`` bf16 parts (hi, mid, ...), in f32."""
    out, r = torch.zeros_like(v), v
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out, r = out + p, r - p
    return out


def _emulate(x, dt, A, B_, C, dy, dhT, h0, *, score_parts=2, state_parts=2):
    """A bf16 launch's arithmetic in f32 at the kernel's chunk: the score
    operands and the states h_in, dh_out in their bf16 parts; everything
    else as ``ssd_chunked_bwd_plain`` in f32."""
    f, chunk = torch.float32, ssk.CHUNK
    Bsz, L, H, P = x.shape
    G, S = B_.shape[2], B_.shape[3]
    rep = H // G
    pad = (-L) % chunk
    if pad:
        x, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B_, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (B_, C))
    Lp = L + pad
    nc = Lp // chunk
    xf, dyf = (t.to(f).reshape(Bsz, nc, chunk, H, P) for t in (x, dy))
    dtf = dt.to(f).reshape(Bsz, nc, chunk, H)
    Bf, Cf = (t.to(f).repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, S)
              for t in (B_, C))
    cum = torch.cumsum(dtf * A.to(f), dim=2)
    ct = cum.permute(0, 1, 3, 2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    decay = torch.exp((ct[..., :, None] - ct[..., None, :]).masked_fill(~tri, float("-inf")))
    e, w = torch.exp(cum), torch.exp(cum[:, :, -1:] - cum)
    last = torch.exp(ct[..., -1])
    states = torch.einsum("bnqhp,bnqhs->bnhps", xf * (dtf * w)[..., None], Bf)
    h = torch.zeros((Bsz, H, P, S)) if h0 is None else h0.to(f)
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = h * last[:, n, :, None, None] + states[:, n]
    h_in = torch.stack(h_in, 1)
    local = torch.einsum("bnqhp,bnqhs->bnhps", dyf * e[..., None], Cf)
    g = torch.zeros((Bsz, H, P, S)) if dhT is None else dhT.to(f)
    dh_out = [None] * nc
    for n in reversed(range(nc)):
        dh_out[n] = g
        g = g * last[:, n, :, None, None] + local[:, n]
    dh_out = torch.stack(dh_out, 1)
    dho, hin = _parts(dh_out, state_parts), _parts(h_in, state_parts)
    CBL = torch.einsum("bnthk,bnshk->bnhts", Cf, Bf) * decay
    dM = torch.einsum("bnthp,bnshp->bnhts", dyf, xf)
    dts = dtf.permute(0, 1, 3, 2)
    dMLdt = _parts(dM * decay * dts[..., None, :], score_parts)  # dB's and dC's operand
    Z = torch.einsum("bnshk,bnhpk->bnshp", Bf, dho)  # dh_out B_s
    dx = dtf[..., None] * (torch.einsum("bnhts,bnthp->bnshp", _parts(CBL, score_parts), dyf)
                           + w[..., None] * Z)
    R = torch.einsum("bnthp,bnhpk->bnthk", dyf, hin)  # dy_tᵀ h_in
    dC = torch.einsum("bnhts,bnshk->bnthk", dMLdt, Bf) + e[..., None] * R
    dB = (torch.einsum("bnhts,bnthk->bnshk", dMLdt, Cf)
          + (dtf * w)[..., None] * torch.einsum("bnshp,bnhpk->bnshk", xf, dho))
    v = w * (xf * Z).sum(-1)
    q = (CBL * dM).sum(-2)
    u = dts * v.permute(0, 1, 3, 2)
    yo = (e[..., None] * (Cf * R)).sum(-1).permute(0, 1, 3, 2)  # dy_t·y_off_t
    dcum = (CBL * dM * dts[..., None, :]).sum(-1) - dts * q + yo - u
    dcum[..., -1] += u.sum(-1) + last * (dh_out * h_in).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = q + v.permute(0, 1, 3, 2) + da * A.to(f)[:, None]

    def tokens(t):
        return t.reshape(Bsz, Lp, *t.shape[3:])[:, :L]

    def grouped(t):
        return tokens(t.reshape(Bsz, nc, chunk, G, rep, S).sum(4))

    return (tokens(dx).to(x.dtype), tokens(ddt.permute(0, 1, 3, 2)).contiguous(),
            (da * dts).sum((0, 1, 3)), grouped(dB).to(B_.dtype), grouped(dC).to(C.dtype),
            None if h0 is None else g)


def _rel_errs(got, want):
    """Each output's max|got - want| over max|want| over its half gate."""
    return {name: (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
            / (tolerance(name, torch.bfloat16) / 2)
            for name, g, w in zip(NAMES, got, want) if w is not None}


@pytest.mark.parametrize("states", [False, True], ids=["no state", "state and dhT"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tensor_core_parts_are_within_half_the_card_tolerance(shape, states):
    ins, h0 = inputs(*SHAPES[shape], torch.bfloat16, states)
    want = ssk.ssd_chunked_bwd_plain(*ins, chunk=256, initial_state=h0)
    errs = _rel_errs(_emulate(*ins, h0), want)
    assert set(errs) == set(NAMES) - ({"dh0"} if h0 is None else set())
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("fewer,broken", [("score_parts", ("dx", "dB", "dC")),
                                          ("state_parts", ("ddt",))],
                         ids=["one-part scores", "one-part states"])
def test_one_part_fewer_breaks_the_half_gate_at_mamba2_heads(fewer, broken):
    """One bf16 part for the scores (or for the states) at mamba2-1.3b's
    heads: the outputs they feed move past half their gate."""
    ins, h0 = inputs(*SHAPES["mamba2 heads"], torch.bfloat16, False)
    want = ssk.ssd_chunked_bwd_plain(*ins, chunk=256, initial_state=h0)
    errs = _rel_errs(_emulate(*ins, h0, **{fewer: 1}), want)
    assert all(errs[name] > 1.0 for name in broken), errs
    two = _rel_errs(_emulate(*ins, h0), want)
    assert all(two[name] <= 1.0 for name in broken), two
