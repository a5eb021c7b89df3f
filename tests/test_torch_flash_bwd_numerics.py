"""The rounding of the bf16 flash-attention backward kernel, on the CPU.

``csrc/flash_backward.cu`` runs a bf16 launch's products on the tensor
cores: bf16 operands, exact bf16 x bf16 products summed in f32, and P and
dS (f32 values) entering their products as bf16 pairs hi = bf16(x), lo =
bf16(x - hi).  The card cannot run here, so this file writes that
arithmetic out in f32 (hi + lo of a bf16 pair is exact in f32; only the
order of the f32 sums differs from the kernel's) and holds it to the plain
backward (``flash_attention_bwd_plain``, f32 throughout) on the same bf16
inputs within half of the card's bf16 tolerance, 1e-2 of max|·|
(``chip_smoke.py``'s ``BF16_ATOL``): the other half is left for the card's
own sum order and its ``lse``.  The cases are the ``gpu`` tests' backward
shapes and qwen2-0.5b's heads at 1,024 rows, where the emulation is also
held to ``jax.grad`` of the reference's ``attention_ref``.  A single bf16 P
and dS (no lo half) is emulated beside it, and reads above that margin at
qwen2-0.5b's heads, which is why the kernel keeps the pairs.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_backward as fbk  # noqa: E402

torch.set_num_threads(1)
BF16_ATOL = 1e-2  # chip_smoke.py's: bf16 gradients against the plain backward
MARGIN = BF16_ATOL / 2
LOG2E = 1.4426950408889634

# (B, Sq, H, KV, hd, causal, window, masked kv rows, kv_valid), Sq as
# (Sq, Skv) for a suffix: tests/test_torch_kernels_gpu.py's BWD_CASES
GPU_CASES = [
    (2, 200, 14, 2, 64, True, None, False, False),
    (1, 130, 4, 4, 128, True, None, False, False),
    (2, 150, 12, 2, 128, True, 40, False, False),
    (1, 96, 4, 1, 16, True, None, True, False),
    (2, 70, 6, 6, 64, False, None, False, True),
    (1, 64, 8, 2, 80, True, None, False, False),
    (1, 33, 2, 1, 256, True, 10, False, False),
    (1, 700, 8, 2, 64, True, None, True, False),
    (1, 600, 6, 1, 128, True, 200, False, True),
    (1, 1000, 14, 2, 64, True, None, False, False),
    (2, (300, 700), 8, 2, 64, True, None, False, False),
    (1, 300, 48, 1, 128, True, None, False, False),
]
QWEN = (1, 1024, 14, 2, 64, True, None, False, False)  # qwen2-0.5b's heads


def _inputs(B, Sq, H, KV, hd, causal, window, masked, valid, seed=0):
    """bf16 q, k, v, dout from a numpy seed; the plain forward's bf16 output
    and f32 lse; the positions (queries the last Sq of Skv)."""
    Sq, Skv = Sq if isinstance(Sq, tuple) else (Sq, Sq)
    rng = np.random.default_rng(seed + Sq * H + hd)
    q, dout = (torch.from_numpy(rng.standard_normal((B, Sq, H, hd), np.float32))
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, KV, hd), np.float32))
            .to(torch.bfloat16) for _ in range(2))
    kv_pos = torch.arange(Skv, dtype=torch.int32)[None].repeat(B, 1)
    q_pos = kv_pos[:, Skv - Sq:].clone()  # kept apart from the masking below
    if masked:
        kv_pos[:, 5:20] = -1
    kv_valid = torch.from_numpy(rng.random((B, Skv)) > 0.3) if valid else None
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window, kv_valid=kv_valid)
    out, lse = fbk.flash_attention_fwd_plain(q, k, v, **kw)
    return (q, k, v, out, dout, lse), kw


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate(q, k, v, out, dout, lse, *, q_pos, kv_pos, causal, window, kv_valid,
             pairs=True):
    """The bf16 kernel's arithmetic in f32: P = 2^(S·scale·log2 e - lse·log2
    e) on kept pairs; P and dS as hi + lo bf16 pairs (``pairs``) or as one
    bf16 value; dK and dV per query head, summed over the group in head
    order; outputs cast to bf16."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    kept = fbk._mask(q_pos, kv_pos, causal, window, kv_valid)[:, None]  # [B, 1, Sq, Skv]
    kh = k.float().repeat_interleave(G, 2)  # [B, Skv, H, hd]: kv head h // G
    vh = v.float().repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kh)
    row_lse = lse.permute(0, 2, 1)[..., None]
    row_lse = torch.where(torch.isfinite(row_lse), row_lse, torch.zeros_like(row_lse))
    p = torch.where(kept, torch.exp2(s * (scale * LOG2E) - row_lse * LOG2E),
                    torch.zeros_like(s))
    d = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bshd->bhqs", dout.float(), vh)
    ds = p * (dp - d) * scale

    def operand(x):
        hi = _bf16(x)
        return hi + _bf16(x - hi) if pairs else hi

    p, ds = operand(p), operand(ds)
    dq = torch.einsum("bhqs,bshd->bqhd", ds, kh)
    dk_h = torch.einsum("bhqs,bqhd->bshd", ds, q.float())  # per query head
    dv_h = torch.einsum("bhqs,bqhd->bshd", p, dout.float())
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for g in range(G):  # the reduce's head order
        dk = dk + dk_h[:, :, g::G]
        dv = dv + dv_h[:, :, g::G]
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _errs(got, want):
    """max|got - want| over max|want|, per gradient (chip_smoke.py's bf16
    measure)."""
    return [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            for a, b in zip(got, want)]


@pytest.mark.parametrize("case", GPU_CASES + [QWEN], ids=lambda c: "-".join(map(str, c)))
def test_hi_lo_products_stay_within_half_the_bf16_tolerance(case):
    (q, k, v, out, dout, lse), kw = _inputs(*case)
    want = fbk.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    got = _emulate(q, k, v, out, dout, lse, **kw)
    errs = _errs(got, want)
    assert max(errs) <= MARGIN, errs
    assert all(math.isfinite(e) for e in errs)


def test_single_bf16_operands_leave_too_little_margin_at_qwen_heads():
    """One bf16 P and dS (no lo half) at qwen2-0.5b's heads: further from
    the plain backward than the pairs, by more than the pairs' whole error,
    and above a third of ``BF16_ATOL``."""
    (q, k, v, out, dout, lse), kw = _inputs(*QWEN)
    want = fbk.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    pair = max(_errs(_emulate(q, k, v, out, dout, lse, **kw), want))
    single = max(_errs(_emulate(q, k, v, out, dout, lse, **kw, pairs=False), want))
    assert single > 2 * pair and single > BF16_ATOL / 3, (single, pair)


def test_emulation_matches_jax_grad_of_reference_at_qwen_heads():
    """The emulated bf16 gradients against ``jax.grad`` of the reference's
    ``attention_ref`` (f32, on the same bf16-valued inputs)."""
    (q, k, v, out, dout, lse), kw = _inputs(*QWEN)
    got = _emulate(q, k, v, out, dout, lse, **kw)
    jpos = {n: jnp.asarray(kw[n].numpy()) for n in ("q_pos", "kv_pos")}
    g = jnp.asarray(dout.float().numpy())

    def f(q, k, v):
        o = jref.attention_ref(q, k, v, causal=True, window=None, kv_valid=None, **jpos)
        return jnp.sum(o * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    errs = _errs(got, [torch.from_numpy(np.array(w)) for w in want])
    assert max(errs) <= MARGIN, errs
