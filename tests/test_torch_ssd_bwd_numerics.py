"""The bf16 and f32 arithmetic of the SSD backward kernel, emulated on the
CPU, against its plain version.

``csrc/ssd_backward.cu`` runs the chunk equations of
``ssd_scan.ssd_chunked_bwd_plain`` over chunks of ``ssd_scan.CHUNK`` tokens
with every product in f32 on the CUDA cores, from bf16 or f32 inputs, and
rounds dx, dB and dC to the inputs' dtype; the states before the chunks
(bf16: the forward's tensor-core kernels with three-part operands) are f32
to ~2^-26.  ``ssd_chunked_bwd_plain(..., precision=torch.float32)`` at that
chunk is that arithmetic in another summation order.  These tests hold it
to the plain version (f64, at the model's chunk of 256) within half of the
tolerances that ``chip_smoke.py`` and the ``gpu`` tests hold the kernel to,
set here before the kernel first ran on the card:

  * an output in the inputs' bf16 (dx, dB, dC of a bf16 launch): max|k -
    p| <= 2^-7 max|p|, one bf16 step at the largest magnitude (both sides
    round their f32 or f64 sums to bf16: where the two sums straddle a
    rounding boundary they part by one step); the emulation reads <= 1.6e-3;
  * an f32 output (d dt, dA, dh0, and every output of an f32 launch):
    max|k - p| <= 1e-4 max|p|; the emulation reads <= 1.7e-5 (d dt, whose
    sums largely cancel), the others <= 1e-5.
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
