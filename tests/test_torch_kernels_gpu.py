"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips (from inside its fixture) on a machine
without CUDA, so they run only where the kernels can.  The file imports
``torch`` and the port only (no JAX), so it also runs on a machine that has
no JAX:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

f32 is held at the CPU tests' atol 2e-5 with TF32 off; bf16 at atol 1e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402

F32_ATOL = 2e-5
BF16_ATOL = 1e-2


def _packed_inputs(segs, H, KV, hd, q_len, seed, align=16):
    """Packed q/k/v and index arrays for segments ``(matched, n_new)``, laid
    out as the engine lays them out (q padding pos -2^30 / seg -1, kv
    padding pos -1 / seg -2, each kv span at an ``align`` multiple)."""
    rng = np.random.default_rng(seed)
    spans = [-(-(m + n) // align) * align for m, n in segs]
    kv_len = sum(spans) + align
    q = rng.standard_normal((1, q_len, H, hd)).astype(np.float32)
    k = rng.standard_normal((1, kv_len, KV, hd)).astype(np.float32)
    v = rng.standard_normal((1, kv_len, KV, hd)).astype(np.float32)
    q_pos = np.full((1, q_len), -(2**30), np.int32)
    q_seg = np.full((1, q_len), -1, np.int32)
    kv_pos = np.full((1, kv_len), -1, np.int32)
    kv_seg = np.full((1, kv_len), -2, np.int32)
    qo = ko = 0
    for i, ((m, n), span) in enumerate(zip(segs, spans)):
        q_pos[0, qo:qo + n] = np.arange(m, m + n)
        q_seg[0, qo:qo + n] = i
        kv_pos[0, ko:ko + m + n] = np.arange(m + n)
        kv_seg[0, ko:ko + m + n] = i
        qo += n
        ko += span
    return dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg)


PACKED_CASES = [
    # (segments (matched, n_new), H, KV, hd, q_len, window)
    ([(0, 20), (0, 13)], 4, 4, 32, 40, None),
    ([(24, 9), (0, 17), (40, 6)], 4, 2, 64, 40, None),
    ([(8, 30), (0, 25)], 8, 2, 128, 64, 12),
    ([(16, 5)], 2, 1, 256, 8, None),
    ([(0, 300), (100, 150)], 4, 4, 128, 512, None),
]
DECODE_CASES = [
    # (B, L, H, KV, hd, window, with kv_valid)
    (2, 40, 4, 2, 32, None, False),
    (1, 17, 8, 1, 64, None, True),
    (3, 300, 6, 6, 128, 9, False),
    (2, 48, 4, 4, 256, 20, True),
    (4, 1024, 12, 2, 128, None, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels do not run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("segs,H,KV,hd,q_len,window", PACKED_CASES)
def test_packed_kernel_matches_plain_on_card(cuda, dtype, atol, segs, H, KV, hd, q_len, window):
    args = _packed_inputs(segs, H, KV, hd, q_len, seed=1)
    dt = getattr(torch, dtype)
    t = {n: torch.from_numpy(a).to(cuda) for n, a in args.items()}
    for n in ("q", "k", "v"):
        t[n] = t[n].to(dt)
    got = pk.packed_flash_attention(**t, window=window)
    want = pk.packed_flash_attention_plain(**t, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("B,L,H,KV,hd,window,valid", DECODE_CASES)
def test_decode_kernel_matches_plain_on_card(cuda, dtype, atol, B, L, H, KV, hd, window, valid):
    g = torch.Generator(device=cuda)
    g.manual_seed(B * L)
    dt = getattr(torch, dtype)
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
    pos = torch.randint(0, L, (B, 1), generator=g, device=cuda, dtype=torch.int32)
    idx = torch.arange(L, device=cuda, dtype=torch.int32)[None]
    kv_pos = torch.where(idx <= pos, idx, -1).to(torch.int32)
    kv_valid = torch.rand(B, L, generator=g, device=cuda) > 0.3 if valid else None
    got = dk.decode_attention(q, k, v, q_pos=pos, kv_pos=kv_pos, window=window,
                              kv_valid=kv_valid)
    want = dk.decode_attention_plain(q, k, v, q_pos=pos, kv_pos=kv_pos, window=window,
                                     kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.gpu
def test_wrappers_count_launches_and_refuse_what_they_cannot_run(cuda):
    """Each launch adds one to its wrapper's count; a CUDA tensor the kernel
    does not take raises instead of running the plain version."""
    args = {n: torch.from_numpy(a).to(cuda)
            for n, a in _packed_inputs([(0, 8)], 2, 2, 32, 8, seed=0).items()}
    before = pk.packed_flash_attention.launches
    pk.packed_flash_attention(**args)
    assert pk.packed_flash_attention.launches == before + 1
    with pytest.raises(ValueError, match="dtype"):
        pk.packed_flash_attention(**{**args, "q": args["q"].half(), "k": args["k"].half(),
                                     "v": args["v"].half()})
    with pytest.raises(ValueError, match="head_dim"):
        q = torch.zeros(1, 1, 2, 48, device=cuda)
        k = torch.zeros(1, 8, 2, 48, device=cuda)
        dk.decode_attention(q, k, k, q_pos=torch.zeros(1, 1, dtype=torch.int32, device=cuda),
                            kv_pos=torch.zeros(1, 8, dtype=torch.int32, device=cuda))
    assert pk.packed_flash_attention.launches == before + 1
