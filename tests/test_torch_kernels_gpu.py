"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips (from inside its fixture) on a machine
without CUDA, so they run only where the kernels can.  The file imports
``torch`` and the port only (no JAX), so it also runs on a machine that has
no JAX:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

f32 is held at the CPU tests' atol 2e-5 with TF32 off; bf16 at atol 1e-2.
Every kernel takes any head_dim up to 256: each is also held against its
plain version at head_dims 16, 80 and 96, which are not buckets of the
kernels' shared tiles, and the reduced llama-7b (head_dim 16) is served on
the card against the same engine on the CPU.  The two decode kernels split
each sequence's positions into fixed parts of ``PART`` and combine them in
part order: they are held across part boundaries, the paged kernel against
the dense one bit for bit, and a second launch against the first.  The int8 quantiser and
dequantiser are held bit for bit, not at a tolerance.  The SSD scan has
one rule, the one ``chip_smoke.py`` applies: each f32 output (y in the f32
runs, the final state in every run) is at most max(5e-5, the plain
version's error) away from the f64 sequential scan of the same inputs, 5e-5
being the reference's SSD atol; a bf16 y lies within one bf16 ulp (2^-7 of
the plain version's magnitude) plus 5e-5 of the plain version's, since
both round f32 sums of the same inputs to bf16.  The decode, flash and
SSD kernels are also held at jamba-1.5-large-398b's shapes, the prefill
kernels at granite-34b's 48 query heads on one kv head, and the flash
kernel non-causal at whisper-tiny's (hd 64, 1,500 rows; one query row and
1,500).  The reduced mamba2-1.3b, olmoe-1b-7b, jamba-1.5-large-398b,
granite-34b, internvl2-1b and whisper-tiny are served on the card against
the same engine on the CPU.  The SSD backward is held to its plain (f64)
backward within 2^-7 of each bf16 output's largest magnitude and 1e-4 of
each f32 output's, tolerances set from its arithmetic emulated on the CPU
(``tests/test_torch_ssd_bwd_numerics.py``); the reduced mamba2-1.3b,
jamba-1.5-large-398b and whisper-tiny train a step on the card as on the
CPU.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import chunked_prefill as cpk  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import fused_prefill as fuk  # noqa: E402
from repro_torch.kernels import kv_quant as kq  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402

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
    ([(0, 300), (100, 150)], 48, 1, 128, 512, None),  # granite-34b: 48 query heads on 1
]
DECODE_CASES = [
    # (B, L, H, KV, hd, window, with kv_valid)
    (2, 40, 4, 2, 32, None, False),
    (1, 17, 8, 1, 64, None, True),
    (3, 300, 6, 6, 128, 9, False),
    (2, 48, 4, 4, 256, 20, True),
    (4, 1024, 12, 2, 128, None, False),
    (4, 4096, 64, 8, 128, None, False),  # jamba-1.5-large-398b's attention layer
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
        q = torch.zeros(1, 1, 2, 257, device=cuda)
        k = torch.zeros(1, 8, 2, 257, device=cuda)
        dk.decode_attention(q, k, k, q_pos=torch.zeros(1, 1, dtype=torch.int32, device=cuda),
                            kv_pos=torch.zeros(1, 8, dtype=torch.int32, device=cuda))
    assert pk.packed_flash_attention.launches == before + 1


FLASH_CASES = [
    # (B, Sq, L, H, KV, hd, causal, window, offset, with kv_valid)
    (2, 24, 40, 4, 2, 32, True, None, 8, False),
    (1, 300, 1024, 8, 8, 128, True, None, 100, False),  # max_len cache, invalid tail
    (2, 70, 160, 8, 2, 64, True, 33, 20, False),
    (2, 40, 96, 4, 1, 256, False, None, 0, False),  # cross-attention
    (1, 64, 128, 6, 3, 128, True, None, 30, True),
    (1, 130, 256, 16, 2, 128, True, 50, 0, True),  # GQA 8:1, window and kv_valid
    # jamba-1.5-large-398b's attention layer (64 heads on 8, no RoPE): a
    # 2,032-token prefill, and a 32-token suffix after 2,000 stored rows
    (1, 2032, 4096, 64, 8, 128, True, None, 0, False),
    (1, 32, 4096, 64, 8, 128, True, None, 2000, False),
    # granite-34b's MQA (48 query heads on 1): a prefill after 100 stored rows
    (1, 300, 1024, 48, 1, 128, True, None, 100, False),
    # whisper-tiny (6 heads of 64, non-causal): the encoder over 1,500
    # frames, a prompt's and a decode step's cross-attention over them
    (1, 1500, 1500, 6, 6, 64, False, None, 0, False),
    (1, 24, 1500, 6, 6, 64, False, None, 0, False),
    (4, 1, 1500, 6, 6, 64, False, None, 0, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("B,Sq,L,H,KV,hd,causal,window,offset,valid", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, dtype, atol, B, Sq, L, H, KV, hd, causal,
                                            window, offset, valid):
    g = torch.Generator(device=cuda)
    g.manual_seed(Sq * L)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
    offs = offset + torch.arange(B, device=cuda, dtype=torch.int32)[:, None]
    q_pos = (offs + torch.arange(Sq, device=cuda, dtype=torch.int32)[None]).contiguous()
    idx = torch.arange(L, device=cuda, dtype=torch.int32)[None]
    kv_pos = torch.where(idx < offs + Sq, idx, -1).to(torch.int32).contiguous()
    if not causal:
        q_pos = torch.zeros_like(q_pos)
        kv_pos = idx.expand(B, L).contiguous()
    kv_valid = torch.rand(B, L, generator=g, device=cuda) > 0.3 if valid else None
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window, kv_valid=kv_valid)
    got = fk.flash_attention(q, k, v, **kw)
    want = fk.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol


# (B, W, offsets, S): a ring of W rows holding `offset` tokens (wrapped when
# offset > W), then S new tokens, as the sliding-window prefill lays them out
RING_FLASH_CASES = [
    (1, 256, (0,), 600),  # the first call: an empty ring, queries past W
    (2, 256, (700, 300), 90),  # wrapped rings, a suffix shorter than W
    (1, 512, (1300,), 700),  # a wrapped ring, a suffix longer than W
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("B,W,offsets,S", RING_FLASH_CASES)
def test_flash_kernel_over_a_wrapped_ring_matches_plain(cuda, dtype, atol, B, W, offsets, S):
    """The sliding-window prefill's launch: queries at ``offset + [0, S)``
    over ``[the ring ++ the new rows]`` at ``[_ring_positions(offset) ++
    positions]`` (not monotone along the rows once the ring wraps), within
    the window, at mixtral's heads (48 on 8 kv heads, hd 128)."""
    from repro_torch.models.attention import _ring_positions

    H, KV, hd = 48, 8, 128
    g = torch.Generator(device=cuda)
    g.manual_seed(W + S)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, W + S, KV, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, W + S, KV, hd, generator=g, device=cuda).to(dt)
    offset = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    q_pos = (offset[:, None] + torch.arange(S, dtype=torch.int32, device=cuda)[None]).contiguous()
    kv_pos = torch.cat([_ring_positions(offset, W, B), q_pos], dim=1).contiguous()
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=True, window=W)
    got = fk.flash_attention(q, k, v, **kw)
    want = fk.flash_attention_plain(q, k, v, **kw)
    again = fk.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("W,lengths", [(256, (700, 256, 100, 513)), (4096, (6100, 4097, 30, 8191))])
def test_decode_kernel_over_ring_positions_matches_plain(cuda, dtype, atol, W, lengths):
    """The sliding-window decode: each slot's query at ``length - 1`` over its
    ring of W rows at ``_ring_positions(length)``, within the window, at
    mixtral's heads (48 on 8 kv heads, hd 128)."""
    from repro_torch.models.attention import _ring_positions

    B, H, KV, hd = len(lengths), 48, 8, 128
    g = torch.Generator(device=cuda)
    g.manual_seed(W)
    dt = getattr(torch, dtype)
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, W, KV, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, W, KV, hd, generator=g, device=cuda).to(dt)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kv_pos = _ring_positions(length, W, B).contiguous()
    q_pos = (length - 1)[:, None].contiguous()
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=W)
    got = dk.decode_attention(q, k, v, **kw)
    want = dk.decode_attention_plain(q, k, v, **kw)
    again = dk.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert torch.equal(got, again)


def _pool(cuda, dt, lens, KV, H, hd, block, max_len, seed):
    """A pool whose live blocks are scattered at random, with the block
    tables and the equivalent dense cache of the same padded length."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    B, nb = len(lens), max_len // block
    n_blocks = 1 + B * nb
    k_pool = torch.randn(n_blocks * block, KV, hd, generator=g, device=cuda).to(dt)
    v_pool = torch.randn(n_blocks * block, KV, hd, generator=g, device=cuda).to(dt)
    order = (torch.randperm(n_blocks - 1, generator=g, device=cuda) + 1).tolist()
    tables = torch.zeros(B, nb, dtype=torch.int32)
    for b, L in enumerate(lens):
        for j in range(-(-L // block)):
            tables[b, j] = order.pop()
    tables = tables.to(cuda)
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dt)
    q_pos = torch.tensor([[max(L - 1, 0)] for L in lens], dtype=torch.int32, device=cuda)
    return q, k_pool, v_pool, tables, q_pos


PAGED_CASES = [
    # (live lengths (0 = freed slot), H, KV, hd, block, max_len, window)
    ([130, 257, 33], 4, 2, 32, 128, 384, None),
    ([5, 0, 97, 128], 8, 8, 64, 32, 128, None),  # a freed slot
    ([2050, 0, 2049, 0], 32, 32, 128, 128, 4096, None),  # the serve run's shape
    ([300, 17], 16, 2, 128, 64, 512, 100),  # GQA 8:1 and a window
    ([64, 200], 4, 4, 256, 16, 256, 40),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("lens,H,KV,hd,block,max_len,window", PAGED_CASES)
def test_paged_kernel_matches_plain_on_card(cuda, dtype, atol, lens, H, KV, hd, block,
                                            max_len, window):
    q, kp, vp, tables, q_pos = _pool(cuda, getattr(torch, dtype), lens, KV, H, hd, block,
                                     max_len, seed=len(lens) * hd)
    kw = dict(block_table=tables, q_pos=q_pos, block=block, window=window)
    got = pdk.paged_decode_attention(q, kp, vp, **kw)
    want = pdk.paged_decode_attention_plain(q, kp, vp, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    freed = [b for b, L in enumerate(lens) if L == 0]
    assert torch.equal(got[freed], want[freed])  # a freed slot reads the dump row only


def _dense_of(cuda, kp, vp, tables, q_pos, block):
    """The slotted cache holding the pool's rows of each table, row j at
    position j (rows past a sequence's query at -1), as the engine's dense
    cache holds them."""
    B, nb = tables.shape
    rows = (tables.long()[:, :, None] * block
            + torch.arange(block, device=cuda)[None, None]).reshape(B, nb * block)
    idx = torch.arange(nb * block, device=cuda, dtype=torch.int32)[None]
    kv_pos = torch.where(idx <= q_pos, idx, -1).to(torch.int32)
    return kp[rows].contiguous(), vp[rows].contiguous(), kv_pos


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("block,max_len,lens", [
    (32, 512, [300, 1, 511, 96]),
    (16, 1024, [257, 0, 1023, 512]),  # kept ranges across four parts, a freed slot
    (128, 1024, [900, 256, 129, 768]),
])
@pytest.mark.parametrize("window", [None, 70])
def test_paged_kernel_gives_the_dense_kernels_bits(cuda, window, block, max_len, lens, dtype):
    """Over the same rows the paged and dense decode kernels split the
    positions into the same parts and run the same code in each, so the
    paged kernel gives the dense kernel's output bit for bit."""
    q, kp, vp, tables, q_pos = _pool(cuda, getattr(torch, dtype), lens, 4, 8, 128, block,
                                     max_len, seed=7)
    k, v, kv_pos = _dense_of(cuda, kp, vp, tables, q_pos, block)
    assert dk.part_count(max_len) == pdk.part_count(max_len // block, block)
    dense = dk.decode_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)
    got = pdk.paged_decode_attention(q, kp, vp, block_table=tables, q_pos=q_pos, block=block,
                                     window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)


# --------------------------------------------------------------------------- #
# The decode kernels' split over fixed parts of PART positions
# --------------------------------------------------------------------------- #
P = dk.PART
SPLIT_CASES = [
    # (live lengths (0 = freed slot), H, KV, hd, block, max_len, window)
    ([P - 1, P, P + 1, 0], 8, 2, 128, 16, 3 * P, None),  # kept ranges of P-1, P, P+1 rows
    ([600, 1000], 6, 1, 128, 128, 1024, 300),  # windows that start mid-part, G 6
    ([700, 130, 1], 48, 1, 128, 96, 960, None),  # G 48; blocks of 96 straddle parts; L % P
    ([513, 40], 4, 4, 64, 16, 592, 100),  # G 1; L = 592 is no multiple of P
    ([300, 520], 8, 2, 256, 32, 544, None),  # hd 256
    ([P + 5, 3 * P + 10], 4, 4, 128, 128, 4 * P, 2 * P),  # a window wider than a part
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("lens,H,KV,hd,block,max_len,window", SPLIT_CASES)
def test_decode_kernels_split_at_fixed_parts(cuda, dtype, atol, lens, H, KV, hd, block,
                                             max_len, window):
    """Across part boundaries both decode kernels hold their plain versions,
    the paged kernel gives the dense kernel's bits over the same rows, and a
    second launch gives the first one's bits."""
    q, kp, vp, tables, q_pos = _pool(cuda, getattr(torch, dtype), lens, KV, H, hd, block,
                                     max_len, seed=sum(lens) + hd)
    k, v, kv_pos = _dense_of(cuda, kp, vp, tables, q_pos, block)
    pkw = dict(block_table=tables, q_pos=q_pos, block=block, window=window)
    dkw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window)
    paged = pdk.paged_decode_attention(q, kp, vp, **pkw)
    dense = dk.decode_attention(q, k, v, **dkw)
    paged_plain = pdk.paged_decode_attention_plain(q, kp, vp, **pkw)
    dense_plain = dk.decode_attention_plain(q, k, v, **dkw)
    again = (pdk.paged_decode_attention(q, kp, vp, **pkw), dk.decode_attention(q, k, v, **dkw))
    torch.cuda.synchronize()
    assert (paged.float() - paged_plain.float()).abs().max().item() <= atol
    assert (dense.float() - dense_plain.float()).abs().max().item() <= atol
    assert torch.equal(paged, dense)
    assert torch.equal(again[0], paged) and torch.equal(again[1], dense)
    freed = [b for b, L in enumerate(lens) if L == 0]
    assert torch.equal(paged[freed], paged_plain[freed])  # the dump block's row 0 alone


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_decode_kernel_parts_with_no_kept_row(cuda, dtype, atol):
    """A dense slot whose kv_pos is all -1 outputs zeros, and kv_valid holes
    that cover a whole part (and a part past the query) leave neutral
    partials that the combine skips."""
    g = torch.Generator(device=cuda)
    g.manual_seed(23)
    dt = getattr(torch, dtype)
    B, L, H, KV, hd = 3, 3 * P + 100, 8, 2, 128
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
    q_pos = torch.tensor([[L - 1], [5], [2 * P + 7]], dtype=torch.int32, device=cuda)
    idx = torch.arange(L, device=cuda, dtype=torch.int32)[None]
    kv_pos = torch.where(idx <= q_pos, idx, -1).to(torch.int32)
    kv_pos[1] = -1  # an idle slot: no row written
    kv_valid = torch.rand(B, L, generator=g, device=cuda) > 0.3
    kv_valid[0, P:2 * P] = False  # a whole part of holes
    kv_valid[2, :P] = False
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid)
    got = dk.decode_attention(q, k, v, **kw)
    want = dk.decode_attention_plain(q, k, v, **kw)
    again = dk.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert dk.part_count(L) == 4
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert not got[1].any() and torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("H,KV,window", [(12, 1, None), (48, 1, None), (48, 1, 70), (24, 2, 70)])
def test_decode_kernels_take_more_than_eight_heads_per_kv_head(cuda, dtype, atol, H, KV,
                                                               window):
    """A kv head with more than 8 query heads (granite-34b: 48 on one) is
    split over tiles of 8 heads: the dense and paged decode kernels hold
    their plain versions, and the paged kernel gives the dense kernel's
    bits over the same rows."""
    block, max_len, lens = 32, 512, [300, 1, 511, 96]
    q, kp, vp, tables, q_pos = _pool(cuda, getattr(torch, dtype), lens, KV, H, 128, block,
                                     max_len, seed=H)
    rows = (tables.long()[:, :, None] * block
            + torch.arange(block, device=cuda)[None, None]).reshape(len(lens), max_len)
    k, v = kp[rows].contiguous(), vp[rows].contiguous()
    idx = torch.arange(max_len, device=cuda, dtype=torch.int32)[None]
    kv_pos = torch.where(idx <= q_pos, idx, -1).to(torch.int32)
    dense = dk.decode_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)
    dense_plain = dk.decode_attention_plain(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                            window=window)
    kw = dict(block_table=tables, q_pos=q_pos, block=block, window=window)
    got = pdk.paged_decode_attention(q, kp, vp, **kw)
    want = pdk.paged_decode_attention_plain(q, kp, vp, **kw)
    torch.cuda.synchronize()
    assert (dense.float() - dense_plain.float()).abs().max().item() <= atol
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert torch.equal(got, dense)


@pytest.mark.gpu
def test_new_wrappers_count_launches_and_refuse_what_they_cannot_run(cuda):
    """The flash and paged decode wrappers count each launch and raise on a
    CUDA tensor their kernel does not take."""
    q, kp, vp, tables, q_pos = _pool(cuda, torch.float32, [40], 2, 4, 32, 16, 64, seed=1)
    before = (fk.flash_attention.launches, pdk.paged_decode_attention.launches)
    pdk.paged_decode_attention(q, kp, vp, block_table=tables, q_pos=q_pos, block=16)
    k = kp[None, :64].contiguous()
    pos = torch.arange(64, device=cuda, dtype=torch.int32)[None]
    fk.flash_attention(q.expand(1, 1, 4, 32).contiguous(), k, k, q_pos=pos[:, :1], kv_pos=pos)
    assert (fk.flash_attention.launches, pdk.paged_decode_attention.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="block"):
        pdk.paged_decode_attention(q, kp[:-1], vp[:-1], block_table=tables, q_pos=q_pos,
                                   block=16)
    with pytest.raises(ValueError, match="not a multiple of KV"):
        pdk.paged_decode_attention(q[:, :, :3].contiguous(), kp, vp, block_table=tables,
                                   q_pos=q_pos, block=16)
    with pytest.raises(ValueError, match="int32"):
        fk.flash_attention(q[:, :, :4], k, k, q_pos=pos[:, :1].long(), kv_pos=pos)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention(q[:, :, :4], k.transpose(2, 3).contiguous().transpose(2, 3), k,
                           q_pos=pos[:, :1], kv_pos=pos)
    assert (fk.flash_attention.launches, pdk.paged_decode_attention.launches) == (
        before[0] + 1, before[1] + 1)


def _chunked(cuda, dt, rows, KV, H, hd, block, max_len, C, seed):
    """A pool with each row's blocks scattered at random and a mixed batch
    of queries: row ``(n_landed, n_chunk)`` holds ``n_landed`` live rows, the
    last ``n_chunk`` of them this launch's queries (1 = a decode row, 0 = an
    idle row, all padding at -2^30).  Table padding points at the dump
    block 0."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    B, nb = len(rows), max_len // block
    n_blocks = 1 + B * nb
    k_pool = torch.randn(n_blocks * block, KV, hd, generator=g, device=cuda).to(dt)
    v_pool = torch.randn(n_blocks * block, KV, hd, generator=g, device=cuda).to(dt)
    order = (torch.randperm(n_blocks - 1, generator=g, device=cuda) + 1).tolist()
    tables = torch.zeros(B, nb, dtype=torch.int32)
    q_pos = torch.full((B, C), -(2**30), dtype=torch.int32)
    for b, (n_landed, n_chunk) in enumerate(rows):
        for j in range(-(-n_landed // block)):
            tables[b, j] = order.pop()
        q_pos[b, :n_chunk] = torch.arange(n_landed - n_chunk, n_landed, dtype=torch.int32)
    q = torch.randn(B, C, H, hd, generator=g, device=cuda).to(dt)
    return q, k_pool, v_pool, tables.to(cuda), q_pos.to(cuda)


CHUNKED_CASES = [
    # (rows (n_landed, n_chunk), H, KV, hd, block, max_len, C, window)
    ([(97, 32), (128, 1), (0, 0), (40, 8)], 4, 2, 32, 32, 128, 32, None),
    ([(130, 64), (257, 1), (0, 0), (384, 128)], 8, 8, 64, 128, 384, 128, None),
    ([(300, 16), (17, 1)], 16, 2, 128, 64, 512, 16, 100),  # GQA 8:1 and a window
    ([(200, 1), (64, 1), (1, 1)], 4, 4, 256, 16, 256, 1, 40),  # C = 1: decode rows only
    ([(100, 100), (0, 0)], 4, 1, 128, 48, 192, 128, 30),  # MQA, a 48-row block
    ([(300, 16), (129, 1), (0, 0)], 48, 1, 128, 64, 512, 16, 100),  # granite-34b's G = 48
    ([(90, 1), (33, 33)], 24, 2, 64, 32, 128, 64, None),  # G = 12
    # the unified serve run's shape: two chunks, a decode row and an idle row
    ([(2032, 128), (2050, 1), (0, 0), (1700, 128)], 32, 32, 128, 128, 4096, 128, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("rows,H,KV,hd,block,max_len,C,window", CHUNKED_CASES)
def test_chunked_kernel_matches_plain_on_card(cuda, dtype, atol, rows, H, KV, hd, block,
                                              max_len, C, window):
    q, kp, vp, tables, q_pos = _chunked(cuda, getattr(torch, dtype), rows, KV, H, hd, block,
                                        max_len, C, seed=len(rows) * hd + C)
    kw = dict(block_table=tables, q_pos=q_pos, block=block, window=window)
    got = cpk.chunked_prefill_attention(q, kp, vp, **kw)
    want = cpk.chunked_prefill_attention_plain(q, kp, vp, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    pad = q_pos < 0  # padding queries, idle rows among them, output zeros
    assert not got[pad].any()


@pytest.mark.gpu
def test_chunked_wrapper_counts_launches_and_refuses_what_it_cannot_run(cuda):
    q, kp, vp, tables, q_pos = _chunked(cuda, torch.float32, [(40, 8)], 2, 4, 32, 16, 64, 8,
                                        seed=1)
    before = cpk.chunked_prefill_attention.launches
    cpk.chunked_prefill_attention(q, kp, vp, block_table=tables, q_pos=q_pos, block=16)
    assert cpk.chunked_prefill_attention.launches == before + 1
    with pytest.raises(ValueError, match="block"):
        cpk.chunked_prefill_attention(q, kp[:-1], vp[:-1], block_table=tables, q_pos=q_pos,
                                      block=16)
    with pytest.raises(ValueError, match="q_pos shape"):
        cpk.chunked_prefill_attention(q, kp, vp, block_table=tables, q_pos=q_pos[:, :1],
                                      block=16)
    with pytest.raises(ValueError, match="int32"):
        cpk.chunked_prefill_attention(q, kp, vp, block_table=tables.long(), q_pos=q_pos,
                                      block=16)
    assert cpk.chunked_prefill_attention.launches == before + 1


_TRAP = """
import torch
from repro_torch.kernels import chunked_prefill as cpk
dev = torch.device("cuda")
pool = torch.zeros(4 * 16, 2, 32, device=dev)
q = torch.zeros(1, 4, 2, 32, device=dev)
table = torch.tensor([[1, 7]], dtype=torch.int32, device=dev)  # block 7 is past the pool
q_pos = torch.arange(16, 20, dtype=torch.int32, device=dev)[None]
cpk.chunked_prefill_attention(q, pool, pool, block_table=table, q_pos=q_pos, block=16)
try:
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("trapped:", exc)
    raise SystemExit(3)
print("no trap")
"""


@pytest.mark.gpu
def test_chunked_kernel_traps_on_a_block_outside_the_pool(cuda):
    """A table entry that a valid query reaches but that names no pool block
    stops the kernel (a trap kills the CUDA context, so in a child process)."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, "-c", _TRAP], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3 and "trapped" in proc.stdout, (proc.stdout, proc.stderr)


_TRAP_BF16 = _TRAP.replace("device=dev)\nq", "device=dev, dtype=torch.bfloat16)\nq").replace(
    "q = torch.zeros(1, 4, 2, 32, device=dev)", "q = torch.zeros(1, 4, 2, 32, device=dev).bfloat16()")


@pytest.mark.gpu
def test_chunked_bf16_kernel_traps_on_a_block_outside_the_pool(cuda):
    """The tensor-core tile (bf16) traps on the same table entry as the
    CUDA-core one."""
    assert _TRAP_BF16.count("bfloat16") == 2
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, "-c", _TRAP_BF16], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3 and "trapped" in proc.stdout, (proc.stdout, proc.stderr)


# The bf16 launches run on the tensor-core tile of csrc/flash_mma.cuh, which
# splits the kv tiles into S parts (at most 8) by the kv length alone.
MAX_SPLITS = 8
MMA_CHUNKED_CASES = [
    # (rows (n_landed, n_chunk), H, KV, hd, block, max_len, C, window)
    # a long context (4,096 table rows in a pool of 8,320): S is its largest
    ([(4000, 64), (3500, 1)], 8, 2, 128, 128, 4096, 64, None),
    # blocks of 16 and of 48 rows: a 64-row kv tile straddles pool blocks
    ([(150, 40), (97, 1), (0, 0)], 8, 2, 64, 16, 256, 64, None),
    ([(200, 70), (130, 1)], 8, 4, 128, 48, 288, 128, 90),
    # every valid query of a tile in the first warp's 16 rows
    ([(77, 12), (33, 1)], 4, 2, 64, 32, 128, 64, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("rows,H,KV,hd,block,max_len,C,window", MMA_CHUNKED_CASES)
def test_chunked_kernel_matches_plain_across_blocks_warps_and_splits(
        cuda, dtype, atol, rows, H, KV, hd, block, max_len, C, window):
    q, kp, vp, tables, q_pos = _chunked(cuda, getattr(torch, dtype), rows, KV, H, hd, block,
                                        max_len, C, seed=len(rows) * hd + C + block)
    kw = dict(block_table=tables, q_pos=q_pos, block=block, window=window)
    got = cpk.chunked_prefill_attention(q, kp, vp, **kw)
    want = cpk.chunked_prefill_attention_plain(q, kp, vp, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert not got[q_pos < 0].any()
    if dtype == "bfloat16" and rows[0][0] == 4000:
        assert cpk.split_count(q, tables, block) == MAX_SPLITS


# --------------------------------------------------------------------------- #
# fused_flash_attention (selective-recompute prefill over an assembled buffer)
# --------------------------------------------------------------------------- #
def _fused(cuda, dt, B, Sq, Skv, total, n_q, H, KV, hd, seed):
    """Random q/k/v of a fused launch: each sequence's ``n_q`` recompute
    queries at sorted random positions of ``[0, total)`` (every position
    when ``n_q == total``), padded to ``Sq`` with -2^30; kv rows at positions
    ``0..total-1`` and -1 past ``total``."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dt)
    v = torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dt)
    q_pos = torch.full((B, Sq), -(2**30), dtype=torch.int32)
    for b in range(B):
        pos = torch.randperm(total, generator=torch.Generator().manual_seed(seed + b))[:n_q]
        q_pos[b, :n_q] = pos.sort().values.to(torch.int32)
    idx = torch.arange(Skv, dtype=torch.int32)[None].expand(B, Skv)
    kv_pos = torch.where(idx < total, idx, -1).to(torch.int32)
    return q, k, v, q_pos.to(cuda), kv_pos.contiguous().to(cuda)


FUSED_CASES = [
    # (B, Sq, Skv, total, n_q, H, KV, hd, window)
    (1, 40, 40, 40, 40, 4, 4, 32, None),  # every position: plain causal attention
    (1, 40, 40, 40, 40, 4, 2, 64, 24),
    (1, 140, 384, 300, 140, 4, 4, 128, None),  # gappy queries over several tiles
    (1, 140, 384, 300, 140, 8, 2, 64, None),
    (1, 140, 384, 300, 140, 4, 2, 256, 96),
    (2, 160, 256, 200, 100, 8, 1, 128, None),  # padding: the last tile holds none valid
    # the fused serve's shape: 575 recompute queries in a 1,024 bucket over
    # 2,080 valid rows of a 4,096-row buffer
    (1, 1024, 4096, 2080, 575, 32, 32, 128, None),
    (1, 140, 384, 300, 140, 48, 1, 128, None),  # granite-34b: 48 query heads on 1
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("B,Sq,Skv,total,n_q,H,KV,hd,window", FUSED_CASES)
def test_fused_kernel_matches_plain_on_card(cuda, dtype, atol, B, Sq, Skv, total, n_q, H, KV,
                                            hd, window):
    """The fused kernel holds its plain version; with a query at every
    position it is plain causal attention; padding queries output zeros."""
    q, k, v, q_pos, kv_pos = _fused(cuda, getattr(torch, dtype), B, Sq, Skv, total, n_q, H,
                                    KV, hd, seed=Sq + hd)
    got = fuk.fused_flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)
    want = fuk.fused_flash_attention_plain(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert not got[q_pos < 0].any()
    if n_q == total == Sq:
        causal = fk.flash_attention_plain(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)
        assert (got.float() - causal.float()).abs().max().item() <= atol


@pytest.mark.gpu
def test_fused_wrapper_counts_launches_and_refuses_what_it_cannot_run(cuda):
    q, k, v, q_pos, kv_pos = _fused(cuda, torch.float32, 1, 16, 32, 24, 8, 4, 2, 32, seed=1)
    before = fuk.fused_flash_attention.launches
    fuk.fused_flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert fuk.fused_flash_attention.launches == before + 1
    with pytest.raises(ValueError, match="CUDA tensor"):
        fuk.fused_flash_attention(q.cpu(), k.cpu(), v.cpu(), q_pos=q_pos.cpu(),
                                  kv_pos=kv_pos.cpu())
    with pytest.raises(ValueError, match="int32"):
        fuk.fused_flash_attention(q, k, v, q_pos=q_pos.long(), kv_pos=kv_pos)
    with pytest.raises(ValueError, match="dtype"):
        fuk.fused_flash_attention(q.half(), k.half(), v.half(), q_pos=q_pos, kv_pos=kv_pos)
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros(1, 16, 4, 300, device=cuda)
        kv = torch.zeros(1, 32, 2, 300, device=cuda)
        fuk.fused_flash_attention(wide, kv, kv, q_pos=q_pos, kv_pos=kv_pos)
    assert fuk.fused_flash_attention.launches == before + 1


MMA_FUSED_CASES = [
    # (B, Sq, Skv, total, n_q, H, KV, hd, window)
    (1, 200, 512, 480, 150, 8, 4, 128, None),  # padding from query 150: mid-tile, mid-warp
    (2, 96, 320, 300, 70, 4, 1, 64, 50),  # padding from query 70, MQA and a window
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("B,Sq,Skv,total,n_q,H,KV,hd,window", MMA_FUSED_CASES)
def test_fused_kernel_matches_plain_with_padding_from_mid_tile(cuda, dtype, atol, B, Sq, Skv,
                                                               total, n_q, H, KV, hd, window):
    q, k, v, q_pos, kv_pos = _fused(cuda, getattr(torch, dtype), B, Sq, Skv, total, n_q, H,
                                    KV, hd, seed=Sq + hd + 1)
    got = fuk.fused_flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)
    want = fuk.fused_flash_attention_plain(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert not got[q_pos < 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_fused_kernel_matches_plain_with_valid_queries_in_one_warp(cuda, dtype, atol):
    """The 16 valid queries of a 64-query tile sit in the third warp's rows
    (32-47), padding all around them: the other warps skip their products."""
    q, k, v, q_pos, kv_pos = _fused(cuda, getattr(torch, dtype), 1, 64, 256, 200, 16, 4, 2,
                                    128, seed=7)
    pos = q_pos[0, :16].clone()
    q_pos[0] = -(2**30)
    q_pos[0, 32:48] = pos
    got = fuk.fused_flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    want = fuk.fused_flash_attention_plain(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert not got[q_pos < 0].any() and got[0, 32:48].any()


def _recorded(cuda, kernel, dt):
    """One launch's inputs at the serve shapes ``chip_smoke.py`` records: the
    unified step's chunked launch (a decode row over 2,050 rows, a 128-token
    chunk ending at 640, two idle rows; llama-7b's 32 heads, hd 128), a
    fused admission (575 recompute queries in a 1,024 bucket over 2,080
    valid rows of a 4,096-row buffer), a packed batch (two 2,032-token
    segments in 4,096 rows) and a per-request prefill (2,032 queries into a
    4,096-row cache).  Returns (call, split count, q_pos)."""
    if kernel == "chunked":
        q, kp, vp, tables, q_pos = _chunked(cuda, dt, [(2050, 1), (640, 128), (0, 0), (0, 0)],
                                            32, 32, 128, 128, 4096, 128, seed=11)
        return (lambda: cpk.chunked_prefill_attention(q, kp, vp, block_table=tables,
                                                      q_pos=q_pos, block=128),
                lambda: cpk.split_count(q, tables, 128), q_pos)
    if kernel == "packed":
        args = _packed_inputs([(0, 2032), (0, 2032)], 32, 32, 128, 4096, seed=11)
        t = {n: torch.from_numpy(a).to(cuda) for n, a in args.items()}
        for n in ("q", "k", "v"):
            t[n] = t[n].to(dt)
        return (lambda: pk.packed_flash_attention(**t),
                lambda: pk.split_count(t["q"], t["k"]), t["q_pos"])
    if kernel == "flash":
        g = torch.Generator(device=cuda)
        g.manual_seed(11)
        q = torch.randn(1, 2032, 32, 128, generator=g, device=cuda).to(dt)
        k = torch.randn(1, 4096, 32, 128, generator=g, device=cuda).to(dt)
        v = torch.randn(1, 4096, 32, 128, generator=g, device=cuda).to(dt)
        q_pos = torch.arange(2032, device=cuda, dtype=torch.int32)[None]
        idx = torch.arange(4096, device=cuda, dtype=torch.int32)[None]
        kv_pos = torch.where(idx < 2032, idx, -1).to(torch.int32)
        return (lambda: fk.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos),
                lambda: fk.split_count(q, k), q_pos)
    q, k, v, q_pos, kv_pos = _fused(cuda, dt, 1, 1024, 4096, 2080, 575, 32, 32, 128, seed=11)
    return (lambda: fuk.fused_flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos),
            lambda: fuk.split_count(q, k), q_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["chunked", "fused", "packed", "flash"])
def test_kernels_give_the_same_bits_on_every_launch(cuda, kernel, dtype):
    """No atomics enter a sum: two launches on the same inputs agree bit for
    bit, the split's combine included."""
    call, _, _ = _recorded(cuda, kernel, getattr(torch, dtype))
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,window", [(128, None), (128, 200), (64, None), (256, 150)])
def test_bf16_prefill_kernels_give_one_sequence_the_same_bits(cuda, hd, window):
    """The bf16 tile splits the kv tiles at fixed tiles and computes each
    query from its own row only, so one sequence's prefill gives the same
    bits through the per-request (flash), packed, chunked (the unified step's
    128-token chunks through a scattered block table) and fused kernels: a
    serve's logits do not depend on which of them it ran."""
    L, M, H, KV, block, C = 600, 1024, 4, 2, 128, 128
    dt = torch.bfloat16
    g = torch.Generator(device=cuda)
    g.manual_seed(hd)
    q = torch.randn(1, L, H, hd, generator=g, device=cuda).to(dt)
    k = torch.zeros(1, M, KV, hd, device=cuda, dtype=dt)
    v = torch.zeros(1, M, KV, hd, device=cuda, dtype=dt)
    k[:, :L] = torch.randn(1, L, KV, hd, generator=g, device=cuda).to(dt)
    v[:, :L] = torch.randn(1, L, KV, hd, generator=g, device=cuda).to(dt)
    pos = torch.arange(L, device=cuda, dtype=torch.int32)[None]
    idx = torch.arange(M, device=cuda, dtype=torch.int32)[None]
    kv_pos = torch.where(idx < L, idx, -1).to(torch.int32)
    flash = fk.flash_attention(q, k, v, q_pos=pos, kv_pos=kv_pos, window=window)
    packed = pk.packed_flash_attention(
        q, k, v, q_pos=pos, kv_pos=kv_pos, q_seg=torch.zeros_like(pos),
        kv_seg=torch.where(idx < L, 0, -1).to(torch.int32), window=window)
    fused = fuk.fused_flash_attention(q, k, v, q_pos=pos, kv_pos=kv_pos, window=window)
    # the pool: the sequence's blocks scattered, one batch row per 128-token chunk
    nb = M // block
    order = torch.randperm(2 * nb, generator=torch.Generator().manual_seed(hd)) + 1
    table = order[:nb].to(torch.int32)
    rows = (table.long()[:, None] * block + torch.arange(block)[None]).reshape(-1).to(cuda)
    k_pool = torch.zeros((2 * nb + 1) * block, KV, hd, device=cuda, dtype=dt)
    v_pool = torch.zeros_like(k_pool)
    k_pool[rows], v_pool[rows] = k[0], v[0]
    n_chunks = -(-L // C)
    q_chunks = torch.zeros(n_chunks, C, H, hd, device=cuda, dtype=dt)
    q_pos = torch.full((n_chunks, C), -(2**30), dtype=torch.int32, device=cuda)
    for c in range(n_chunks):
        n = min(C, L - c * C)
        q_chunks[c, :n] = q[0, c * C:c * C + n]
        q_pos[c, :n] = pos[0, c * C:c * C + n]
    chunked = cpk.chunked_prefill_attention(
        q_chunks, k_pool, v_pool, block_table=table[None].expand(n_chunks, nb).contiguous().to(
            cuda), q_pos=q_pos, block=block, window=window)
    chunked = chunked.reshape(1, n_chunks * C, H, hd)[:, :L]
    torch.cuda.synchronize()
    splits = {fk.split_count(q, k), pk.split_count(q, k), fuk.split_count(q, k),
              cpk.split_count(q_chunks, table[None], block)}
    assert len(splits) == 1 and splits.pop() > 1
    want = fk.flash_attention_plain(q, k, v, q_pos=pos, kv_pos=kv_pos, window=window)
    assert (flash.float() - want.float()).abs().max().item() <= BF16_ATOL
    assert torch.equal(packed, flash) and torch.equal(fused, flash)
    assert torch.equal(chunked, flash)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["chunked", "fused"])
def test_split_bf16_launch_writes_exact_zeros_for_padding(cuda, kernel):
    """With S > 1 the combine writes the padding queries' rows of a chunked
    or fused launch: exact zeros, over a buffer that held other values
    before."""
    call, splits, q_pos = _recorded(cuda, kernel, torch.bfloat16)
    assert splits() > 1
    call()  # leave non-zero values in the memory the next output may reuse
    got = call()
    torch.cuda.synchronize()
    assert not got[q_pos < 0].any() and got[q_pos >= 0].any()


# --------------------------------------------------------------------------- #
# Any head_dim up to 256, on every kernel
# --------------------------------------------------------------------------- #
def _any_hd_case(cuda, kernel, hd, dt):
    """One call of ``kernel`` at head_dim ``hd``: (the kernel's output, its
    plain version's output, the padding queries' mask or None)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(hd)
    if kernel == "packed":
        args = _packed_inputs([(24, 9), (0, 17), (40, 6)], 4, 2, hd, 40, seed=hd)
        t = {n: torch.from_numpy(a).to(cuda) for n, a in args.items()}
        for n in ("q", "k", "v"):
            t[n] = t[n].to(dt)
        return (pk.packed_flash_attention(**t), pk.packed_flash_attention_plain(**t),
                t["q_seg"] < 0)
    if kernel in ("decode", "flash"):
        B, Sq, L, H, KV = (3, 1, 300, 8, 2) if kernel == "decode" else (2, 70, 160, 8, 2)
        q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
        k = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
        v = torch.randn(B, L, KV, hd, generator=g, device=cuda).to(dt)
        offs = torch.tensor([[20], [L - Sq], [7]][:B], dtype=torch.int32, device=cuda)
        q_pos = (offs + torch.arange(Sq, device=cuda, dtype=torch.int32)[None]).contiguous()
        idx = torch.arange(L, device=cuda, dtype=torch.int32)[None]
        kw = dict(q_pos=q_pos, kv_pos=torch.where(idx < offs + Sq, idx, -1).to(torch.int32),
                  window=33)
        if kernel == "decode":
            return (dk.decode_attention(q, k, v, **kw), dk.decode_attention_plain(q, k, v, **kw),
                    None)
        return fk.flash_attention(q, k, v, **kw), fk.flash_attention_plain(q, k, v, **kw), None
    if kernel == "paged":
        q, kp, vp, tables, q_pos = _pool(cuda, dt, [130, 0, 257], 2, 8, hd, 32, 384, seed=hd)
        kw = dict(block_table=tables, q_pos=q_pos, block=32, window=100)
        return (pdk.paged_decode_attention(q, kp, vp, **kw),
                pdk.paged_decode_attention_plain(q, kp, vp, **kw), None)
    if kernel == "chunked":
        q, kp, vp, tables, q_pos = _chunked(cuda, dt, [(97, 32), (128, 1), (0, 0), (40, 8)], 2,
                                            4, hd, 32, 128, 32, seed=hd)
        kw = dict(block_table=tables, q_pos=q_pos, block=32)
        return (cpk.chunked_prefill_attention(q, kp, vp, **kw),
                cpk.chunked_prefill_attention_plain(q, kp, vp, **kw), q_pos < 0)
    q, k, v, q_pos, kv_pos = _fused(cuda, dt, 2, 160, 256, 200, 100, 8, 2, hd, seed=hd)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=64)
    return (fuk.fused_flash_attention(q, k, v, **kw),
            fuk.fused_flash_attention_plain(q, k, v, **kw), q_pos < 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("hd", [16, 80, 96])
@pytest.mark.parametrize("kernel", ["packed", "decode", "flash", "paged", "chunked", "fused"])
def test_kernels_take_any_head_dim(cuda, kernel, hd, dtype, atol):
    """At a head_dim that is not a bucket of the shared tiles each kernel
    runs on the next bucket's instantiation and holds its plain version;
    padding queries still output zeros."""
    got, want, pad = _any_hd_case(cuda, kernel, hd, getattr(torch, dtype))
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.shape[-1] == hd
    assert (got.float() - want.float()).abs().max().item() <= atol
    if pad is not None:
        assert not got[pad].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("hd", [1, 20, 100, 250])
@pytest.mark.parametrize("kernel", ["packed", "flash", "chunked", "fused"])
def test_prefill_kernels_take_head_dims_off_the_16_byte_rows(cuda, kernel, hd, dtype, atol):
    """A head_dim that is not a multiple of 8 makes rows that are not 16-byte
    aligned: the tensor-core tile (bf16) copies them element by element."""
    got, want, pad = _any_hd_case(cuda, kernel, hd, getattr(torch, dtype))
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.shape[-1] == hd
    assert (got.float() - want.float()).abs().max().item() <= atol
    if pad is not None:
        assert not got[pad].any()


@pytest.mark.gpu
@pytest.mark.parametrize("max_len,lens", [(512, [300, 1, 511, 96]), (768, [300, 1, 767, 96])],
                         ids=["two_parts", "three_parts"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [16, 80, 96, 1, 20, 100])
def test_paged_kernel_gives_the_dense_kernels_bits_at_any_head_dim(cuda, hd, dtype, max_len,
                                                                   lens):
    """Also for rows that are not 16-byte multiples (hd 1, 20, 100 in bf16),
    which both kernels copy element by element, over two and three parts."""
    block = 32
    q, kp, vp, tables, q_pos = _pool(cuda, getattr(torch, dtype), lens, 2, 8, hd, block,
                                     max_len, seed=hd)
    k, v, kv_pos = _dense_of(cuda, kp, vp, tables, q_pos, block)
    dense = dk.decode_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    got = pdk.paged_decode_attention(q, kp, vp, block_table=tables, q_pos=q_pos, block=block)
    want = pdk.paged_decode_attention_plain(q, kp, vp, block_table=tables, q_pos=q_pos,
                                            block=block)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    assert (got.float() - want.float()).abs().max().item() <= atol


# --------------------------------------------------------------------------- #
# Int8 KV quantisation: bit for bit
# --------------------------------------------------------------------------- #
# leading shapes: 8 rows (one block), 111 rows (not a multiple of the 8 rows
# a block takes), and a stored context's [layers, 1, tokens, kv heads]
QUANT_LEAD = [(8,), (3, 37), (2, 1, 300, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 80, 96, 128])
@pytest.mark.parametrize("lead", QUANT_LEAD)
def test_kv_quant_kernels_give_the_plain_bits(cuda, lead, hd, dtype):
    """``kv_quant`` gives the plain version's int8 bytes and scales, and
    ``kv_dequant`` its values, bit for bit (an amax, one IEEE division, a
    half-to-even rounding, one f32 product and one rounding: no tolerance)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(hd)
    x = (torch.randn(*lead, hd, generator=g, device=cuda) * 3).to(getattr(torch, dtype))
    x[..., :1] = 0  # a zero column, and below a zero row
    x.view(-1, hd)[0] = 0
    before = (kq.kv_quant.launches, kq.kv_dequant.launches)
    q, s = kq.kv_quant(x)
    pq, ps = kq.kv_quant_plain(x)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and tuple(s.shape) == tuple(lead) + (1,)
    assert torch.equal(q, pq) and torch.equal(s.view(torch.int32), ps.view(torch.int32))
    for out in (torch.float32, torch.bfloat16):
        got, want = kq.kv_dequant(q, s, out), kq.kv_dequant_plain(q, s, out)
        torch.cuda.synchronize()
        assert got.dtype == out
        assert torch.equal(got.view(torch.int16 if out == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if out == torch.bfloat16 else torch.int32))
    assert (kq.kv_quant.launches, kq.kv_dequant.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.gpu
def test_kv_quant_wrappers_refuse_what_they_cannot_run(cuda):
    x = torch.randn(4, 16, device=cuda)
    q, s = kq.kv_quant(x)
    with pytest.raises(ValueError, match="contiguous"):
        kq.kv_quant(torch.randn(16, 4, device=cuda).t())
    with pytest.raises(ValueError, match="dtype"):
        kq.kv_quant(x.half())
    with pytest.raises(ValueError, match="CUDA"):
        kq.kv_quant(x.cpu())
    with pytest.raises(ValueError, match="scale"):
        kq.kv_dequant(q, s[:2])
    with pytest.raises(ValueError, match="int8"):
        kq.kv_dequant(q.float(), s)
    with pytest.raises(ValueError, match="dtype"):
        kq.kv_dequant(q, s, torch.float16)
    empty_q, empty_s = kq.kv_quant(torch.empty(0, 16, device=cuda))
    assert empty_q.shape == (0, 16) and empty_s.shape == (0, 1)


# --------------------------------------------------------------------------- #
# The reduced llama-7b (head_dim 16) served on the card
# --------------------------------------------------------------------------- #
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _fused_traffic(vocab, chunk=16):
    """A canonical-order request that stores four 16-token chunks, then
    three requests with the chunks reordered (``tests/test_fusion.py``)."""
    rng = np.random.default_rng(4)
    pool = [list(map(int, rng.integers(0, vocab, chunk))) for _ in range(4)]
    perms = [[0, 1, 2, 3], [2, 0, 3, 1], [3, 2, 1, 0], [1, 3, 0, 2]]
    return [dict(req_id=i, context_tokens=sum((pool[j] for j in p), []),
                 prompt_tokens=list(map(int, rng.integers(0, vocab, 8))), max_new_tokens=4,
                 arrival_s=0.0 if i == 0 else 30.0, expected_reuses=4)
            for i, p in enumerate(perms)]


def _serve_recording(cfg, params, device, **ec_kw):
    """Serve the fused traffic; returns (engine, every prefill-type call's
    logits rows that some request's token is read from)."""
    from repro_torch.serving import BlendPlanner, EngineConfig, Request, ServingEngine

    eng = ServingEngine(cfg, params, planner=BlendPlanner(recompute_frac=0.25, always=True),
                        device=device, engine_cfg=EngineConfig(
                            max_slots=2, max_len=128, chunk_tokens=16, fusion_enabled=True,
                            **ec_kw))
    calls = []

    def record(fn, chunked=False):
        def run(*args, **kw):
            logits, caches = fn(*args, **kw)
            rows = torch.ones(logits.shape[0], dtype=torch.bool)
            if chunked:  # idle rows carry no token
                q_pos = kw["q_pos"].cpu()
                rows = q_pos[torch.arange(len(rows)), kw["last_idx"].cpu().long()] >= 0
            calls.append(logits.float().cpu()[rows])
            return logits, caches
        return run

    api = eng.api
    eng.api = api._replace(prefill_packed=record(api.prefill_packed),
                           prefill_fused=record(api.prefill_fused),
                           prefill_chunked=record(api.prefill_chunked, chunked=True))
    for r in _fused_traffic(cfg.vocab):
        eng.submit(Request(**r))
    eng.run()
    return eng, calls


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged", "unified", "compressed"])
def test_reduced_llama_serves_on_card_as_on_cpu(cuda, mode):
    """The reduced llama-7b (head_dim 16, f32) served on the card through the
    kernels: fused admissions, packed recompute and decode, and in the
    ``compressed`` mode (dense decode, ``compress_tier="io2"``) the write-back
    quantised and every fused source dequantised on the card.  Every prefill
    call's logits are within 1e-3 of the same engine run on the CPU, and the
    tokens and actions are the same."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm

    cfg = reduced_config(get_config("llama-7b"))
    assert cfg.resolved_head_dim == 16
    params = lm.init(cfg, seed=0, device="cpu")
    ec = {"dense": {}, "paged": dict(paged_decode=True),
          "unified": dict(paged_decode=True, unified_step=True),
          "compressed": dict(compress_tier="io2")}[mode]
    kernels = {"packed": pk.packed_flash_attention, "fused": fuk.fused_flash_attention,
               "decode": dk.decode_attention, "paged": pdk.paged_decode_attention,
               "chunked": cpk.chunked_prefill_attention, "kv_quant": kq.kv_quant,
               "kv_dequant": kq.kv_dequant}
    before = {n: fn.launches for n, fn in kernels.items()}
    eng, calls = _serve_recording(cfg, _to(params, cuda), cuda, **ec)
    torch.cuda.synchronize()
    launched = {n: fn.launches - before[n] for n, fn in kernels.items()}
    cpu, cpu_calls = _serve_recording(cfg, params, "cpu", **ec)
    used = {"dense": ("packed", "fused", "decode"), "paged": ("packed", "fused", "paged"),
            "unified": ("chunked", "paged"),
            "compressed": ("packed", "fused", "decode", "kv_quant", "kv_dequant")}[mode]
    assert all(launched[n] > 0 for n in used), launched
    assert all(launched[n] == 0 for n in kernels if n not in used), launched
    assert [r.action for r in eng.records].count("fused") == 3
    assert len(calls) == len(cpu_calls)
    for got, want in zip(calls, cpu_calls):
        assert (got - want).abs().max().item() <= 1e-3
    assert {r.req_id: (r.action, r.tokens) for r in eng.records} == {
        r.req_id: (r.action, r.tokens) for r in cpu.records}
    if mode == "compressed":
        assert all(e.compressed for e in eng.store.entries.values())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged", "unified"])
def test_reduced_olmoe_serves_on_card_as_on_cpu(cuda, mode):
    """The reduced olmoe-1b-7b (4 experts, top-2, f32) served on the card: the
    MoE FFN's routing, dispatch and combine on CUDA tensors between the
    attention kernels.  Every prefill call's logits are within 1e-3 of the
    same engine run on the CPU, and the tokens and actions are the same."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm

    cfg = reduced_config(get_config("olmoe-1b-7b"))
    params = lm.init(cfg, seed=0, device="cpu")
    ec = {"dense": {}, "paged": dict(paged_decode=True),
          "unified": dict(paged_decode=True, unified_step=True)}[mode]
    eng, calls = _serve_recording(cfg, _to(params, cuda), cuda, **ec)
    torch.cuda.synchronize()
    cpu, cpu_calls = _serve_recording(cfg, params, "cpu", **ec)
    assert [r.action for r in eng.records].count("fused") == 3
    assert len(calls) == len(cpu_calls)
    for got, want in zip(calls, cpu_calls):
        assert (got - want).abs().max().item() <= 1e-3
    assert {r.req_id: (r.action, r.tokens) for r in eng.records} == {
        r.req_id: (r.action, r.tokens) for r in cpu.records}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged", "unified"])
def test_reduced_granite_serves_on_card_as_on_cpu(cuda, mode):
    """The reduced granite-34b (4 query heads on one kv head, the GELU MLP;
    f32) served on the card: fused, packed or chunked admissions and dense
    or paged decode, every prefill call's logits within 1e-3 of the same
    engine on the CPU, the same tokens and actions."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm

    cfg = reduced_config(get_config("granite-34b"))
    assert (cfg.n_kv_heads, cfg.mlp_type) == (1, "gelu")
    params = lm.init(cfg, seed=0, device="cpu")
    ec = {"dense": {}, "paged": dict(paged_decode=True),
          "unified": dict(paged_decode=True, unified_step=True)}[mode]
    eng, calls = _serve_recording(cfg, _to(params, cuda), cuda, **ec)
    torch.cuda.synchronize()
    cpu, cpu_calls = _serve_recording(cfg, params, "cpu", **ec)
    assert [r.action for r in eng.records].count("fused") == 3
    assert len(calls) == len(cpu_calls)
    for got, want in zip(calls, cpu_calls):
        assert (got - want).abs().max().item() <= 1e-3
    assert {r.req_id: (r.action, r.tokens) for r in eng.records} == {
        r.req_id: (r.action, r.tokens) for r in cpu.records}


def _embeds_serve(arch, device, params, n_ctx=2, **ec_kw):
    """Six requests over ``n_ctx`` embedding contexts (images of internvl2-1b,
    audio frames of whisper-tiny) with ``AlwaysReusePlanner``; returns the
    engine and every ``ModelApi.prefill`` call's logits."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine

    cfg = reduced_config(get_config(arch))
    n_emb = cfg.encoder_seq_len if cfg.family == "encdec" else cfg.frontend_tokens
    rng = np.random.default_rng(0)
    contexts = [(list(map(int, rng.integers(0, 1000, n_emb))),
                 (rng.standard_normal((1, n_emb, cfg.d_model)) * 0.5).astype(np.float32))
                for _ in range(n_ctx)]
    eng = ServingEngine(cfg, _to(params, device), device=device, planner=AlwaysReusePlanner(),
                        engine_cfg=EngineConfig(max_slots=2, max_len=128, chunk_tokens=8,
                                                **ec_kw))
    calls = []
    prefill = eng.api.prefill

    def record(*args, **kw):
        logits, state = prefill(*args, **kw)
        calls.append(logits.float().cpu())
        return logits, state

    eng.api = eng.api._replace(prefill=record)
    for i in range(6):
        ctx, emb = contexts[i % n_ctx]
        eng.submit(Request(req_id=i, context_tokens=ctx, embeds=emb, max_new_tokens=4,
                           prompt_tokens=list(map(int, rng.integers(0, cfg.vocab, 8))),
                           arrival_s=i * 0.01, expected_reuses=3))
    eng.run()
    return eng, calls


@pytest.mark.gpu
@pytest.mark.parametrize("arch,ec", [("internvl2-1b", {}),
                                     ("internvl2-1b", dict(paged_decode=True)),
                                     ("whisper-tiny", {})], ids=["vlm", "vlm-paged", "encdec"])
def test_reduced_embeds_archs_serve_on_card_as_on_cpu(cuda, arch, ec):
    """The reduced internvl2-1b (image embeddings before the prompt) and
    whisper-tiny (the encoder over 32 frames, cross-attention at every
    decoder step) served on the card with reuse: every ``ModelApi.prefill``
    call's logits within 1e-3 of the same engine on the CPU, the same
    actions and tokens.  Whisper's launches: ``flash_attention`` for the
    encoder's layers and each decoder layer's cross-attention, prefill and
    decode alike, ``decode_attention`` for its self-attention at a step."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import registry

    cfg = reduced_config(get_config(arch))
    params = registry.get_model(cfg).init(cfg, seed=0, device="cpu")
    before = (fk.flash_attention.launches, dk.decode_attention.launches)
    eng, calls = _embeds_serve(arch, cuda, params, **ec)
    torch.cuda.synchronize()
    flash, decode = (fn.launches - b for fn, b in zip(
        (fk.flash_attention, dk.decode_attention), before))
    cpu, cpu_calls = _embeds_serve(arch, "cpu", params, **ec)
    acts = [r.action for r in sorted(eng.records, key=lambda r: r.req_id)]
    assert acts == ["recompute", "recompute", "load", "load", "load", "load"]
    assert eng.batches == 0 and len(calls) == len(cpu_calls) == 6
    for got, want in zip(calls, cpu_calls):
        assert (got - want).abs().max().item() <= 1e-3
    assert {r.req_id: (r.action, r.tokens) for r in eng.records} == {
        r.req_id: (r.action, r.tokens) for r in cpu.records}
    if cfg.family == "encdec":
        n_dec, L = eng.decode_stats()["decode_steps"], cfg.n_layers
        # the two recomputes encode (2 x n_enc), every prefill and decode
        # step cross-attends once a decoder layer, every prefill
        # self-attends once a decoder layer
        assert flash == 2 * cfg.n_encoder_layers + 6 * 2 * L + n_dec * L
        assert decode == n_dec * L > 0


def _ring_serve(cfg, params, device):
    """Serve 64-token contexts (four turns of a 16-row ring) whole and
    partly shared under ``AlwaysReusePlanner``; returns (engine, each
    ``prefill`` call's logits, each decode step's)."""
    from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine

    eng = ServingEngine(cfg, params, planner=AlwaysReusePlanner(), device=device,
                        engine_cfg=EngineConfig(max_slots=2, max_len=128, chunk_tokens=16))
    calls = []

    def record(fn):
        def run(*args, **kw):
            logits, state = fn(*args, **kw)
            calls.append(logits.float().cpu())
            return logits, state
        return run

    eng.api = eng.api._replace(prefill=record(eng.api.prefill), decode=record(eng.api.decode))
    rng = np.random.default_rng(2)
    a = rng.integers(0, cfg.vocab, 64).tolist()
    b = a[:32] + rng.integers(0, cfg.vocab, 32).tolist()  # C11: no partial from a's ring
    for i, ctx in enumerate([a, b, a, a + rng.integers(0, cfg.vocab, 16).tolist()]):
        eng.submit(Request(req_id=i, context_tokens=ctx,
                           prompt_tokens=rng.integers(0, cfg.vocab, 8).tolist(),
                           max_new_tokens=4, arrival_s=0.01 * i, expected_reuses=2))
    eng.run()
    return eng, calls


@pytest.mark.gpu
def test_reduced_mixtral_serves_on_card_as_on_cpu(cuda):
    """The reduced mixtral-8x22b (window 16, f32) served on the card: every
    admission through ``flash_attention`` over a wrapped ring, every decode
    step through ``decode_attention`` at ring positions, no other attention
    kernel.  Every prefill and decode call's logits are within 1e-3 of the
    same engine run on the CPU; the tokens and actions are the same, a
    load, a whole-context ``partial`` and no other partial among them."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm

    cfg = reduced_config(get_config("mixtral-8x22b"))
    params = lm.init(cfg, seed=0, device="cpu")
    kernels = {"flash": fk.flash_attention, "decode": dk.decode_attention,
               "packed": pk.packed_flash_attention, "paged": pdk.paged_decode_attention,
               "chunked": cpk.chunked_prefill_attention}
    before = {n: fn.launches for n, fn in kernels.items()}
    eng, calls = _ring_serve(cfg, _to(params, cuda), cuda)
    torch.cuda.synchronize()
    launched = {n: fn.launches - before[n] for n, fn in kernels.items()}
    cpu, cpu_calls = _ring_serve(cfg, params, "cpu")
    assert launched["flash"] > 0 and launched["decode"] > 0, launched
    assert launched["packed"] == launched["paged"] == launched["chunked"] == 0, launched
    assert len(calls) == len(cpu_calls)
    for got, want in zip(calls, cpu_calls):
        assert (got - want).abs().max().item() <= 1e-3
    got = {r.req_id: (r.action, r.matched_tokens, r.tokens) for r in eng.records}
    assert got == {r.req_id: (r.action, r.matched_tokens, r.tokens) for r in cpu.records}
    assert [got[i][:2] for i in range(4)] == [("recompute", 0), ("recompute", 0), ("load", 64),
                                               ("partial", 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "compressed"])
def test_reduced_llama_serves_on_card_with_telemetry_as_without(cuda, mode, tmp_path):
    """The reduced llama-7b served on the card twice, with ``obs.Telemetry``
    and a JSONL trace on and with both off: the same tokens, records and
    summary, the same launches of every kernel and the same shape-bucket
    counts; the ledger conserves at 1e-9 and the trace replays the live
    events."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kvcache.hierarchy import TierSpec
    from repro_torch.models import lm
    from repro_torch.obs import Telemetry
    from repro_torch.serving import (AlwaysReusePlanner, EngineConfig, Request, ServingEngine,
                                     TraceWriter, read_events)

    cfg = reduced_config(get_config("llama-7b"))
    params = _to(lm.init(cfg, seed=0, device="cpu"), cuda)
    kernels = {"packed": pk.packed_flash_attention, "decode": dk.decode_attention,
               "flash": fk.flash_attention, "paged": pdk.paged_decode_attention,
               "chunked": cpk.chunked_prefill_attention, "fused": fuk.fused_flash_attention,
               "kv_quant": kq.kv_quant, "kv_dequant": kq.kv_dequant}
    rng = np.random.default_rng(5)
    ctxs = [rng.integers(0, cfg.vocab, 48).tolist() for _ in range(2)]
    reqs = [dict(req_id=i, context_tokens=ctxs[i % 2],
                 prompt_tokens=rng.integers(0, cfg.vocab, 8).tolist(), max_new_tokens=4,
                 arrival_s=0.01 * i, expected_reuses=3) for i in range(6)]
    ec = dict(max_slots=2, max_len=128, chunk_tokens=16,
              tier_specs=[TierSpec("host_dram", 1.0), TierSpec("io2", 1.0)],
              **({"compress_tier": "io2"} if mode == "compressed" else {}))

    def serve(tel):
        before = {n: fn.launches for n, fn in kernels.items()}
        eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**ec), device=cuda,
                            planner=AlwaysReusePlanner(), telemetry=tel)
        for r in reqs:
            eng.submit(Request(**r))
        events = []
        with TraceWriter(tmp_path / f"{tel is not None}.jsonl") as tw:
            while not eng.idle:
                out = eng.step()
                events.extend(out)
                if tel is not None:
                    tw.write_all(out)
        torch.cuda.synchronize()
        launched = {n: fn.launches - before[n] for n, fn in kernels.items()}
        return eng, events, launched

    tel = Telemetry()
    on, on_events, on_launches = serve(tel)
    off, off_events, off_launches = serve(None)
    assert on.records == off.records and on_events == off_events
    assert on.summary() == off.summary()
    assert on_launches == off_launches and on_launches["packed"] > 0, on_launches
    assert on_launches["decode"] > 0
    if mode == "compressed":
        assert on_launches["kv_quant"] > 0 and on_launches["kv_dequant"] > 0, on_launches
    assert on.jit_stats.calls == off.jit_stats.calls
    assert on.fused_jit.calls == off.fused_jit.calls
    assert max(tel.check(on.summary()).values()) <= 1e-9
    assert read_events(tmp_path / "True.jsonl") == on_events
    assert [e for _, e in tel.events] == on_events


@pytest.mark.gpu
@pytest.mark.parametrize("seller", ["packed", "unified"])
def test_reduced_llama_f32_purchase_on_card(cuda, seller):
    """An f32 purchase of the reduced llama-7b on the card: seller ``s``
    recomputes a context through packed admissions (or the unified step's
    chunks) and writes it back; buyer ``b`` buys it, and its spot check
    launches ``flash_attention`` once per layer and passes.  The honest
    reading, the bought rows against a fresh prefill of the sample on the
    card, lies within the f32 ``SPOT_CHECK_TOL`` (printed, ``-s`` shows
    it); the trade's actions, tokens and settlement equal the same trade's
    on the CPU."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.market import Marketplace, MarketPlanner
    from repro_torch.models import lm
    from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine
    from repro_torch.serving import events as ev
    from repro_torch.serving.engine import SPOT_CHECK_TOL

    cfg = reduced_config(get_config("llama-7b"))
    assert cfg.dtype == "float32"
    cpu_params = lm.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(6)
    ctx = rng.integers(0, cfg.vocab, 96).tolist()
    reqs = [dict(req_id=i, context_tokens=ctx,
                 prompt_tokens=rng.integers(0, cfg.vocab, 8).tolist(), max_new_tokens=4,
                 arrival_s=0.0, expected_reuses=3) for i in range(2)]
    seller_ec = dict(paged_decode=True, unified_step=True) if seller == "unified" else {}

    def trade(device):
        params = _to(cpu_params, device)
        mp = Marketplace(verify_rate=1.0, seed=0)
        out = {}
        for name, r, ec in (("s", reqs[0], seller_ec), ("b", reqs[1], {})):
            before = fk.flash_attention.launches
            eng = ServingEngine(cfg, params, device=device, market=mp.join(name),
                                planner=MarketPlanner(AlwaysReusePlanner()),
                                engine_cfg=EngineConfig(max_slots=2, max_len=128,
                                                        chunk_tokens=16, **ec))
            eng.submit(Request(**r))
            events = list(eng.drain())
            out[name] = eng, events, fk.flash_attention.launches - before
        return mp, out

    before = cpk.chunked_prefill_attention.launches
    mp, out = trade(cuda)
    torch.cuda.synchronize()
    (s, _, _), (b, events, flash) = out["s"], out["b"]
    assert (cpk.chunked_prefill_attention.launches > before) == (seller == "unified")
    assert [(e.ok, e.deep) for e in events if isinstance(e, ev.SellerVerified)] == [(True, True)]
    assert len([e for e in events if isinstance(e, ev.KVPurchased)]) == 1
    assert b.market_purchases == 1 and flash == cfg.n_layers, (b.market_purchases, flash)
    e = s.store.lookup(ctx)[1]
    art = s.store.backends[e.tier].peek(e.entry_id)
    reading = b.spot_check_reading(ctx[:mp.verify_sample_tokens], art)
    print(f"f32 honest spot-check reading on the card, {seller} seller: {reading:.6g} "
          f"(tol {SPOT_CHECK_TOL['float32']:g}; {torch.cuda.get_device_name(0)})")
    assert reading <= SPOT_CHECK_TOL["float32"], reading
    cpu_mp, cpu_out = trade("cpu")
    cpu_b = cpu_out["b"][0]
    assert {r.req_id: (r.action, r.tokens) for r in b.records} == {
        r.req_id: (r.action, r.tokens) for r in cpu_b.records}
    assert mp.settlement.accounts.keys() == cpu_mp.settlement.accounts.keys()
    for k, v in mp.settlement.accounts.items():
        assert abs(v - cpu_mp.settlement.accounts[k]) <= 1e-9, (k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trace_serializes_a_tensor_on_the_card(cuda, dtype, tmp_path):
    """A trace leaf that lies on the card is copied to the host and written
    as its values: the same line as the same tensor on the CPU."""
    from repro_torch.serving import TraceWriter, read_trace
    from repro_torch.serving import events as ev

    x = torch.tensor([[0.5, -1.25, 3.0], [1.0078125, 0.0, -2.0]],
                     dtype=getattr(torch, dtype))
    with TraceWriter(tmp_path / "t.jsonl") as tw:
        for leaf in (x.to(cuda), x):
            tw.write(ev.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0), dev=leaf)
    card, host = read_trace(tmp_path / "t.jsonl")
    assert card == host and card["dev"] == x.float().tolist()


# --------------------------------------------------------------------------- #
# The Mamba2 SSD chunked scan
# --------------------------------------------------------------------------- #
SSD_ATOL = 5e-5
SSD_CASES = [
    # (B, L, H, P, G, S, chunk, with initial_state)
    (1, 1, 4, 16, 1, 16, 16, False),
    (2, 7, 4, 8, 2, 16, 16, True),
    (2, 40, 4, 8, 2, 16, 16, True),
    (1, 64, 8, 16, 1, 32, 32, False),
    (2, 24, 4, 8, 4, 8, 8, True),
    (1, 33, 6, 5, 3, 7, 16, True),
    (1, 40, 8, 256, 4, 256, 256, True),
    (1, 300, 4, 96, 2, 200, 64, False),
    (1, 2000, 64, 64, 1, 128, 256, False),
    (1, 2000, 8, 64, 2, 128, 256, True),
    # the bf16 kernels' chunk edges (Q - 1, Q, Q + 1, 2Q + 1), from a zero
    # state and from a stored one
    *[(1, L, 4, 64, 1, 128, 256, with_h0)
      for L in (ssk.CHUNK - 1, ssk.CHUNK, ssk.CHUNK + 1, 2 * ssk.CHUNK + 1)
      for with_h0 in (False, True)],
    # one token after a stored state (a decode-sized suffix)
    (1, 1, 8, 64, 1, 128, 256, True),
    # several heads per group share C·Bᵀ; odd widths past a 64-column P tile
    (2, 300, 12, 80, 3, 48, 256, True),
    (1, 130, 6, 40, 2, 24, 64, False),
    # jamba-1.5-large-398b's Mamba layers: 128 heads of P 128 (two 64-column
    # P tiles a block), S 16 (one k-step), one group; a 2,032-token launch
    # and a 32-token one after a stored state
    (1, 2032, 128, 128, 1, 16, 256, False),
    (1, 32, 128, 128, 1, 16, 256, True),
]


def _ssd_inputs(cuda, dt, B, L, H, P, G, S, with_h0, seed):
    """The reference kernel test's inputs (``tests/test_kernels.py``): x, B, C
    standard normal, dt = |N| / 10, A = -|N| - 0.1, h0 = N / 10."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=dt):
        return torch.from_numpy(a.astype(np.float32)).to(device=cuda, dtype=dtype)

    x = t(rng.standard_normal((B, L, H, P)))
    dts = t(np.abs(rng.standard_normal((B, L, H))) * 0.1, torch.float32)
    A = t(-np.abs(rng.standard_normal(H)) - 0.1, torch.float32)
    Bm, Cm = t(rng.standard_normal((B, L, G, S))), t(rng.standard_normal((B, L, G, S)))
    h0 = t(rng.standard_normal((B, H, P, S)) * 0.1, torch.float32) if with_h0 else None
    return x, dts, A, Bm, Cm, h0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,S,chunk,with_h0", SSD_CASES)
def test_ssd_kernel_matches_plain_on_card(cuda, dtype, B, L, H, P, G, S, chunk, with_h0):
    dt = getattr(torch, dtype)
    x, dts, A, Bm, Cm, h0 = _ssd_inputs(cuda, dt, B, L, H, P, G, S, with_h0, seed=L + P)
    y, hT = ssk.ssd_chunked(x, dts, A, Bm, Cm, chunk=chunk, initial_state=h0)
    y_ref, hT_ref = ssk.ssd_chunked_plain(x, dts, A, Bm, Cm, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert y.dtype == dt and hT.dtype == torch.float32 and hT.shape == (B, H, P, S)
    exact = ref.ssd_scan_ref(*(t.double() for t in (x, dts, A, Bm, Cm)),
                             initial_state=None if h0 is None else h0.double())
    f32 = [(hT, hT_ref, exact[1])]
    err = (y.float() - y_ref.float()).abs()
    if dt == torch.float32:
        f32.append((y, y_ref, exact[0]))
    else:
        assert (err <= y_ref.float().abs() * 2.0**-7 + SSD_ATOL).all(), err.max().item()
    for got, plain, want in f32:
        # the one rule: no further from the f64 scan than max(5e-5, the
        # plain version's error against it)
        k64 = (got.double() - want).abs().max().item()
        p64 = (plain.double() - want).abs().max().item()
        assert k64 <= max(SSD_ATOL, p64), (k64, p64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_two_launches_give_the_same_bits(cuda, dtype):
    """At the mamba2-1.3b serve's shape (a 2,000-token launch after a
    stored state): the chunks are fixed from token 0 and no sum takes
    atomics, so a rebuilt load sees the bits of the first."""
    x, dts, A, Bm, Cm, h0 = _ssd_inputs(cuda, getattr(torch, dtype), 1, 2000, 64, 64, 1, 128,
                                        True, seed=11)
    first = ssk.ssd_chunked(x, dts, A, Bm, Cm, chunk=256, initial_state=h0)
    second = ssk.ssd_chunked(x, dts, A, Bm, Cm, chunk=256, initial_state=h0)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_two_launches_give_the_same_bits_at_jambas_shape(cuda, dtype):
    """At jamba-1.5-large-398b's Mamba layers (H 128, P 128, S 16, G 1), a
    2,000-token launch after a stored state: the same bits twice."""
    x, dts, A, Bm, Cm, h0 = _ssd_inputs(cuda, getattr(torch, dtype), 1, 2000, 128, 128, 1, 16,
                                        True, seed=13)
    first = ssk.ssd_chunked(x, dts, A, Bm, Cm, chunk=256, initial_state=h0)
    second = ssk.ssd_chunked(x, dts, A, Bm, Cm, chunk=256, initial_state=h0)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_ssd_bf16_final_state_is_held_to_the_f64_scan(cuda):
    """The bf16 launch's final state at the serve's shape, from a stored
    state, lies within 5e-5 of the f64 scan of the same inputs (the
    products' f32 operands enter the tensor cores in three bf16 parts)."""
    x, dts, A, Bm, Cm, h0 = _ssd_inputs(cuda, torch.bfloat16, 1, 2000, 64, 64, 1, 128, True,
                                        seed=12)
    _, hT = ssk.ssd_chunked(x, dts, A, Bm, Cm, chunk=256, initial_state=h0)
    exact = ref.ssd_scan_ref(*(t.double() for t in (x, dts, A, Bm, Cm)),
                             initial_state=h0.double())
    torch.cuda.synchronize()
    assert (hT.double() - exact[1]).abs().max().item() <= SSD_ATOL


@pytest.mark.gpu
def test_ssd_wrapper_counts_launches_and_refuses_what_it_cannot_run(cuda):
    x, dts, A, Bm, Cm, h0 = _ssd_inputs(cuda, torch.float32, 1, 20, 4, 8, 2, 16, True, seed=5)
    before = ssk.ssd_chunked.launches
    ssk.ssd_chunked(x, dts, A, Bm, Cm, chunk=16, initial_state=h0)
    assert ssk.ssd_chunked.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        ssk.ssd_chunked(x.transpose(2, 3).contiguous().transpose(2, 3), dts, A, Bm, Cm)
    with pytest.raises(ValueError, match="multiple of G"):
        ssk.ssd_chunked(x[:, :, :3].contiguous(), dts[:, :, :3].contiguous(), A[:3], Bm, Cm)
    wide = torch.zeros(1, 20, 4, 264, device=cuda)
    with pytest.raises(ValueError, match="<= 256"):
        ssk.ssd_chunked(wide, dts, A, Bm, Cm)
    deep = torch.zeros(1, 20, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="<= 256"):
        ssk.ssd_chunked(x, dts, A, deep, deep)
    with pytest.raises(ValueError, match="float32"):
        ssk.ssd_chunked(x, dts.double(), A, Bm, Cm)
    with pytest.raises(ValueError, match="must be"):
        ssk.ssd_chunked(x, dts, A, Bm.bfloat16(), Cm.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        ssk.ssd_chunked(x.cpu(), dts.cpu(), A.cpu(), Bm.cpu(), Cm.cpu())
    assert ssk.ssd_chunked.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("paged_decode", [False, True])
def test_reduced_mamba_serves_on_card_as_on_cpu(cuda, paged_decode):
    """The reduced mamba2-1.3b (f32) served on the card and on the CPU with
    ``AlwaysReusePlanner``: every prefill call's logits within 1e-3, the same
    actions and tokens; ``ssd_chunked`` launches once per layer per
    ``ModelApi.prefill`` call (two per recompute that writes back), no
    attention or int8 kernel launches, and ``paged_decode=True`` keeps the
    dense decode (``decode_stats()["paged"]`` False)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine

    cfg = reduced_config(get_config("mamba2-1.3b"))
    params = lm.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    ctxs = [list(map(int, rng.integers(0, cfg.vocab, 64))) for _ in range(2)]
    reqs = [dict(req_id=i, context_tokens=ctxs[i % 2],
                 prompt_tokens=list(map(int, rng.integers(0, cfg.vocab, 8))),
                 max_new_tokens=4, arrival_s=i * 0.01, expected_reuses=3) for i in range(6)]
    others = [pk.packed_flash_attention, dk.decode_attention, fk.flash_attention,
              pdk.paged_decode_attention, cpk.chunked_prefill_attention,
              fuk.fused_flash_attention, kq.kv_quant, kq.kv_dequant]

    def serve(device):
        eng = ServingEngine(cfg, _to(params, device), device=device,
                            planner=AlwaysReusePlanner(), engine_cfg=EngineConfig(
                                max_slots=2, max_len=128, chunk_tokens=16,
                                paged_decode=paged_decode))
        calls = []
        prefill = eng.api.prefill

        def record(*args, **kw):
            logits, state = prefill(*args, **kw)
            calls.append(logits.float().cpu())
            return logits, state

        eng.api = eng.api._replace(prefill=record)
        for r in reqs:
            eng.submit(Request(**r))
        eng.run()
        return eng, calls

    before = ssk.ssd_chunked.launches
    other_before = [fn.launches for fn in others]
    eng, calls = serve(cuda)
    torch.cuda.synchronize()
    assert ssk.ssd_chunked.launches - before == cfg.n_layers * len(calls)
    assert [fn.launches for fn in others] == other_before
    cpu, cpu_calls = serve("cpu")
    assert eng.decode_stats()["paged"] is False and eng.batches == 0
    assert len(calls) == len(cpu_calls) == 8  # 2 recomputes in two phases, 4 loads
    for got, want in zip(calls, cpu_calls):
        assert (got - want).abs().max().item() <= 1e-3
    assert {r.req_id: (r.action, r.tokens) for r in eng.records} == {
        r.req_id: (r.action, r.tokens) for r in cpu.records}
    assert [r.action for r in sorted(eng.records, key=lambda r: r.req_id)].count("load") == 4


@pytest.mark.gpu
def test_reduced_jamba_serves_on_card_as_on_cpu(cuda):
    """The reduced jamba-1.5-large-398b (one 8-layer period: seven Mamba
    layers and one attention layer, MoE on every other one; f32) served on
    the card and on the CPU with ``AlwaysReusePlanner``: every prefill
    call's logits within 1e-3, the same actions and tokens; per
    ``ModelApi.prefill`` call ``ssd_chunked`` launches once per Mamba layer
    and ``flash_attention`` once per attention layer, ``decode_attention``
    once per attention layer per decode step, and no other kernel."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine

    cfg = reduced_config(get_config("jamba-1.5-large-398b"))
    params = lm.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    ctxs = [list(map(int, rng.integers(0, cfg.vocab, 64))) for _ in range(2)]
    reqs = [dict(req_id=i, context_tokens=ctxs[i % 2],
                 prompt_tokens=list(map(int, rng.integers(0, cfg.vocab, 8))),
                 max_new_tokens=4, arrival_s=i * 0.01, expected_reuses=3) for i in range(6)]
    others = [pk.packed_flash_attention, pdk.paged_decode_attention,
              cpk.chunked_prefill_attention, fuk.fused_flash_attention, kq.kv_quant,
              kq.kv_dequant]

    def serve(device):
        eng = ServingEngine(cfg, _to(params, device), device=device,
                            planner=AlwaysReusePlanner(), engine_cfg=EngineConfig(
                                max_slots=2, max_len=128, chunk_tokens=16))
        calls = []
        prefill = eng.api.prefill

        def record(*args, **kw):
            logits, state = prefill(*args, **kw)
            calls.append(logits.float().cpu())
            return logits, state

        eng.api = eng.api._replace(prefill=record)
        for r in reqs:
            eng.submit(Request(**r))
        eng.run()
        return eng, calls

    kernels = (ssk.ssd_chunked, fk.flash_attention, dk.decode_attention)
    before = [fn.launches for fn in kernels]
    other_before = [fn.launches for fn in others]
    eng, calls = serve(cuda)
    torch.cuda.synchronize()
    ssd, flash, decode = (fn.launches - b for fn, b in zip(kernels, before))
    n_decode = eng.decode_stats()["decode_steps"]
    assert (ssd, flash) == (cfg.n_ssm_layers * len(calls), cfg.n_attn_layers * len(calls))
    assert decode == cfg.n_attn_layers * n_decode > 0
    assert [fn.launches for fn in others] == other_before
    cpu, cpu_calls = serve("cpu")
    assert eng.batches == 0 and len(calls) == len(cpu_calls) == 8
    for got, want in zip(calls, cpu_calls):
        assert (got - want).abs().max().item() <= 1e-3
    assert {r.req_id: (r.action, r.tokens) for r in eng.records} == {
        r.req_id: (r.action, r.tokens) for r in cpu.records}
    assert [r.action for r in sorted(eng.records, key=lambda r: r.req_id)].count("load") == 4


def _int8_rebalance_cluster(device):
    """A two-replica round-robin cluster of the reduced llama-7b on
    ``device``, rebalancing on and write-back off, whose replica 0 holds
    three 64-token contexts in an int8 ``local_nvme`` tier; 16 requests
    over them, so that one context's traffic concentrates on replica 1.
    Returns (cluster, kv_dequant launches inside each rebalance tick)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.perf_model import V100_X4_HF, PerfModel
    from repro_torch.core.pricing import AWS_PAPER
    from repro_torch.kvcache.hierarchy import TierSpec
    from repro_torch.models import lm
    from repro_torch.serving import (AlwaysReusePlanner, ClusterConfig, EngineConfig, Request,
                                     RoundRobinRouter, ServingCluster, ServingEngine)

    cfg = reduced_config(get_config("llama-7b"))
    params = _to(lm.init(cfg, seed=0, device="cpu"), device)
    hw = dict(pricing=AWS_PAPER, perf=PerfModel(V100_X4_HF))
    specs = [TierSpec("host_dram", 1.0), TierSpec("local_nvme", 1.0), TierSpec("s3", 1.0)]
    rng = np.random.default_rng(1)
    ctxs = [list(map(int, rng.integers(0, cfg.vocab, 64))) for _ in range(3)]
    seeds = []
    for ctx in ctxs:
        eng = ServingEngine(cfg, params, device=device, planner=AlwaysReusePlanner(), **hw,
                            engine_cfg=EngineConfig(max_slots=2, max_len=128, chunk_tokens=16,
                                                    tier_specs=specs, store_tier="host_dram"))
        eng.submit(Request(req_id=0, context_tokens=ctx, prompt_tokens=[1, 2, 3],
                           max_new_tokens=1, expected_reuses=4))
        eng.run()
        (eid, entry), = eng.store.entries.items()
        seeds.append((eng.store.backends[entry.tier].peek(eid), entry.saved_per_use))
    cl = ServingCluster(
        cfg, params, device=device, router=RoundRobinRouter(),
        planner_factory=AlwaysReusePlanner, **hw,
        cluster_cfg=ClusterConfig(n_replicas=2, gossip_interval_s=0.05,
                                  rebalance_interval_s=0.05, rebalance_min_hits=2),
        engine_cfg=EngineConfig(max_slots=2, max_len=128, chunk_tokens=16, tier_specs=specs,
                                store_tier="host_dram", cost_arch="llama-7b",
                                store_write_back=False, compress_tier="local_nvme"))
    for ctx, (art, saved) in zip(ctxs, seeds):
        assert cl.replicas[0].store.put(ctx, art, tier="local_nvme", saved_per_use=saved)[0]
    ticks = []
    rebalance = cl._rebalance

    def counted(now, out):
        before = kq.kv_dequant.launches
        rebalance(now, out)
        ticks.append(kq.kv_dequant.launches - before)

    cl._rebalance = counted
    for i in range(16):
        cl.submit(Request(req_id=i, context_tokens=ctxs[i % 3],
                          prompt_tokens=list(map(int, rng.integers(0, cfg.vocab, 8))),
                          max_new_tokens=4, arrival_s=i * 0.2, expected_reuses=5))
    cl.run()
    return cl, ticks


@pytest.mark.gpu
def test_cluster_rebalance_of_an_int8_entry_dequantises_on_card(cuda):
    """Copy-then-keep of an int8 entry between replicas on the card: the
    rebalance dequantises the donor's int8 rows through ``kv_dequant`` (one
    launch per quantised leaf, counted inside the rebalance tick), and the
    copy lands in the target's host tier as host arrays, bit for bit the
    plain dequantisation of the donor's bytes, with the donor's int8 copy
    kept.  The same cluster on the CPU makes the same copies and tokens."""
    from repro_torch.kvcache import compression
    from repro_torch.serving import events as ev

    def copies(cl):
        out = []
        for _, e in cl.events:
            if isinstance(e, ev.ReplicaRebalanced):
                (d,) = [x for x in cl.replicas[e.from_replica].store.entries.values()
                        if x.content_key == e.content_key]
                (t,) = [x for x in cl.replicas[e.to_replica].store.entries.values()
                        if x.content_key == e.content_key]
                out.append((e, d, t))
        return out

    cl, ticks = _int8_rebalance_cluster("cuda")
    torch.cuda.synchronize()
    done = copies(cl)
    assert done and cl.rebalances == len(done)
    quantised = 0
    for e, d, t in done:
        assert (d.tier, d.compressed) == ("local_nvme", True)
        assert (t.tier, t.compressed, t.nbytes) == ("host_dram", False, e.nbytes)
        src = cl.replicas[e.from_replica].store.backends["local_nvme"].peek(d.entry_id)
        got = cl.replicas[e.to_replica].store.backends["host_dram"].peek(t.entry_id)
        want = compression.decompress_tree(src, "cpu")
        pairs = list(zip(compression.tree_leaves(got), compression.tree_leaves(want)))
        assert pairs and all(isinstance(g, np.ndarray) for g, _ in pairs)
        assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in pairs)
        quantised += sum(isinstance(x, compression.CompressedArray)
                         for x in compression.tree_leaves(src))
    assert sum(ticks) == quantised > 0
    cpu, cpu_ticks = _int8_rebalance_cluster("cpu")
    assert sum(cpu_ticks) == 0
    assert [(e.content_key, e.from_replica, e.to_replica, e.nbytes) for e, _, _ in done] == \
        [(e.content_key, e.from_replica, e.to_replica, e.nbytes) for e, _, _ in copies(cpu)]
    assert {r.req_id: r.tokens for r in cl.records} == {r.req_id: r.tokens for r in cpu.records}


# --------------------------------------------------------------------------- #
# The flash-attention backward (training)
# --------------------------------------------------------------------------- #
# (B, Sq, H, KV, hd, causal, window, masked kv rows, kv_valid): the training
# shapes (queries and keys the same positions), GQA, MQA, a window,
# non-causal, head_dims off the buckets, rows masked by kv_pos < 0.  Sq may
# be (Sq, Skv) with Sq < Skv: the queries are the last Sq positions.
BWD_CASES = [
    (2, 200, 14, 2, 64, True, None, False, False),  # qwen2-0.5b's heads
    (1, 130, 4, 4, 128, True, None, False, False),  # llama's (G 1)
    (2, 150, 12, 2, 128, True, 40, False, False),  # mixtral's G 6 with a window
    (1, 96, 4, 1, 16, True, None, True, False),  # MQA, invalid rows
    (2, 70, 6, 6, 64, False, None, False, True),  # whisper's encoder, kv_valid
    (1, 64, 8, 2, 80, True, None, False, False),
    (1, 33, 2, 1, 256, True, 10, False, False),
    # past PART_TILES x 64 = 512 kv rows the bf16 forward splits its kv
    # tiles and the combine writes lse: causal with invalid rows, and a
    # window with kv_valid (parts whose every key a row masks)
    (1, 700, 8, 2, 64, True, None, True, False),
    (1, 600, 6, 1, 128, True, 200, False, True),
    # the bf16 dK/dV kernel's per-head partials and their reduce over 16
    # kv tiles (qwen2-0.5b's G 7); a suffix of 300 queries after 400 earlier
    # rows; granite's MQA (G 48) at hd 128
    (1, 1000, 14, 2, 64, True, None, False, False),
    (2, (300, 700), 8, 2, 64, True, None, False, False),
    (1, 300, 48, 1, 128, True, None, False, False),
]


def _bwd_case(cuda, dt, B, Sq, H, KV, hd, causal, window, masked, valid, seed=0):
    Sq, Skv = Sq if isinstance(Sq, tuple) else (Sq, Sq)
    g = torch.Generator(device=cuda)
    g.manual_seed(seed + Sq * H + hd)
    q, dout = (torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt) for _ in range(2))
    k, v = (torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dt) for _ in range(2))
    kv_pos = torch.arange(Skv, device=cuda, dtype=torch.int32)[None].expand(B, Skv).contiguous()
    pos = kv_pos[:, Skv - Sq:].contiguous()
    kv_pos = kv_pos.clone()
    if masked:
        kv_pos[:, 5:20] = -1
    kv_valid = torch.rand(B, Skv, generator=g, device=cuda) > 0.3 if valid else None
    kw = dict(q_pos=pos, kv_pos=kv_pos, causal=causal, window=window, kv_valid=kv_valid)
    return q, k, v, dout, kw


def _bwd_err(got, want):
    """Largest |got - want| over max(1, max|want|), per gradient."""
    return [((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1.0)).item()
            for a, b in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,H,KV,hd,causal,window,masked,valid", BWD_CASES)
def test_flash_backward_matches_plain_on_card(cuda, dtype, B, Sq, H, KV, hd, causal, window,
                                              masked, valid):
    """dQ, dK and dV against the plain backward on the same inputs and the
    kernel's lse: f32 within 2e-5 of max(1, max|·|) (the reference's atol;
    sums in another order), bf16 within 1e-2 of it (each side rounds its f32
    sums to bf16: at most one ulp, 2^-7 of the value)."""
    from repro_torch.kernels import flash_backward as fbk

    dt = getattr(torch, dtype)
    q, k, v, dout, kw = _bwd_case(cuda, dt, B, Sq, H, KV, hd, causal, window, masked, valid)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    out = fk.flash_attention(q, k, v, lse=lse, **kw)
    _, plain_lse = fbk.flash_attention_fwd_plain(q, k, v, **kw)
    finite = torch.isfinite(plain_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert (lse[finite] - plain_lse[finite]).abs().max().item() <= 1e-4
    got = fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    want = fbk.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    tol = F32_ATOL if dtype == "float32" else BF16_ATOL
    assert max(_bwd_err(got, want)) <= tol, _bwd_err(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_gives_the_same_bits_twice_and_lse_keeps_the_output(cuda, dtype):
    from repro_torch.kernels import flash_backward as fbk

    q, k, v, dout, kw = _bwd_case(cuda, getattr(torch, dtype), *BWD_CASES[2])
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    out = fk.flash_attention(q, k, v, lse=lse, **kw)
    assert torch.equal(out, fk.flash_attention(q, k, v, **kw))
    first = fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    second = fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_flash_backward_gives_the_same_bits_twice_over_many_kv_tiles(cuda):
    """bf16 at qwen2-0.5b's G 7 over 16 kv tiles: the per-head partials and
    their reduce run in a fixed order, so two launches give the same bits."""
    from repro_torch.kernels import flash_backward as fbk

    q, k, v, dout, kw = _bwd_case(cuda, torch.bfloat16, *BWD_CASES[9])
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    out = fk.flash_attention(q, k, v, lse=lse, **kw)
    first = fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    second = fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_flash_fn_gradients_match_autograd_of_plain_forward_on_card(cuda):
    """``FlashAttentionFn`` on the card (forward and backward kernels)
    against autograd of the plain forward, f32."""
    from repro_torch.kernels import ops

    q, k, v, dout, kw = _bwd_case(cuda, torch.float32, *BWD_CASES[0])
    grads = []
    for fn in (ops.flash_attention, fk.flash_attention_plain):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*qkv, **kw) * dout).sum().backward()
        grads.append([t.grad for t in qkv])
    assert max(_bwd_err(*grads)) <= F32_ATOL, _bwd_err(*grads)


@pytest.mark.gpu
def test_flash_backward_counts_launches_and_refuses_what_it_cannot_run(cuda):
    from repro_torch.kernels import flash_backward as fbk

    q, k, v, dout, kw = _bwd_case(cuda, torch.bfloat16, *BWD_CASES[3])
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    out = fk.flash_attention(q, k, v, lse=lse, **kw)
    before = fbk.flash_attention_bwd.launches
    fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert fbk.flash_attention_bwd.launches == before + 1
    with pytest.raises(ValueError, match="lse"):
        fbk.flash_attention_bwd(q, k, v, out, dout, lse.to(torch.bfloat16), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fbk.flash_attention_bwd(*(t.cpu() for t in (q, k, v, out, dout, lse)),
                                **{n: None if t is None or isinstance(t, (bool, int)) else
                                   t.cpu() for n, t in kw.items()})
    assert fbk.flash_attention_bwd.launches == before + 1


@pytest.mark.gpu
def test_reduced_train_step_on_card_as_on_cpu(cuda):
    """The loss and gradients of the reduced qwen2-0.5b (f32) on the card
    (the forward and backward kernels, one launch each a layer) against the
    same step on the CPU (their plain versions): the loss within 1e-5, each
    gradient within 1e-5 of its largest magnitude.  (New parameters after
    one Adam step are no yardstick: at step 1 the update is g / (|g| + eps),
    so a near-zero gradient of either sign moves a weight by +-lr.)"""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import flash_backward as fbk
    from repro_torch.models import lm
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_leaves, tree_map

    cfg = reduced_config(get_config("qwen2-0.5b"))
    params = lm.init(cfg, seed=0, device="cpu")
    batch = next(token_batches(cfg, batch=2, seq_len=64, seed=0))
    fwd, bwd = fk.flash_attention.launches, fbk.flash_attention_bwd.launches
    (loss, _), grads = value_and_grad(tree_map(lambda t: t.to(cuda), params), cfg, batch)
    torch.cuda.synchronize()
    assert fk.flash_attention.launches - fwd == cfg.n_layers
    assert fbk.flash_attention_bwd.launches - bwd == cfg.n_layers
    (cpu_loss, _), cpu_grads = value_and_grad(params, cfg, batch)
    assert abs(loss.item() - cpu_loss.item()) <= 1e-5
    for g, w in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-5 * max(w.abs().max().item(), 1e-12), (err, w.abs().max().item())


# --------------------------------------------------------------------------- #
# The SSD scan's backward
# --------------------------------------------------------------------------- #
# Relative to each output's largest magnitude, set before the kernel first
# ran on the card from its arithmetic emulated on the CPU
# (tests/test_torch_ssd_bwd_numerics.py): an output in bf16 (dx, dB, dC of a
# bf16 launch) within one bf16 step at its largest magnitude, every f32
# output within 1e-4
SSD_BWD_BF16_RTOL = 2.0**-7
SSD_BWD_F32_RTOL = 1e-4
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")
SSD_BWD_CASES = [
    # (B, L, H, P, G, S, with an initial state and dhT)
    (2, 300, 4, 64, 2, 128, True),
    (1, 2048, 8, 64, 1, 128, False),  # mamba2-1.3b's heads, 16 chunks
    (1, 1000, 4, 128, 1, 16, True),  # jamba-1.5-large-398b's heads
    (1, 37, 3, 20, 3, 24, True),  # one padded chunk, odd widths, one head a group
    (2, 129, 2, 256, 1, 256, False),  # the widest P and S, a one-token last chunk
]


def _ssd_bwd_case(cuda, dtype, B, L, H, P, G, S, states, seed=0):
    """Seeded operands at the model's scales (dt = softplus(N(0, 1) - 2), A
    from -1 to -16, the rest unit normal)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=g, device=cuda) - 2)
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    Bm, Cm = (torch.randn(B, L, G, S, generator=g, device=cuda).to(dtype) for _ in range(2))
    dy = torch.randn(B, L, H, P, generator=g, device=cuda).to(dtype)
    h0 = torch.randn(B, H, P, S, generator=g, device=cuda) if states else None
    dhT = torch.randn(B, H, P, S, generator=g, device=cuda) if states else None
    return (x, dt, A, Bm, Cm, dy, dhT), h0


def _ssd_bwd_errs(got, want, dtype):
    """Each output's max |got - want| over its max |want|, and its gate."""
    out = []
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        tol = (SSD_BWD_BF16_RTOL if dtype == torch.bfloat16 and name in ("dx", "dB", "dC")
               else SSD_BWD_F32_RTOL)
        out.append((name, err, tol))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,S,states", SSD_BWD_CASES)
def test_ssd_backward_matches_plain_on_card(cuda, dtype, B, L, H, P, G, S, states):
    from repro_torch.kernels import ssd_backward as sbk

    dt = getattr(torch, dtype)
    ins, h0 = _ssd_bwd_case(cuda, dt, B, L, H, P, G, S, states, seed=L + P)
    got = sbk.ssd_chunked_bwd(*ins, initial_state=h0)
    want = ssk.ssd_chunked_bwd_plain(*ins, chunk=256, initial_state=h0)
    errs = _ssd_bwd_errs(got, want, dt)
    assert all(err <= tol for _, err, tol in errs), errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_gives_the_same_bits_twice(cuda, dtype):
    """No atomics: the group's heads are summed in head order and each
    head's dA terms in (batch, chunk) order."""
    from repro_torch.kernels import ssd_backward as sbk

    ins, h0 = _ssd_bwd_case(cuda, getattr(torch, dtype), *SSD_BWD_CASES[0])
    first = sbk.ssd_chunked_bwd(*ins, initial_state=h0)
    second = sbk.ssd_chunked_bwd(*ins, initial_state=h0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_ssd_backward_counts_launches_and_refuses_what_it_cannot_run(cuda):
    from repro_torch.kernels import ssd_backward as sbk

    (x, dt, A, Bm, Cm, dy, dhT), h0 = _ssd_bwd_case(cuda, torch.bfloat16, *SSD_BWD_CASES[3])
    before = sbk.ssd_chunked_bwd.launches
    sbk.ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, dhT, initial_state=h0)
    assert sbk.ssd_chunked_bwd.launches == before + 1
    with pytest.raises(ValueError, match="dy"):
        sbk.ssd_chunked_bwd(x, dt, A, Bm, Cm, dy.float(), dhT, initial_state=h0)
    with pytest.raises(ValueError, match="dhT"):
        sbk.ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, dhT[:, :1].contiguous(), initial_state=h0)
    with pytest.raises(ValueError, match="contiguous"):
        sbk.ssd_chunked_bwd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, dy)
    with pytest.raises(ValueError, match="multiple"):
        sbk.ssd_chunked_bwd(x[:, :, :2].contiguous(), dt[:, :, :2].contiguous(), A[:2], Bm, Cm,
                            dy[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        sbk.ssd_chunked_bwd(*(t.cpu() for t in (x, dt, A, Bm, Cm, dy)))
    assert sbk.ssd_chunked_bwd.launches == before + 1


# The bf16 launches' edges: head counts that the slices of
# ssd_backward.SLICE_HEADS heads do not divide, G 2 over a padded last chunk,
# jamba's P 128 and S 16 over two slices, fewer tokens than a row block
SSD_BWD_EDGE_CASES = [
    (1, 300, 12, 64, 1, 128, True),  # 12 heads a group: slices of 8 and 4
    (2, 333, 20, 32, 2, 64, False),  # G 2, 10 heads a group, a last chunk of 77 tokens
    (1, 600, 16, 128, 1, 16, True),  # jamba's P and S, two slices
    (2, 50, 9, 64, 1, 128, True),  # L < 64; slices of 8 and 1
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,S,states", SSD_BWD_EDGE_CASES)
def test_ssd_backward_matches_plain_on_card_at_slice_edges(cuda, dtype, B, L, H, P, G, S,
                                                           states):
    from repro_torch.kernels import ssd_backward as sbk

    dt = getattr(torch, dtype)
    ins, h0 = _ssd_bwd_case(cuda, dt, B, L, H, P, G, S, states, seed=L + P)
    got = sbk.ssd_chunked_bwd(*ins, initial_state=h0)
    want = ssk.ssd_chunked_bwd_plain(*ins, chunk=256, initial_state=h0)
    errs = _ssd_bwd_errs(got, want, dt)
    assert all(err <= tol for _, err, tol in errs), errs


@pytest.mark.gpu
def test_ssd_backward_bf16_gives_the_same_bits_twice_over_slices(cuda):
    """Three slices of a group's 24 heads: each slice's heads summed in head
    order, the slices in slice order."""
    from repro_torch.kernels import ssd_backward as sbk

    ins, h0 = _ssd_bwd_case(cuda, torch.bfloat16, 1, 512, 24, 64, 1, 128, True)
    first = sbk.ssd_chunked_bwd(*ins, initial_state=h0)
    second = sbk.ssd_chunked_bwd(*ins, initial_state=h0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _ssd_bwd_numpy_case(cuda, B, L, H, P, G, S, seed):
    """f32 operands, an initial state and dhT made with numpy (the same bits
    whatever torch's generators do), on the card."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    x, z = normal(B, L, H, P), normal(B, L, H)
    dt = np.log1p(np.exp(z - np.float32(2))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    Bm, Cm, dy = normal(B, L, G, S), normal(B, L, G, S), normal(B, L, H, P)
    h0, dhT = normal(B, H, P, S), normal(B, H, P, S)
    ins = [torch.from_numpy(t).to(cuda) for t in (x, dt, A, Bm, Cm, dy, dhT)]
    return ins, torch.from_numpy(h0).to(cuda)


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# sha256 (first 16 hex digits) of (dx, ddt, dA, dB, dC, dh0) of an f32
# launch on these inputs, recorded on an H100 from the CUDA-core kernels
# before the bf16 launches moved to the tensor cores: f32 launches keep them
SSD_BWD_F32_DIGESTS = {
    (2, 300, 4, 64, 2, 128, 0): "29b54c78e31ac825",
    (1, 200, 3, 20, 3, 24, 1): "62640628e2daabfb",
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SSD_BWD_F32_DIGESTS))
def test_ssd_backward_f32_keeps_the_cuda_core_bits(cuda, case):
    from repro_torch.kernels import ssd_backward as sbk

    ins, h0 = _ssd_bwd_numpy_case(cuda, *case)
    got = sbk.ssd_chunked_bwd(*ins, initial_state=h0)
    assert _digest(got) == SSD_BWD_F32_DIGESTS[case]


@pytest.mark.gpu
def test_ssd_fn_gradients_match_autograd_of_plain_forward_on_card(cuda):
    """``SSDChunkedFn`` on the card (the forward and backward kernels)
    against autograd of the plain forward, f32, both outputs carrying the
    loss."""
    from repro_torch.kernels import ops

    (x, dt, A, Bm, Cm, dy, dhT), h0 = _ssd_bwd_case(cuda, torch.float32, *SSD_BWD_CASES[0])
    grads = []
    for fn in (ops.ssd_chunked, ssk.ssd_chunked_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]
        y, hT = fn(*leaves[:5], chunk=256, initial_state=leaves[5])
        grads.append(torch.autograd.grad((y * dy).sum() + (hT * dhT).sum(), leaves))
    errs = _ssd_bwd_errs(grads[0], grads[1], torch.float32)
    assert all(err <= tol for _, err, tol in errs), errs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"])
def test_reduced_family_train_step_on_card_as_on_cpu(cuda, arch):
    """The loss and gradients of the reduced SSM, hybrid and encoder-decoder
    archs (f32) on the card (the SSD and flash kernels, forward and backward,
    one launch each a layer of their kind) against the same step on the CPU
    (their plain versions): the loss within 1e-5, each gradient within 1e-4
    of its largest magnitude (the SSD backward's f32 tolerance)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.synthetic import frame_batches, token_batches
    from repro_torch.kernels import flash_backward as fbk
    from repro_torch.kernels import ssd_backward as sbk
    from repro_torch.models import registry
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_leaves, tree_map

    cfg = reduced_config(get_config(arch))
    params = registry.get_model(cfg).init(cfg, seed=0, device="cpu")
    batches = frame_batches if cfg.family == "encdec" else token_batches
    batch = next(batches(cfg, batch=2, seq_len=64, seed=0))
    kernels = (ssk.ssd_chunked, sbk.ssd_chunked_bwd, fk.flash_attention, fbk.flash_attention_bwd)
    before = [k.launches for k in kernels]
    (loss, _), grads = value_and_grad(tree_map(lambda t: t.to(cuda), params), cfg, batch)
    torch.cuda.synchronize()
    ssd, ssd_bwd, flash, flash_bwd = (k.launches - b for k, b in zip(kernels, before))
    n_ssd = 0 if cfg.ssm is None else cfg.n_ssm_layers
    n_attn = (cfg.n_encoder_layers + 2 * cfg.n_layers if cfg.family == "encdec"
              else cfg.n_attn_layers)
    assert (ssd, ssd_bwd, flash, flash_bwd) == (n_ssd, n_ssd, n_attn, n_attn)
    (cpu_loss, _), cpu_grads = value_and_grad(params, cfg, batch)
    assert abs(loss.item() - cpu_loss.item()) <= 1e-5 * abs(cpu_loss.item())
    for g, w in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        err = (g.cpu() - w).abs().max().item()
        assert err <= SSD_BWD_F32_RTOL * max(w.abs().max().item(), 1e-12), (
            err, w.abs().max().item())
