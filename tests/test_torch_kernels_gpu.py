"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips (from inside its fixture) on a machine
without CUDA, so they run only where the kernels can.  The file imports
``torch`` and the port only (no JAX), so it also runs on a machine that has
no JAX:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

f32 is held at the CPU tests' atol 2e-5 with TF32 off; bf16 at atol 1e-2.
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
from repro_torch.kernels import packed_prefill as pk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402

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


FLASH_CASES = [
    # (B, Sq, L, H, KV, hd, causal, window, offset, with kv_valid)
    (2, 24, 40, 4, 2, 32, True, None, 8, False),
    (1, 300, 1024, 8, 8, 128, True, None, 100, False),  # max_len cache, invalid tail
    (2, 70, 160, 8, 2, 64, True, 33, 20, False),
    (2, 40, 96, 4, 1, 256, False, None, 0, False),  # cross-attention
    (1, 64, 128, 6, 3, 128, True, None, 30, True),
    (1, 130, 256, 16, 2, 128, True, 50, 0, True),  # GQA 8:1, window and kv_valid
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


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 70])
def test_paged_kernel_gives_the_dense_kernels_bits(cuda, window):
    """Over the same rows the paged and dense decode kernels split the work
    alike, so the paged kernel gives the dense kernel's output bit for bit."""
    block, max_len, lens = 32, 512, [300, 1, 511, 96]
    q, kp, vp, tables, q_pos = _pool(cuda, torch.bfloat16, lens, 4, 8, 128, block, max_len,
                                     seed=7)
    rows = (tables.long()[:, :, None] * block
            + torch.arange(block, device=cuda)[None, None]).reshape(len(lens), max_len)
    idx = torch.arange(max_len, device=cuda, dtype=torch.int32)[None]
    kv_pos = torch.where(idx <= q_pos, idx, -1).to(torch.int32)
    dense = dk.decode_attention(q, kp[rows].contiguous(), vp[rows].contiguous(), q_pos=q_pos,
                                kv_pos=kv_pos, window=window)
    got = pdk.paged_decode_attention(q, kp, vp, block_table=tables, q_pos=q_pos, block=block,
                                     window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)


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
