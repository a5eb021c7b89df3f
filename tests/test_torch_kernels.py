"""The port's attention kernels against the JAX package's.

On the CPU the port's entry points run each kernel's plain PyTorch version;
these tests hold those against ``repro.kernels.ref`` and against the Pallas
kernels in interpret mode, on the same numpy inputs, at atol 2e-5 (f32: the
tolerance of the reference's own kernel tests).  The hand-written CUDA
kernels run only on the card: ``tests/test_torch_kernels_gpu.py`` holds
them against the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_prefill import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.packed_prefill import packed_flash_attention as pallas_packed  # noqa: E402
from repro.kernels.paged_decode import paged_decode_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402

torch.set_num_threads(1)
ATOL = 2e-5


def _packed_inputs(segs, H, KV, hd, q_len, seed, align=16):
    """Packed q/k/v and index arrays for segments ``(matched, n_new)``: each
    segment's kv span starts at an ``align`` multiple; q padding carries pos
    -2^30 / seg -1 and kv padding pos -1 / seg -2, as the engine lays out."""
    rng = np.random.default_rng(seed)
    spans = [-(-(m + n) // align) * align for m, n in segs]
    kv_len = sum(spans) + align  # a trailing all-padding tile
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
    assert qo <= q_len
    return dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos, q_seg=q_seg, kv_seg=kv_seg)


def _torch(args):
    return {n: torch.from_numpy(a) for n, a in args.items()}


def _jnp(args):
    return {n: jnp.asarray(a) for n, a in args.items()}


PACKED_CASES = [
    # (segments (matched, n_new), H, KV, hd, q_len, window)
    ([(0, 20), (0, 13)], 4, 4, 16, 40, None),  # MHA, two recompute segments
    ([(24, 9), (0, 17), (40, 6)], 4, 2, 16, 40, None),  # GQA, partial-reuse offsets
    ([(8, 30), (0, 25)], 8, 2, 32, 64, 12),  # GQA + sliding window
    ([(16, 5)], 2, 1, 16, 8, None),  # one segment, MQA
]


@pytest.mark.parametrize("segs,H,KV,hd,q_len,window", PACKED_CASES)
def test_packed_plain_matches_reference(segs, H, KV, hd, q_len, window):
    args = _packed_inputs(segs, H, KV, hd, q_len, seed=len(segs) + H)
    got = ops.packed_attention(**_torch(args), causal=True, window=window).numpy()
    want = np.asarray(jref.packed_attention_ref(**_jnp(args), causal=True, window=window))
    pallas = np.asarray(pallas_packed(
        **_jnp(args), causal=True, window=window, interpret=True, block_q=16, block_kv=16,
    ))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    # padding queries and fully masked queries output zeros
    pad = args["q_seg"][0] < 0
    assert np.all(got[0, pad] == 0)


DECODE_CASES = [
    # (B, L, H, KV, hd, window, with kv_valid)
    (2, 40, 4, 2, 16, None, False),
    (1, 17, 8, 1, 32, None, True),
    (3, 64, 6, 6, 16, 9, False),
    (2, 48, 4, 4, 16, 20, True),
]


@pytest.mark.parametrize("B,L,H,KV,hd,window,valid", DECODE_CASES)
def test_decode_plain_matches_reference(B, L, H, KV, hd, window, valid):
    rng = np.random.default_rng(B * L + H)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    pos = rng.integers(L // 2, L, (B, 1)).astype(np.int32)
    pos[0, 0] = 0  # a sequence with one cached row
    idx = np.arange(L)[None]
    kv_pos = np.where(idx <= pos, idx, -1).astype(np.int32)
    kv_valid = rng.random((B, L)) > 0.3 if valid else None
    args = dict(q=q, k=k, v=v, q_pos=pos, kv_pos=kv_pos)
    extra_t = {} if kv_valid is None else {"kv_valid": torch.from_numpy(kv_valid)}
    extra_j = {} if kv_valid is None else {"kv_valid": jnp.asarray(kv_valid)}
    got = ops.decode_attention(**_torch(args), window=window, **extra_t).numpy()
    want = np.asarray(jref.attention_ref(
        **_jnp(args), causal=True, window=window, **extra_j))
    pallas = np.asarray(pallas_decode(
        **_jnp(args), window=window, interpret=True, block_kv=8, **extra_j))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_fully_masked_decode_query_outputs_zeros():
    q = torch.randn(1, 1, 2, 16)
    k = torch.randn(1, 8, 2, 16)
    kv_pos = torch.full((1, 8), -1, dtype=torch.int32)
    out = ops.decode_attention(q, k, k, q_pos=torch.zeros(1, 1, dtype=torch.int32),
                               kv_pos=kv_pos)
    assert torch.count_nonzero(out) == 0


FLASH_CASES = [
    # (B, Sq, Skv, H, KV, hd, causal, window, offset, kv_valid)
    (2, 24, 40, 4, 2, 16, True, None, 8, False),  # GQA suffix prefill, Sq < 128
    (1, 40, 64, 4, 4, 16, True, None, 0, False),  # full prefill, invalid tail rows
    (2, 33, 48, 8, 2, 32, True, 9, 5, False),  # sliding window
    (2, 12, 20, 4, 1, 16, False, None, 0, False),  # non-causal (cross-attention), MQA
    (1, 16, 32, 6, 3, 16, True, None, 4, True),  # kv_valid
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,offset,valid", FLASH_CASES)
def test_flash_plain_matches_reference(B, Sq, Skv, H, KV, hd, causal, window, offset, valid):
    """The per-request prefill's attention: queries at ``offset + i`` over a
    cache whose rows past ``offset + Sq`` carry kv_pos -1, as
    ``attention.prefill`` lays it out."""
    rng = np.random.default_rng(Sq * Skv + H)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    offs = np.array([offset + b for b in range(B)])[:, None]
    q_pos = (offs + np.arange(Sq)[None]).astype(np.int32)
    idx = np.arange(Skv)[None]
    if causal:
        kv_pos = np.where(idx < offs + Sq, idx, -1).astype(np.int32)
    else:
        kv_pos = np.broadcast_to(idx, (B, Skv)).astype(np.int32)
        q_pos[:] = 0
    assert (kv_pos < 0).any() or not causal
    args = dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
    kv_valid = rng.random((B, Skv)) > 0.3 if valid else None
    extra_t = {} if kv_valid is None else {"kv_valid": torch.from_numpy(kv_valid)}
    extra_j = {} if kv_valid is None else {"kv_valid": jnp.asarray(kv_valid)}
    got = ops.flash_attention(**_torch(args), causal=causal, window=window, **extra_t).numpy()
    want = np.asarray(jref.attention_ref(**_jnp(args), causal=causal, window=window, **extra_j))
    np.testing.assert_allclose(got, want, atol=ATOL)
    if kv_valid is None:  # the Pallas kernel takes no kv_valid
        pallas = np.asarray(pallas_flash(
            **_jnp(args), causal=causal, window=window, interpret=True, block_q=16,
            block_kv=16,
        ))
        np.testing.assert_allclose(got, pallas, atol=ATOL)


def _pool_case(lens, KV, hd, block, max_len, seed=0, H=None):
    """A random pool and block tables for ``lens`` live tokens per slot (the
    blocks scattered over the pool), plus the equivalent dense slotted cache
    of the same padded length, as ``tests/test_paged_decode.py`` builds it."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    nb = max_len // block
    n_blocks = 1 + B * nb
    pool_k = rng.standard_normal((n_blocks * block, KV, hd)).astype(np.float32)
    pool_v = rng.standard_normal((n_blocks * block, KV, hd)).astype(np.float32)
    tables = np.zeros((B, nb), np.int32)
    dense_k = np.zeros((B, max_len, KV, hd), np.float32)
    dense_v = np.zeros((B, max_len, KV, hd), np.float32)
    order = rng.permutation(np.arange(1, n_blocks))
    nxt = 0
    for b, L in enumerate(lens):
        for j in range(-(-L // block)):
            bid = order[nxt]
            tables[b, j] = bid
            rows = slice(bid * block, (bid + 1) * block)
            dense_k[b, j * block:(j + 1) * block] = pool_k[rows]
            dense_v[b, j * block:(j + 1) * block] = pool_v[rows]
            nxt += 1
    q_pos = np.array([[L - 1] for L in lens], np.int32)
    idx = np.arange(max_len, dtype=np.int32)[None]
    kv_pos = np.where(idx <= q_pos, idx, -1).astype(np.int32)
    q = rng.standard_normal((B, 1, H or 2 * KV, hd)).astype(np.float32)
    return dict(q=q, pool_k=pool_k, pool_v=pool_v, tables=tables, q_pos=q_pos,
                dense_k=dense_k, dense_v=dense_v, kv_pos=kv_pos)


def _paged_args(c):
    return (c["q"], c["pool_k"], c["pool_v"]), dict(block_table=c["tables"], q_pos=c["q_pos"])


@pytest.mark.parametrize("KV,window", [(4, None), (2, None), (2, 200)])
def test_paged_plain_matches_reference(KV, window):
    """Multi-block sequences, scattered blocks, table padding pointing at
    the dump block, against the jnp oracle and the Pallas kernel in
    interpret mode."""
    c = _pool_case([130, 257, 33], KV=KV, hd=16, block=128, max_len=384, seed=3)
    (q, kp, vp), kw = _paged_args(c)
    got = ops.paged_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        **{n: torch.from_numpy(a) for n, a in kw.items()}, block=128, window=window,
    ).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp)]
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    want = np.asarray(jref.paged_decode_ref(*jargs, **jkw, block=128, window=window))
    pallas = np.asarray(pallas_paged(*jargs, **jkw, block=128, window=window, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("KV,window", [(4, None), (2, None), (2, 96)])
def test_paged_plain_bit_identical_to_dense_plain(KV, window):
    """The port's paged plain version gathers the live blocks and attends:
    bitwise the port's dense plain decode over a slotted cache of the same
    padded length (the contract of ``tests/test_paged_decode.py``)."""
    c = _pool_case([5, 97, 128, 64], KV=KV, hd=16, block=32, max_len=128)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    paged_out = pdk.paged_decode_attention_plain(
        t["q"], t["pool_k"], t["pool_v"], block_table=t["tables"], q_pos=t["q_pos"],
        block=32, window=window,
    )
    dense_out = dk.decode_attention_plain(
        t["q"], t["dense_k"], t["dense_v"], q_pos=t["q_pos"], kv_pos=t["kv_pos"],
        window=window,
    )
    assert torch.equal(paged_out, dense_out)


def test_paged_plain_freed_slot_reads_the_dump_row():
    """A freed slot (zeroed table, position 0) attends row 0 of the dump
    block only, so its output is that row's V for every head."""
    c = _pool_case([40, 1], KV=2, hd=16, block=16, max_len=64, seed=4)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    t["tables"][1] = 0
    t["q_pos"][1] = 0
    out = ref.paged_decode_ref(t["q"], t["pool_k"], t["pool_v"], block_table=t["tables"],
                               q_pos=t["q_pos"], block=16)
    want = t["pool_v"][0].repeat_interleave(2, dim=0)  # [H, hd], G = 2
    assert torch.equal(out[1, 0], want)


WRAPPER_CALLS = {
    "packed": lambda a: pk.packed_flash_attention(**a),
    "decode": lambda a: dk.decode_attention(a["q"][:, :1], a["k"], a["v"],
                                            q_pos=a["q_pos"][:, :1], kv_pos=a["kv_pos"]),
    "flash": lambda a: fk.flash_attention(a["q"], a["k"], a["v"], q_pos=a["q_pos"],
                                          kv_pos=a["kv_pos"]),
    "paged": lambda a: pdk.paged_decode_attention(
        a["q"][:, :1], a["k"][0], a["v"][0], block_table=torch.zeros(1, 1, dtype=torch.int32),
        q_pos=a["q_pos"][:, :1], block=16),
}


def _launch_counts():
    return (pk.packed_flash_attention.launches, dk.decode_attention.launches,
            fk.flash_attention.launches, pdk.paged_decode_attention.launches)


@pytest.mark.parametrize("wrapper", ["packed", "decode", "flash", "paged"])
def test_kernel_wrappers_never_fall_back(wrapper):
    """A kernel wrapper given a CPU tensor raises: only ``ops`` picks the
    plain version, and only by the tensors' device."""
    args = _torch(_packed_inputs([(0, 8)], 2, 2, 32, 8, seed=0))
    before = _launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        WRAPPER_CALLS[wrapper](args)
    assert _launch_counts() == before


@pytest.mark.parametrize("nb,block", [(1, 1), (1, 16), (16, 16), (17, 16), (2, 128),
                                      (3, 128), (32, 128), (10, 96), (257, 1)])
def test_decode_part_count_depends_on_the_length_alone(nb, block):
    """Both decode kernels split a sequence's positions at the multiples of
    PART: over the same positions the dense and paged part counts agree,
    and they are ceil(length / PART)."""
    L = nb * block
    parts = dk.part_count(L)
    assert pdk.part_count(nb, block) == parts
    assert (parts - 1) * dk.PART < L <= parts * dk.PART
    assert pdk.part_count(L, 1) == pdk.part_count(1, L) == parts


def test_decode_part_is_the_kernels_constant():
    """The wrappers size the partials' scratch from ``PART``; the CUDA body
    splits at its own PART, and the launchers refuse a count off it."""
    src = (build.CSRC / "decode_block.cuh").read_text()
    assert f"constexpr int PART = {dk.PART};" in src


@pytest.mark.parametrize("L", [1, 255, 256, 257, 513, 2000, 4096])
@pytest.mark.parametrize("B,H,P,S", [(1, 64, 64, 128), (2, 6, 5, 7)])
def test_ssd_scratch_depends_on_the_shapes_alone(L, B, H, P, S):
    """The bf16 SSD kernels split L tokens into chunks of CHUNK from token
    0, and the wrapper's scratch holds each chunk's f32 state [P, S rounded
    up to 16] and its decay for every (batch, head): both follow from the
    shapes alone, never from the data or the caller's chunk."""
    n = ssk.chunk_count(L)
    assert (n - 1) * ssk.CHUNK < L <= n * ssk.CHUNK
    s16 = -(-S // 16) * 16
    assert s16 % 16 == 0 and S <= s16 < S + 16
    assert ssk.scratch_floats(B, L, H, P, S) == B * H * n * (P * s16 + 1)


def test_ssd_chunk_is_the_kernels_constant():
    """The wrapper sizes the scratch from CHUNK; the kernels split at their
    own ssd::CHUNK, and the launcher refuses a chunk count off it."""
    src = (build.CSRC / "ssd_scan.cu").read_text()
    assert f"constexpr int CHUNK = {ssk.CHUNK};" in src


@pytest.mark.parametrize("B,L,H,P,G,S", [(2, 2048, 64, 64, 1, 128), (1, 2048, 128, 128, 1, 16),
                                         (1, 37, 3, 20, 3, 24), (2, 129, 12, 256, 2, 256)])
def test_ssd_backward_scratch_depends_on_the_shapes_alone(B, L, H, P, G, S):
    """The SSD backward's scratch (``csrc/ssd_backward.cu``'s layouts), a
    function of the shapes and the dtype alone: f32 keeps each chunk's M and
    dM; bf16 holds the two states, cum and dt, the d dt terms and the
    slices' dB and dC partials, and no [CHUNK, CHUNK] matrix."""
    from repro_torch.kernels import ssd_backward as sbk

    n = ssk.chunk_count(L)
    s16 = -(-S // 16) * 16
    bhn = B * H * n
    states = 2 * bhn * P * s16
    slices = -(-(H // G) // sbk.SLICE_HEADS)
    terms = 4 + -(-P // 64) + -(-s16 // 64)
    assert sbk.scratch_floats(B, L, H, P, G, S, torch.float32) == (
        states + bhn * (2 * ssk.CHUNK * ssk.CHUNK + 2 * ssk.CHUNK + 2))
    assert sbk.scratch_floats(B, L, H, P, G, S, torch.bfloat16) == (
        states + bhn * (2 + (2 + terms) * ssk.CHUNK) + 2 * slices * B * L * G * S)


def test_ssd_backward_tiles_are_the_kernels_constants():
    """The wrapper sizes the backward's scratch from ``SLICE_HEADS`` and the
    64-wide P and S tiles; the bf16 kernels split at their own HEADS, PW and
    KW, and the launcher refuses a scratch size off its own count."""
    from repro_torch.kernels import ssd_backward as sbk

    src = (build.CSRC / "ssd_backward.cu").read_text()
    assert f"constexpr int HEADS = {sbk.SLICE_HEADS};" in src
    assert "constexpr int KW = 64;" in src
    assert "constexpr int PW = 64;" in (build.CSRC / "ssd_scan.cu").read_text()


def test_library_name_tracks_sources():
    """Each kernel builds into its own library whose name carries a hash of
    its sources and flags, under the gitignored build directory."""
    paths = {n: build.library_path(n) for n in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    for name, path in paths.items():
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
