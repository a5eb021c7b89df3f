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
from repro.kernels.packed_prefill import packed_flash_attention as pallas_packed  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import packed_prefill as pk  # noqa: E402

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


@pytest.mark.parametrize("wrapper", ["packed", "decode"])
def test_kernel_wrappers_never_fall_back(wrapper):
    """A kernel wrapper given a CPU tensor raises: only ``ops`` picks the
    plain version, and only by the tensors' device."""
    args = _torch(_packed_inputs([(0, 8)], 2, 2, 32, 8, seed=0))
    before = (pk.packed_flash_attention.launches, dk.decode_attention.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "packed":
            pk.packed_flash_attention(**args)
        else:
            dk.decode_attention(args["q"][:, :1], args["k"], args["v"],
                                q_pos=args["q_pos"][:, :1], kv_pos=args["kv_pos"])
    assert (pk.packed_flash_attention.launches, dk.decode_attention.launches) == before


def test_library_name_tracks_sources():
    """Each kernel builds into its own library whose name carries a hash of
    its sources and flags, under the gitignored build directory."""
    paths = {n: build.library_path(n) for n in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    for name, path in paths.items():
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
