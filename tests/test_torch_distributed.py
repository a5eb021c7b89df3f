"""The port's collectives on the CPU: gloo ranks spawned from the test
(``torch_dist_ranks.spawn``, one spawn of four ranks for the module), held
to the JAX package.

  * ``compressed_pmean`` over groups of 1, 2 and 4 ranks: equal to its
    formula in numpy on the stacked rank inputs, within the reference's
    error bound of the exact mean, and at one rank within one quantum of
    the reference's ``shard_map`` call (``tests/test_training.py::
    test_compressed_pmean_error_bound``); ``make_compressed_grad_sync``
    over the pod axis of a (pod 2, data 2) mesh, and the identity on a mesh
    with no pod axis;
  * the KV-length-sharded ``flash_attention`` and ``decode_attention``
    (``kv_group``) over 2 and 4 ranks against ``ref.attention_ref`` and the
    reference's ``_flash_pieces`` combine at 2e-5, with a window that
    empties whole shards and rows that keep no key anywhere; over one rank
    the unsharded attention's bits; and the one-process merge of the
    pieces, the replay of ``tests/test_kernels.py::test_kvshard_combine``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ops import _flash_pieces  # noqa: E402
from repro.training.compression import compressed_pmean as jcompressed_pmean  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

# the reference's kernel tolerance (tests/test_kernels.py), f32
ATOL = 2e-5
WORLD = 4


def _grads():
    """Each rank's gradient [64, 64] f32, each at its own scale."""
    rng = np.random.default_rng(0)
    return np.stack([rng.standard_normal((64, 64)) * (1.0 + r) for r in range(WORLD)]
                    ).astype(np.float32)


def _positions(B, n, start=0):
    return np.broadcast_to(np.arange(n, dtype=np.int32) + start, (B, n)).copy()


ATTENTION = {
    # name: (Sq, q offset, causal, window, decode, rows of batch 1 never written)
    "causal": (24, 40, True, None, False, False),
    "window": (24, 40, True, 20, False, False),  # shard 0 of 4 keeps no key of any row
    "non-causal": (24, 0, False, None, False, False),
    "no-key-anywhere": (24, 40, True, 20, False, True),
    "decode": (1, 63, True, None, True, False),
    "decode-window": (1, 63, True, 20, True, False),
}


def _attention_case(name, seed=1):
    Sq, off, causal, window, decode, unwritten = ATTENTION[name]
    B, Skv, H, KV, hd = 2, 64, 4, 2, 16
    rng = np.random.default_rng(seed)
    kv_pos = _positions(B, Skv)
    if unwritten:  # batch 1's rows are never written: its queries keep nothing
        kv_pos[1] = -1
    return dict(q=rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
                k=rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
                v=rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
                q_pos=_positions(B, Sq, off), kv_pos=kv_pos, causal=causal, window=window,
                decode=decode)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = dict(grads=_grads(), attention={n: _attention_case(n) for n in ATTENTION})
    return inputs, spawn("collectives", WORLD, tmp_path_factory.mktemp("collectives"), inputs)


# --------------------------------------------------------------------------- #
# compressed_pmean
# --------------------------------------------------------------------------- #
def _formula(xs):
    """The int8 mean of the stacked rank inputs, in numpy f32."""
    amax = np.float32(np.abs(xs).max())
    scale = np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
    q = np.clip(np.round(xs / scale), -127, 127).astype(np.int8)
    total = q.astype(np.int32).sum(0)
    return (total.astype(np.float32) * scale / np.float32(len(xs))).astype(np.float32), scale


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_pmean_is_its_formula(ranks, n):
    inputs, outs = ranks
    want, _ = _formula(inputs["grads"][:n])
    for r in range(n):
        np.testing.assert_array_equal(outs[r][("pmean", n)], want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_pmean_error_bound(ranks, n):
    """|err| <= scale against the exact mean, scale = max|g| / 127 (each
    rank's rounding moves its term by at most scale / 2)."""
    inputs, outs = ranks
    xs = inputs["grads"][:n]
    scale = float(np.abs(xs).max()) / 127.0
    err = np.abs(outs[0][("pmean", n)] - xs.astype(np.float64).mean(0)).max()
    assert err <= scale + 1e-6, (err, scale)


def test_compressed_pmean_one_rank_matches_reference(ranks):
    """At one rank, within one quantum of the reference's ``shard_map``
    call over a one-device ``pod`` axis (XLA may divide by 127 as a
    multiplication by its reciprocal: ROADMAP C3)."""
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_mesh_compat

    inputs, outs = ranks
    g = jnp.asarray(inputs["grads"][0])
    mesh = make_mesh_compat((1,), ("pod",))
    with mesh:
        want = jax.shard_map(lambda x: jcompressed_pmean(x, "pod"), mesh=mesh, in_specs=P(),
                             out_specs=P(), check_vma=False)(g)
    scale = float(jnp.max(jnp.abs(g))) / 127.0
    assert np.abs(outs[0][("pmean", 1)] - np.asarray(want)).max() <= scale


def test_compressed_grad_sync_over_pod_axis(ranks):
    """Over a (pod 2, data 2) mesh each leaf's mean is taken across the two
    pods (ranks r and r + 2), through the int8 format; a mesh with no pod
    axis leaves the tree as it is."""
    inputs, outs = ranks
    for r in range(WORLD):
        pod = outs[r]["pod_ranks"]
        assert pod == [r % 2, r % 2 + 2], pod
        want, _ = _formula(inputs["grads"][pod])
        np.testing.assert_array_equal(outs[r]["sync"]["w"], want)
        want_b, _ = _formula(inputs["grads"][pod][:, 0])
        np.testing.assert_array_equal(outs[r]["sync"]["b"][0], want_b)
        assert outs[r]["no_pod_is_identity"]


# --------------------------------------------------------------------------- #
# KV-length-sharded attention
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _reference(name):
    c = _attention_case(name)
    return np.asarray(jref.attention_ref(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        q_pos=jnp.asarray(c["q_pos"]), kv_pos=jnp.asarray(c["kv_pos"]), causal=c["causal"],
        window=c["window"]))


def _reference_combine(c, n):
    """The reference's merge of ``_flash_pieces`` over ``n`` shards."""
    q, k, v = jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"])
    rows = k.shape[1] // n
    pieces = [_flash_pieces(q, k[:, i * rows:(i + 1) * rows], v[:, i * rows:(i + 1) * rows],
                            jnp.asarray(c["q_pos"]),
                            jnp.asarray(c["kv_pos"][:, i * rows:(i + 1) * rows]),
                            causal=c["causal"], window=c["window"], q_chunk=8)
              for i in range(n)]
    m_glob = jnp.max(jnp.stack([m for m, _, _ in pieces]), 0)
    l_glob = sum(l * jnp.exp(m - m_glob) for m, l, _ in pieces)
    o_glob = sum(o * jnp.exp(m - m_glob)[..., None] for m, _, o in pieces)
    return np.asarray(o_glob / jnp.maximum(l_glob, 1e-30)[..., None])


@pytest.mark.parametrize("name", sorted(ATTENTION))
@pytest.mark.parametrize("n", [2, 4])
def test_kv_sharded_attention_matches_reference(ranks, n, name):
    _, outs = ranks
    c = _attention_case(name)
    want, combined = _reference(name), _reference_combine(c, n)
    for r in range(n):
        got = outs[r][("attention", n, name)]
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got, combined, atol=ATOL, err_msg=f"rank {r}")
    if name == "no-key-anywhere":
        assert not np.abs(outs[0][("attention", n, name)][1]).any()


def test_kv_sharded_window_empties_whole_shards():
    """The window case's first shard of four keeps no key of any row, so its
    pieces' lse is -inf everywhere and it weighs 0 in the merge."""
    c = _attention_case("window")
    t = {k: torch.from_numpy(c[k][:, :16]) for k in ("k", "v", "kv_pos")}
    out, lse = ops.flash_pieces(torch.from_numpy(c["q"]), t["k"], t["v"],
                                q_pos=torch.from_numpy(c["q_pos"]), kv_pos=t["kv_pos"],
                                causal=True, window=c["window"])
    assert torch.isinf(lse).all() and not out.abs().any()


@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_kv_sharded_over_one_rank_gives_the_unsharded_bits(ranks, name):
    """Over a single-rank group the merge's weight is exactly 1: the output
    is the unsharded attention's (``ops.flash_attention`` or
    ``ops.decode_attention`` on the same CPU tensors), bit for bit."""
    inputs, outs = ranks
    c = inputs["attention"][name]
    t = {k: torch.from_numpy(c[k]) for k in ("q", "k", "v", "q_pos", "kv_pos")}
    kw = dict(q_pos=t["q_pos"], kv_pos=t["kv_pos"], window=c["window"])
    if c["decode"]:
        want = ops.decode_attention(t["q"], t["k"], t["v"], **kw)
    else:
        want = ops.flash_attention(t["q"], t["k"], t["v"], causal=c["causal"], **kw)
    np.testing.assert_array_equal(outs[0][("attention", 1, name)], want.numpy())


def test_kvshard_combine():
    """Splitting the kv rows into shards and merging each shard's (out,
    lse) equals the attention oracle, as the reference's (m, l, o) merge
    does (``tests/test_kernels.py::test_kvshard_combine``, its inputs)."""
    B, Sq, Skv, H, KV, hd = 2, 24, 64, 4, 2, 16
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    q_pos, kv_pos = _positions(B, Sq, Skv - Sq), _positions(B, Skv)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                                         causal=True, window=20))
    shards, piece = 4, Skv // 4
    outs, lses = [], []
    for i in range(shards):
        sl = slice(i * piece, (i + 1) * piece)
        o, lse = ops.flash_pieces(torch.from_numpy(q), torch.from_numpy(k[:, sl]),
                                  torch.from_numpy(v[:, sl]), q_pos=torch.from_numpy(q_pos),
                                  kv_pos=torch.from_numpy(kv_pos[:, sl]), causal=True,
                                  window=20)
        outs.append(o)
        lses.append(lse)
    got = ops.combine_pieces(outs, lses)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert got.dtype == torch.float32


def test_kv_sharded_route_has_no_gradient():
    c = _attention_case("causal")
    q = torch.from_numpy(c["q"]).requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        ops.flash_attention(q, torch.from_numpy(c["k"]), torch.from_numpy(c["v"]),
                            q_pos=torch.from_numpy(c["q_pos"]),
                            kv_pos=torch.from_numpy(c["kv_pos"]), kv_group=object())
