"""The port's int8 storage tier against the JAX package's.

On the CPU, ``kv_quant`` / ``kv_dequant`` run their plain PyTorch versions.
These tests hold them against ``repro.kernels.ref`` and the Pallas kernels
in interpret mode on the same numpy inputs, in the int8 bytes, the scales
and the dequantised values exactly (bit for bit: the quantiser is one
amax, one IEEE division and a half-to-even rounding in both packages).
Then ``compress_tree`` / ``decompress_tree`` against the reference's
``CompressedArray`` fields, the tiered store's compressed scenarios of
``tests/test_kv_store.py`` and ``tests/test_hierarchy.py`` replayed against
the reference's store, and the engine's compressed case of
``tests/test_serving.py`` replayed against the JAX engine.  The CUDA
kernels run only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.core.pricing import AWS_PAPER as JAWS_PAPER  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.kv_quant import kv_dequant as pallas_dequant  # noqa: E402
from repro.kernels.kv_quant import kv_quant as pallas_quant  # noqa: E402
from repro.kvcache import compression as jcompression  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro_torch.core.pricing import AWS_PAPER, GB  # noqa: E402
from repro_torch.kernels import kv_quant as kq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kvcache import compression, hierarchy, paged  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AlwaysReusePlanner,
    EngineConfig,
    Request,
    ServingEngine,
)
from test_torch_engine import ENGINE_KW, _close, _reference_perf_and_pricing, _setup  # noqa: E402

torch.set_num_threads(1)
SHAPES = [(8, 16), (3, 5, 32), (2, 7, 4, 64), (2, 3, 5, 80)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bits(a) -> np.ndarray:
    """The bit pattern of a float array (bf16 as uint16, f32 as uint32)."""
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _inputs(shape, dtype, seed=0):
    """The same values as a torch tensor and a jnp array: f32, or rounded to
    bf16 (nearest even) by each package from the same f32 draw."""
    x = _x(shape, seed)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        t, j = t.bfloat16(), j.astype(jnp.bfloat16)
        assert (_bits(paged.to_host(t)) == _bits(j)).all()
    return t, j


# --------------------------------------------------------------------------- #
# The plain kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_plain_matches_ref_and_pallas_exactly(shape, dtype):
    """The int8 bytes and the scales equal the reference's bit for bit.
    Against the Pallas kernel in interpret mode: under jit, XLA divides by
    127 as a product with its reciprocal, one ulp off the division in some
    rows (the eager reference, which the reference's engine runs on the CPU,
    and the port divide).  So its scales are held at the reference's own
    rtol 1e-6 (``tests/test_kernels.py``), its int8 bytes equal the port's
    exactly in every row whose scale is the same, and in every row they
    equal the port's quantiser applied with the Pallas kernel's scale."""
    t, j = _inputs(shape, dtype)
    q, s = kq.kv_quant_plain(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == shape[:-1] + (1,)
    jq, js = jref.kv_quant_ref(j)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(s.numpy()), _bits(js))
    pq, ps = (np.asarray(a) for a in pallas_quant(j, interpret=True, block_rows=4))
    np.testing.assert_allclose(s.numpy(), ps, rtol=1e-6)
    same = (_bits(s.numpy()) == _bits(ps))[..., 0]
    assert np.array_equal(q.numpy()[same], pq[same])
    with_ps = torch.round(t.float() / torch.tensor(ps)).clamp(-127, 127).to(torch.int8)
    assert np.array_equal(with_ps.numpy(), pq)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_dequant_plain_matches_ref_and_pallas_exactly(shape, out):
    q, s = jref.kv_quant_ref(jnp.asarray(_x(shape, seed=1)))
    got = kq.kv_dequant_plain(torch.tensor(np.asarray(q)), torch.tensor(np.asarray(s)),
                              getattr(torch, out))
    got = paged.to_host(got)
    jdtype = getattr(jnp, out)
    for want in (jref.kv_dequant_ref(q, s, dtype=jdtype),
                 pallas_dequant(q, s, dtype=jdtype, interpret=True, block_rows=4)):
        assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_uint16_host_leaf_quantises_as_bf16(shape):
    """The host's bf16 pattern (``uint16``) quantises as the bf16 values it
    holds: the int8 bytes and scales of the reference on its bf16 array."""
    t, j = _inputs(shape, "bfloat16", seed=2)
    (c,) = compression.compress_tree((paged.to_host(t),))
    jq, js = jref.kv_quant_ref(j)
    assert c.orig_dtype == "bfloat16"
    assert np.array_equal(c.q, np.asarray(jq)) and np.array_equal(_bits(c.scale), _bits(js))


def test_ops_dispatch_by_device_with_no_head_dim_threshold():
    """A CPU tensor takes the plain version at any head_dim (the reference's
    ``hd >= 8`` threshold does not carry over); the CUDA wrappers refuse a
    CPU tensor instead of falling back."""
    x = torch.from_numpy(_x((5, 3)))
    q, s = ops.kv_quant(x)
    rq, rs = ref.kv_quant_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(ops.kv_dequant(q, s, torch.float32), ref.kv_dequant_ref(q, s, torch.float32))
    before = (kq.kv_quant.launches, kq.kv_dequant.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kq.kv_quant(x)
    with pytest.raises(ValueError, match="CUDA"):
        kq.kv_dequant(q, s)
    assert (kq.kv_quant.launches, kq.kv_dequant.launches) == before


@settings(max_examples=30, deadline=None, database=None, derandomize=True)
@given(rows=st.integers(1, 12), hd=st.integers(1, 300), scale=st.floats(0.01, 100.0))
@example(rows=3, hd=255, scale=14.0)  # a value at exactly 76.5 scales: error scale / 2
def test_quant_error_bound(rows, hd, scale):
    """``tests/test_kv_store.py``'s property, at any head_dim: every value
    comes back within half its row's scale, plus one f32 ulp of the row's
    largest |x| for the rounding of the dequantised ``q * scale``."""
    rng = np.random.default_rng(rows * 1000 + hd)
    x = torch.from_numpy((rng.standard_normal((rows, hd)) * scale).astype(np.float32))
    c = compression.compress_tree({"x": x})
    y = compression.decompress_tree(c, "cpu")["x"]
    ulp = np.spacing(np.abs(x.numpy()).max(axis=1, keepdims=True))
    bound = compression.max_abs_error_bound(x).numpy()[:, None] + ulp
    assert (np.abs(y - x.numpy()) <= bound).all()


# --------------------------------------------------------------------------- #
# Compressed trees
# --------------------------------------------------------------------------- #
def _tree(dtype):
    """A two-leaf KV tree with a ``pos`` leaf, as the port and the reference
    hold it on the host (bf16 as ``uint16`` on the port's side)."""
    k, jk = _inputs((2, 1, 24, 2, 16), dtype, seed=3)
    v, jv = _inputs((2, 1, 24, 2, 16), dtype, seed=4)
    pos = np.array([24], np.int32)
    host = paged.to_host if dtype == "bfloat16" else (lambda t: t.numpy())
    return ({"k": host(k), "v": host(v), "pos": pos},
            {"k": np.asarray(jk), "v": np.asarray(jv), "pos": pos})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_tree_gives_the_reference_fields(dtype):
    tree, jtree = _tree(dtype)
    got, want = compression.compress_tree(tree), jcompression.compress_tree(jtree)
    for name in ("k", "v"):
        g, w = got[name], want[name]
        assert type(g).__name__ == type(w).__name__ == "CompressedArray"
        assert g.orig_dtype == w.orig_dtype == dtype
        assert np.array_equal(g.q, w.q) and g.q.dtype == w.q.dtype == np.int8
        assert np.array_equal(_bits(g.scale), _bits(w.scale))
        assert g.nbytes == w.nbytes
    assert np.array_equal(got["pos"], want["pos"])
    assert compression.tree_nbytes(got) == jcompression.tree_nbytes(want)
    assert compression.tree_nbytes(tree) == jcompression.tree_nbytes(jtree)
    back, jback = compression.decompress_tree(got, "cpu"), jcompression.decompress_tree(want)
    for name in ("k", "v"):
        assert back[name].dtype == (np.uint16 if dtype == "bfloat16" else np.float32)
        assert np.array_equal(_bits(back[name]), _bits(jback[name]))
    assert np.array_equal(back["pos"], jback["pos"])


def test_bf16_artifact_is_compressed_not_passed_through():
    """A bf16 artifact on the host (``uint16``) is quantised, at about half
    its bytes (``tests/test_kv_store.py:143-147``), and an LMState keeps its
    type through the round trip."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 256, 128))).bfloat16()
    c = compression.compress_tree({"x": paged.to_host(x)})
    assert isinstance(c["x"], compression.CompressedArray)
    assert compression.tree_nbytes(c) / (x.numel() * 2) < 0.6
    art = paged.LMState(pos=np.array([256], np.int32), caches=(paged.BlockCache(
        paged.KVCache(paged.to_host(x[None]), paged.to_host(x[None]))),))
    back = compression.decompress_tree(compression.compress_tree(art), "cpu")
    assert type(back) is paged.LMState and type(back.caches[0].attn) is paged.KVCache
    assert back.caches[0].attn.k.dtype == np.uint16


# --------------------------------------------------------------------------- #
# The tiered store
# --------------------------------------------------------------------------- #
def _entries(store):
    return sorted((e.entry_id, e.tier, e.nbytes, e.compressed)
                  for e in store.entries.values())


def test_store_compressed_roundtrip_error_bounded():
    """``tests/test_kv_store.py:112-124`` on both stores: the entry is stored
    compressed, smaller than the f32 payload, with the reference's nbytes,
    and the fetched rows come back within half a scale."""
    x = np.random.default_rng(0).standard_normal((2, 8, 16)).astype(np.float32)
    stores = [mod.TieredStore(tier_capacities_gb={"io2": 1.0}, chunk_tokens=4,
                              compress_tier="io2", **kw)
              for mod, kw in ((hierarchy, dict(device="cpu")), (jhierarchy, {}))]
    (s, js) = stores
    eid, _ = s.put(list(range(8)), {"k": x}, tier="io2")
    jeid, _ = js.put(list(range(8)), {"k": x}, tier="io2")
    e = s.entries[eid]
    assert e.compressed and e.nbytes < x.nbytes
    assert _entries(s) == _entries(js)
    got, _ = s.fetch(eid)
    jgot, _ = js.fetch(jeid)
    scale = np.abs(x).max(-1, keepdims=True) / 127
    assert (np.abs(got["k"] - x) <= scale / 2 + 1e-6).all()
    assert np.array_equal(got["k"], np.asarray(jgot["k"]))


def _spill_stores(art, s3_cap_bytes, packed):
    """The reference test's two-tier store on both sides, one entry in io2."""
    out = []
    for mod, pricing, kw in ((hierarchy, AWS_PAPER, dict(device="cpu")),
                             (jhierarchy, JAWS_PAPER, {})):
        s = mod.TieredStore(
            tiers=[mod.TierSpec("io2", (packed + 1) / GB), mod.TierSpec("s3", s3_cap_bytes / GB)],
            chunk_tokens=4, compress_tier="io2", spill_on_pressure=True, pricing=pricing, **kw)
        s.put(list(range(8)), dict(art), tier="io2")
        out.append(s)
    return out


@pytest.mark.parametrize("room", ["decompressed", "packed_only"])
def test_spill_out_of_compress_tier_replays_reference(room):
    """``tests/test_hierarchy.py:390-425`` on both stores: with room below
    for the decompressed bytes the spill dequantises the entry (on the
    store's device) and inflates it; with room only for the packed bytes,
    the entry is evicted in place and the bystander below stays.  Entries,
    tiers, nbytes, flags, evictions and migrations agree."""
    art = {"k": np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)}
    probe = hierarchy.TieredStore(tiers=[hierarchy.TierSpec("io2", 1.0)], chunk_tokens=4,
                                  compress_tier="io2", device="cpu")
    eid, _ = probe.put(list(range(8)), dict(art), tier="io2")
    packed, raw = probe.entries[eid].nbytes, 4 * 64 * 4
    stores = _spill_stores(art, raw + 64 if room == "decompressed" else packed + 1, packed)
    for s in stores:
        if room == "packed_only":
            s.put(list(range(200, 208)), {"k": np.zeros((1, packed // 4), np.float32)}, tier="s3")
        s.put(list(range(100, 108)), dict(art), tier="io2")
    s, js = stores
    assert _entries(s) == _entries(js)
    assert (s.evictions, s.rejected_puts) == (js.evictions, js.rejected_puts)
    migs = [dataclasses.astuple(m) for m in s.drain_migrations()]
    assert migs == [dataclasses.astuple(m) for m in js.drain_migrations()]
    if room == "decompressed":
        (moved,) = [e for e in s.entries.values() if e.tier == "s3"]
        assert not moved.compressed and moved.nbytes >= raw and s.evictions == 0
        payload = s.backends["s3"].peek(moved.entry_id)
        assert isinstance(payload["k"], np.ndarray) and payload["k"].dtype == np.float32
    else:
        assert s.evictions == 1 and len(s.entries) == 2


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


def test_compressed_tier_close_but_cheaper_replays_reference(llama):
    """``tests/test_serving.py:131-141`` on both engines: four requests over
    one context, always reusing from the int8 tier.  The stored entry is
    compressed with the reference's nbytes, and the tokens, every record
    field, the summary and the event stream equal the JAX engine's."""
    jcfg, jparams, cfg, params = llama
    rng = np.random.default_rng(0)
    ctx = list(map(int, rng.integers(0, cfg.vocab, 64)))
    reqs = [dict(req_id=i, context_tokens=ctx,
                 prompt_tokens=list(map(int, rng.integers(0, cfg.vocab, 8))),
                 max_new_tokens=4, arrival_s=i * 0.01, expected_reuses=4) for i in range(4)]
    perf, pricing = _reference_perf_and_pricing()
    kw = dict(ENGINE_KW, compress_tier="io2")
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**kw), planner=AlwaysReusePlanner(),
                        perf=perf, pricing=pricing, device="cpu")
    jeng = jserving.ServingEngine(jcfg, jparams, engine_cfg=jserving.EngineConfig(**kw),
                                  planner=jserving.AlwaysReusePlanner())
    events, jevents = [], []
    for e, make, out in ((eng, Request, events), (jeng, jserving.Request, jevents)):
        for r in reqs:
            e.submit(make(**r))
        while not e.idle:
            out.extend(e.step())
    assert eng.summary().reuse_hits >= 2
    (entry,) = eng.store.entries.values()
    assert entry.compressed
    assert _entries(eng.store) == _entries(jeng.store)
    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    _close(eng.summary().as_dict(), jeng.summary().as_dict(), "summary")
    _close(events, jevents, "events")
