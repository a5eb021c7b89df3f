"""The port's dense decoder against ``repro.models.lm`` on the same weights.

Weights come from ``api.init(jax.random.PRNGKey(0), cfg)`` through
``repro_torch.models.convert.from_jax_params``; both sides run in f32 on the
CPU (the JAX side on its reference attention, the port on its kernels'
plain versions).  Logits and KV rows are held at atol 1e-4; greedy tokens
must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kvcache import compression, faults, paged  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.blocks import BlockCache  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
ARCHS = ["llama-7b", "qwen2-1.5b"]
MAX_LEN = 128


def _setup(arch):
    jcfg = jreduced(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _port_artifact(jart):
    """The reference's host artifact as the port's tree (same arrays)."""
    c = jart.caches[0].attn
    return lm.LMState(pos=np.asarray(jart.pos),
                      caches=(BlockCache(KVCache(np.asarray(c.k), np.asarray(c.v))),))


def _packed_both(arch):
    """Two segments packed at a partial-reuse offset (the shape of
    tests/test_packed.py's model-level case): segment 0 recomputes a
    48-token context + 8-token prompt, segment 1 reuses 32 stored rows and
    prefills 16 context + 8 prompt tokens."""
    jcfg, jparams, cfg, params = _setup(arch)
    rng = np.random.default_rng(2)
    ctx0 = list(map(int, rng.integers(0, cfg.vocab, 48)))
    ctx1 = ctx0[:32] + list(map(int, rng.integers(0, cfg.vocab, 16)))
    pr0 = list(map(int, rng.integers(0, cfg.vocab, 8)))
    pr1 = list(map(int, rng.integers(0, cfg.vocab, 8)))
    st = jlm.init_state(jcfg, 1, MAX_LEN)
    _, st = jlm.prefill(jparams, jcfg, jnp.asarray([ctx0], jnp.int32), st)
    jart = jpaged.extract_slot(jcfg, st, 0, 48)

    layout = jpaged.pack_layout([0, 1], [0, 32], [56, 24], align=128)
    arrays = jpaged.pack_arrays(layout, [ctx0 + pr0, ctx1[32:] + pr1])
    last = [s.q_last for s in layout.segments]
    jlogits, jcaches = jlm.prefill_packed(
        jparams, jcfg, jnp.asarray(arrays["tokens"]),
        jpaged.build_packed_caches(jcfg, layout, [None, jart]),
        q_pos=jnp.asarray(arrays["q_pos"]), q_seg=jnp.asarray(arrays["q_seg"]),
        q_rows=jnp.asarray(arrays["q_rows"]), kv_pos=jnp.asarray(arrays["kv_pos"]),
        kv_seg=jnp.asarray(arrays["kv_seg"]), last_idx=jnp.asarray(last, jnp.int32),
    )

    tlayout = paged.pack_layout([0, 1], [0, 32], [56, 24], align=128)
    assert dataclasses.asdict(tlayout) == dataclasses.asdict(layout)
    tarrays = paged.pack_arrays(tlayout, [ctx0 + pr0, ctx1[32:] + pr1])
    t = {n: torch.from_numpy(a) for n, a in tarrays.items()}
    tcaches = paged.build_packed_caches(cfg, tlayout, [None, _port_artifact(jart)], "cpu")
    logits, tcaches = lm.prefill_packed(
        params, cfg, t["tokens"], tcaches, q_pos=t["q_pos"], q_seg=t["q_seg"],
        q_rows=t["q_rows"], kv_pos=t["kv_pos"], kv_seg=t["kv_seg"],
        last_idx=torch.tensor(last),
    )
    return (jcfg, jparams, jlogits, jcaches), (cfg, params, logits, tcaches), layout


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_packed_and_decode_match_reference(arch):
    (jcfg, jparams, jlogits, jcaches), (cfg, params, logits, tcaches), layout = (
        _packed_both(arch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    assert logits.argmax(-1).tolist() == np.asarray(jlogits).argmax(-1).tolist()
    for seg in layout.segments:
        want = jpaged.packed_to_artifact(jcfg, jcaches, seg, seg.n_total)
        got = paged.artifact_to_host(paged.packed_to_artifact(cfg, tcaches, seg, seg.n_total))
        for g, w in ((got.caches[0].attn.k, want.caches[0].attn.k),
                     (got.caches[0].attn.v, want.caches[0].attn.v)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)

    # install both segments into a dense 2-slot state, then greedy decode
    jstate = jlm.init_state(jcfg, 2, MAX_LEN)
    tstate = lm.init_state(cfg, 2, MAX_LEN, device="cpu")
    for seg in layout.segments:
        jstate = jpaged.insert_slot(
            jcfg, jstate, seg.slot, jpaged.packed_to_artifact(jcfg, jcaches, seg, seg.n_total))
        paged.insert_slot(
            cfg, tstate, seg.slot, paged.packed_to_artifact(cfg, tcaches, seg, seg.n_total))
    toks = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jl, jstate = jlm.decode(jparams, jcfg, jnp.asarray(toks), jstate)
        tl, tstate = lm.decode(params, cfg, torch.from_numpy(toks), tstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
        toks = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    assert tstate.pos.tolist() == np.asarray(jstate.pos).tolist()
    for seg in layout.segments:
        n = seg.n_total + 3
        want = jpaged.extract_slot(jcfg, jstate, seg.slot, n)
        got = paged.extract_slot(cfg, tstate, seg.slot, n)
        np.testing.assert_allclose(got.caches[0].attn.k, want.caches[0].attn.k, atol=ATOL)
        np.testing.assert_allclose(got.caches[0].attn.v, want.caches[0].attn.v, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for reduce in (False, True):
        jcfg, cfg = jget_config(arch), get_config(arch)
        if reduce:
            jcfg, cfg = jreduced(jcfg), reduced_config(cfg)
        assert registry.count_params(cfg) == jregistry.count_params(jcfg)
        assert registry.count_active_params(cfg) == jregistry.count_active_params(jcfg)


def test_artifact_tree_matches_reference_bytes_and_checksum():
    """A stored artifact is the reference's tree: the same arrays in the
    port's tree give the same byte count and the same content checksum."""
    jcfg = jreduced(jget_config("llama-7b"))
    rng = np.random.default_rng(0)
    st = jlm.init_state(jcfg, 2, 32)
    k = rng.standard_normal(st.caches[0].attn.k.shape).astype(np.float32)
    jst = st._replace(caches=(st.caches[0]._replace(attn=st.caches[0].attn._replace(
        k=jnp.asarray(k), v=jnp.asarray(-k))),))
    jart = jpaged.extract_slot(jcfg, jst, 1, 20)
    art = _port_artifact(jart)
    assert compression.tree_nbytes(art) == sum(
        np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(jart))
    assert faults.payload_checksum(art) == jfaults.payload_checksum(jart)

    # the port's own extract of the same state is the same tree
    cfg = reduced_config(get_config("llama-7b"))
    tst = lm.init_state(cfg, 2, 32, device="cpu")
    tst.caches[0].attn.k.copy_(torch.from_numpy(k))
    tst.caches[0].attn.v.copy_(torch.from_numpy(-k))
    got = paged.extract_slot(cfg, tst, 1, 20)
    assert faults.payload_checksum(got) == jfaults.payload_checksum(jart)


def test_bf16_artifacts_keep_their_bit_pattern():
    """bf16 rows go to the host as their 2-byte pattern and come back
    bit-identical; the artifact bills 2 bytes per element."""
    cfg = dataclasses.replace(reduced_config(get_config("llama-7b")), dtype="bfloat16")
    st = lm.init_state(cfg, 2, 16, device="cpu")
    src = torch.randn(st.caches[0].attn.k.shape).to(torch.bfloat16)
    st.caches[0].attn.k.copy_(src)
    art = paged.extract_slot(cfg, st, 0, 10)
    k = art.caches[0].attn.k
    assert k.dtype == np.uint16 and k.shape == (cfg.n_layers, 1, 10, 4, 16)
    assert compression.tree_nbytes(art) == 4 + 2 * 2 * k.size
    st2 = lm.init_state(cfg, 2, 16, device="cpu")
    paged.insert_slot(cfg, st2, 1, art)
    assert torch.equal(st2.caches[0].attn.k[:, 1, :10], src[:, 0, :10])
    assert st2.pos.tolist() == [0, 10]
