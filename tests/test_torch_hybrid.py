"""The port's hybrid family against the JAX package's, on the CPU.

``jamba-1.5-large-398b`` stacks Mamba, attention and MoE layers in one
8-layer period (``("m", "m", "m", "m", "a", "m", "m", "m")``, MoE on every
odd index).  Reduced jamba keeps that period whole (8 layers, d_model 64,
f32) and runs on weights converted from the reference's
(``models.convert.from_jax_params``), the reference on its plain kernels:

  * the parameter counts of the full config and of the chip's 5-layer cut,
    each against the reference's ``eval_shape`` count and the numbers the
    port's docs give; the block kinds of one period;
  * ``init_state``: one ``BlockCache`` per period position (``attn`` None
    on the Mamba positions), the reference's tree;
  * full prefill, suffix prefill and decode logits within 5e-5 of the
    reference's, and the stored artifact: the reference's tree, byte count
    and checksum, loaded into a fresh slot with the reference's logits;
  * ``tests/test_models.py::test_suffix_prefill_equals_full_prefill`` and
    ``tests/test_serving.py::test_reuse_tokens_identical_to_recompute`` for
    jamba, the partial-reuse refusal of ``tests/test_serving.py:110`` and
    jamba's case of ``tests/test_packed.py:217``'s packable predicate, on
    the port;
  * the engine: records, summaries, store entries and events at 1e-9 to the
    reference's engine, tokens exact, under the default ``EngineConfig``
    (``always`` and ``cost``) and under ``paged_decode=True`` (with
    ``unified_step`` and ``fusion_enabled``: quietly off, as in the
    reference).

The serve launcher's ``--arch jamba-1.5-large-398b`` is held to the
reference's in ``tests/test_torch_launch.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kvcache import compression as jcompression  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kvcache import compression, faults, paged  # noqa: E402
from repro_torch.models import blocks, lm, registry  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.blocks import BlockCache  # noqa: E402
from repro_torch.models.ssm import MambaState  # noqa: E402
from test_torch_engine import _replay_on_both, _requests, _run_port, _setup  # noqa: E402

torch.set_num_threads(1)
ARCH = "jamba-1.5-large-398b"
ATOL = 5e-5
# the chip's cut: Jamba's first five layers as a period of their own
CUT = dict(n_layers=5, hybrid_period=("m", "m", "m", "m", "a"))


@pytest.fixture(scope="module")
def jamba():
    return _setup(ARCH, seed=2)


@pytest.fixture(scope="module")
def served(jamba):
    """``_replay_on_both`` of ``tests/test_serving.py``'s mix under a named
    setting, each run once for the module: the port's engine and events."""
    settings = {"always": ("always", {}), "cost": ("cost", {}),
                "paged-unified-fusion": ("always", dict(paged_decode=True, unified_step=True,
                                                        fusion_enabled=True)),
                "reuse off": (None, dict(reuse_enabled=False))}
    runs = {}

    def get(name):
        if name not in runs:
            planner, ec = settings[name]
            runs[name] = _replay_on_both(jamba, _requests(jamba[2].vocab), planner, **ec)
        return runs[name]
    return get


def _tokens(eng):
    return {r.req_id: r.tokens for r in eng.records}


# --------------------------------------------------------------------------- #
# Config, counts, layout
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cut,want", [
    ({}, (397_530_179_040, 93_124_371_936)),
    (CUT, (23_980_632_192, 7_069_198_464)),
], ids=["full", "chip-cut"])
def test_param_counts_match_reference(cut, want):
    jcfg = dataclasses.replace(jget_config(ARCH), **cut)
    cfg = dataclasses.replace(get_config(ARCH), **cut)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = (registry.count_params(cfg), registry.count_active_params(cfg))
    assert got == (jregistry.count_params(jcfg), jregistry.count_active_params(jcfg)) == want
    small, jsmall = reduced_config(cfg), jreduced(jcfg)
    assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    assert small.n_layers == len(cfg.hybrid_period)
    assert registry.count_params(small) == jregistry.count_params(jsmall)
    assert registry.count_active_params(small) == jregistry.count_active_params(jsmall)


@pytest.mark.parametrize("cut", [{}, CUT], ids=["full", "chip-cut"])
def test_block_kinds_match_reference(cut):
    cfg = dataclasses.replace(get_config(ARCH), **cut)
    jcfg = dataclasses.replace(jget_config(ARCH), **cut)
    kinds = blocks.block_kinds(cfg)
    assert [tuple(k) for k in kinds] == [tuple(k) for k in jblocks.block_kinds(jcfg)]
    assert [tuple(k) for k in kinds][:5] == [("m", "mlp"), ("m", "moe"), ("m", "mlp"),
                                             ("m", "moe"), ("a", "mlp")]
    with pytest.raises(AssertionError):  # the reference's n_layers % len(period) == 0
        lm.init_state(dataclasses.replace(reduced_config(cfg), n_layers=7), 1, 8, device="cpu")


def test_init_state_is_the_reference_tree():
    """One ``BlockCache`` per period position, stacked over the periods:
    K/V on the attention position, (conv, f32 SSD) on the Mamba ones, the
    other member None, each leaf of the reference's shape and dtype."""
    cfg = reduced_config(get_config(ARCH), n_layers=16)  # two periods
    jcfg = jreduced(jget_config(ARCH), n_layers=16)
    st = lm.init_state(cfg, 2, 32, device="cpu")
    jst = jregistry.get_model(jcfg).init_state(jcfg, 2, 32)
    assert len(st.caches) == len(jst.caches) == 8
    for c, jc, mixer in zip(st.caches, jst.caches, cfg.hybrid_period):
        assert (c.attn is None, c.mamba is None) == (mixer == "m", mixer == "a")
        assert (jc.attn is None, jc.mamba is None) == (mixer == "m", mixer == "a")
        got = list(compression.tree_leaves(c))
        want = jax.tree_util.tree_leaves(jc)
        assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
        assert [str(t.dtype).removeprefix("torch.") for t in got] == [
            str(t.dtype) for t in want]
        assert all(t.shape[0] == 2 for t in got)  # stacked over two periods


def test_conversion_places_every_layer_of_the_period(jamba):
    """The reference stacks one tree per period position; the port's layer
    ``i`` is position ``i % 8`` of it (here one period), its mixer and FFN
    the kind's, every leaf the reference's values; the MoE router f32."""
    jcfg, jparams, cfg, params = jamba
    for i, (lp, kind) in enumerate(zip(params["layers"], blocks.block_kinds(cfg))):
        jl = jparams["layers"][i]
        assert ("attn" in lp, "mamba" in lp) == (kind.mixer == "a", kind.mixer == "m")
        assert ("router" in lp["ffn"]) == (kind.ffn == "moe")
        flat = jax.tree_util.tree_leaves_with_path(jl)
        assert len(flat) == len(list(compression.tree_leaves(lp)))
        for path, leaf in flat:
            node = lp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf)[0],
                                          err_msg=f"layer {i} {jax.tree_util.keystr(path)}")


# --------------------------------------------------------------------------- #
# The model against the reference
# --------------------------------------------------------------------------- #
def test_prefill_suffix_and_decode_logits_match_reference(jamba):
    """Full prefill, suffix prefill after a prefix (the SSD's initial state,
    the conv tail and the K/V rows carried) and a decode step from each,
    against the reference's same path at 5e-5; greedy tokens equal."""
    jcfg, jparams, cfg, params = jamba
    api = jregistry.get_model(jcfg)
    rng = np.random.default_rng(0)
    B, S = 2, 24
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)

    def both(parts):
        js, ts = api.init_state(jcfg, B, 64), lm.init_state(cfg, B, 64, device="cpu")
        for part in parts:
            jl, js = api.prefill(jparams, jcfg, jnp.asarray(part), js)
            tl, ts = lm.prefill(params, cfg, torch.from_numpy(part), ts)
        return jl, js, tl, ts

    nxt = None
    for jl, js, tl, ts in (both([toks]), both([toks[:, :10], toks[:, 10:]])):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
        assert ts.pos.tolist() == [S, S]
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32) if nxt is None else nxt
        jd, _ = api.decode(jparams, jcfg, jnp.asarray(nxt), js)
        td, _ = lm.decode(params, cfg, torch.from_numpy(nxt), ts)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
        assert (td.argmax(-1).numpy() == np.asarray(jd).argmax(-1)).all()


def test_suffix_prefill_equals_full_prefill(jamba):
    """``tests/test_models.py:112`` for jamba on the port: prefix state plus
    a suffix prefill gives the one-shot prefill's logits, and both states
    decode alike (the reference's 3e-4)."""
    _, _, cfg, params = jamba
    rng = np.random.default_rng(7)
    B, S = 2, 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    l_full, full = lm.prefill(params, cfg, toks, lm.init_state(cfg, B, 64, device="cpu"))
    _, st2 = lm.prefill(params, cfg, toks[:, : S // 2], lm.init_state(cfg, B, 64, device="cpu"))
    l_suffix, st2 = lm.prefill(params, cfg, toks[:, S // 2:], st2)
    np.testing.assert_allclose(l_suffix.numpy(), l_full.numpy(), atol=3e-4)
    nxt = l_full.argmax(-1)[:, None].to(torch.int32)
    d1, _ = lm.decode(params, cfg, nxt, full)
    d2, _ = lm.decode(params, cfg, nxt, st2)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=3e-4)


def test_stored_artifact_is_the_reference_tree(jamba):
    """A hybrid context's stored artifact: the attention position's K/V
    rows and every Mamba position's (conv tail, f32 SSD state), the same
    tree, shapes, dtypes and byte count as the reference's, values within
    5e-5; the reference's artifact inserted into a fresh slot comes back
    out with the reference's checksum, and its prompt's logits are the
    reference's."""
    jcfg, jparams, cfg, params = jamba
    api = jregistry.get_model(jcfg)
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, (1, 6)).astype(np.int32)
    _, jst = api.prefill(jparams, jcfg, jnp.asarray(ctx), api.init_state(jcfg, 2, 64))
    _, st = lm.prefill(params, cfg, torch.from_numpy(ctx), lm.init_state(cfg, 2, 64,
                                                                        device="cpu"))
    jart = jax.tree_util.tree_map(np.asarray, jpaged.extract_slot(jcfg, jst, 1, 20))
    art = paged.extract_slot(cfg, st, 1, 20)
    got, want = list(compression.tree_leaves(art)), jax.tree_util.tree_leaves(jart)
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    assert compression.tree_nbytes(art) == jcompression.tree_nbytes(jart)
    assert art.caches[4].attn.k.shape == (1, 1, 20, cfg.n_kv_heads, cfg.resolved_head_dim)

    def port_tree(c):
        if c.attn is not None:
            return BlockCache(KVCache(np.array(c.attn.k), np.array(c.attn.v)))
        return BlockCache(None, MambaState(np.array(c.mamba.conv), np.array(c.mamba.ssd)))

    port_art = lm.LMState(pos=jart.pos, caches=tuple(port_tree(c) for c in jart.caches))
    fresh = lm.init_state(cfg, 1, 64, device="cpu")
    paged.insert_slot(cfg, fresh, 0, port_art)
    again = paged.extract_slot(cfg, fresh, 0, 20)
    assert faults.payload_checksum(again) == jfaults.payload_checksum(jart)
    tl, _ = lm.prefill(params, cfg, torch.from_numpy(prompt), fresh)
    jfresh = jpaged.insert_slot(jcfg, api.init_state(jcfg, 1, 64), 0, jart)
    jl, _ = api.prefill(jparams, jcfg, jnp.asarray(prompt), jfresh)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_packable_arch_predicate():
    """``tests/test_packed.py:217``'s jamba case: a stack with Mamba layers
    is not packable, admits one request per step, and takes no partial
    reuse."""
    cfg = reduced_config(get_config(ARCH))
    assert not paged.packable_arch(cfg, 128)
    assert not paged.partial_reuse_allowed(cfg)
    assert cfg.n_ssm_layers == 7 and cfg.n_attn_layers == 1


# --------------------------------------------------------------------------- #
# The engine against the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["always", "cost", "paged-unified-fusion"])
def test_engine_replays_reference(served, name):
    """Both engines serve ``tests/test_serving.py``'s mix on reduced jamba
    one request per step (``_admit_single``) with dense decode: tokens
    exact; records, summary, store entries and events at 1e-9.  Under
    ``paged_decode=True``, ``unified_step`` and ``fusion_enabled`` the
    arch keeps the per-request path and dense decode, as the reference's
    engine does."""
    eng, _ = served(name)
    assert eng.batches == 0 and eng.decode_stats()["paged"] is False
    assert eng.unified_stats()["steps"] == 0 and eng.fused_stats()["enabled"] is False
    assert "partial" not in [r.action for r in eng.records]
    if name != "cost":
        assert [r.action for r in eng.records].count("load") == 4


def test_reuse_tokens_identical_to_recompute(served):
    """``tests/test_serving.py:87`` for jamba on both engines: loading the
    stored (K/V, conv, SSD) state generates recompute's tokens."""
    (eng, _), (off, _) = served("always"), served("reuse off")
    assert _tokens(eng) == _tokens(off)
    assert sum(r.action == "load" for r in eng.records) >= len(eng.records) - 2
    assert eng.summary().reuse_hits >= len(eng.records) - 2


def test_partial_reuse_disallowed(jamba):
    """``tests/test_serving.py:110`` on jamba: the Mamba layers' state is
    all or nothing, so a shared 32-token prefix gives no partial load: the
    second request recomputes, with recompute's tokens."""
    rng = np.random.default_rng(4)
    vocab = jamba[2].vocab
    shared = list(map(int, rng.integers(0, vocab, 32)))
    ctxs = [shared + list(map(int, rng.integers(0, vocab, 16))) for _ in range(2)]
    reqs = [dict(req_id=i, context_tokens=ctx, prompt_tokens=[1, 2, 3, 4], max_new_tokens=2,
                 arrival_s=0.01 * i, expected_reuses=2) for i, ctx in enumerate(ctxs)]
    eng, _ = _run_port(*jamba[2:], reqs, planner="always")
    off, _ = _run_port(*jamba[2:], reqs, reuse_enabled=False)
    assert {r.req_id: r.action for r in eng.records}[1] == "recompute"
    assert _tokens(eng) == _tokens(off)
