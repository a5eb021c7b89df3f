"""The port's fused (CacheBlend-style) reuse against the JAX package's.

A context whose stored chunks come back in another order misses the prefix
trie; the chunk-content index still finds each chunk's stored KV, and a
fused admission recomputes only a fraction of it through the
selective-recompute attention.  On the CPU (f32, reduced configs, weights
converted from the reference's) this file holds the port against the JAX
package at four levels:

  * kernel: ``fused_flash_attention_plain`` against
    ``repro.kernels.ref.fused_prefill_ref`` and the Pallas kernel in
    interpret mode (atol 2e-5): full coverage is plain causal attention,
    GQA, a window, padding queries give zeros;
  * assembly: ``fused_layout``, ``fused_arrays`` and ``build_fused_caches``
    (delta-RoPE of negative and positive shifts included) against the
    reference's on the same schedule and sources: equal index arrays,
    buffers within 1e-6;
  * model: ``lm.prefill_fused`` against ``repro.models.lm.prefill_fused``
    (logits and every context+prompt cache row at atol 1e-4), at r = 1.0
    within tolerance of ``lm.prefill``, and reused rows untouched at r < 1;
  * pricing: ``PerfModel.t_prefill_fused``, ``cost_model.delay_fused`` and
    ``cost_fused_request`` and ``BlendPlanner``'s choice against the
    reference's, on the port's H100 presets rebuilt as the reference's types.

The engine replays are in ``tests/test_torch_fusion_engine.py``; the CUDA
kernel runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.core import perf_model as jperf_mod  # noqa: E402
from repro.core import pricing as jpricing  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_prefill import fused_flash_attention as pallas_fused  # noqa: E402
from repro.kvcache import fusion as jfusion  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.serving.planner import StoreLookup as JStoreLookup  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core.cost_model import Workload, s_storage_bytes  # noqa: E402
from repro_torch.core.perf_model import PerfModel, h100  # noqa: E402
from repro_torch.core.pricing import h100_pricing  # noqa: E402
from repro_torch.kernels import fused_prefill as fuk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kvcache import fusion  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import count_active_params  # noqa: E402
from repro_torch.serving import BlendPlanner, Request  # noqa: E402
from repro_torch.serving.planner import StoreLookup  # noqa: E402
from test_torch_models import _port_artifact, _setup  # noqa: E402

torch.set_num_threads(1)
KERNEL_ATOL = 2e-5
MODEL_ATOL = 1e-4
BUFFER_ATOL = 1e-6
PAD = -(2**30)


# --------------------------------------------------------------------------- #
# Kernel level
# --------------------------------------------------------------------------- #
def _qkv(rng, Sq, Skv, H, KV, hd=16):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, Sq, H, hd), (1, Skv, KV, hd), (1, Skv, KV, hd)))


def _three_ways(q, k, v, q_pos, kv_pos, window):
    """The port's plain version (through ``ops``), the reference oracle and
    the Pallas kernel in interpret mode, on the same inputs."""
    got = ops.fused_prefill(*map(torch.from_numpy, (q, k, v)), q_pos=torch.from_numpy(q_pos),
                            kv_pos=torch.from_numpy(kv_pos), window=window).numpy()
    j = dict(q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), window=window)
    jqkv = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(jref.fused_prefill_ref(*jqkv, **j))
    pallas = np.asarray(pallas_fused(*jqkv, **j, interpret=True))
    return got, want, pallas


@pytest.mark.parametrize("H,KV,window", [(4, 4, None), (4, 2, None), (4, 2, 24)])
def test_fused_plain_full_coverage_is_plain_attention(H, KV, window):
    """With a query at every position (r = 1.0) the fused function is plain
    causal attention, bit for bit, and matches the reference and Pallas."""
    rng = np.random.default_rng(0)
    S = 40
    q, k, v = _qkv(rng, S, S, H, KV)
    pos = np.arange(S, dtype=np.int32)[None]
    got, want, pallas = _three_ways(q, k, v, pos, pos, window)
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL)
    np.testing.assert_allclose(got, pallas, atol=KERNEL_ATOL)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    plain = ref.attention_ref(*t, q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
                              causal=True, window=window)
    assert torch.equal(torch.from_numpy(got), plain)


@pytest.mark.parametrize("H,KV,window", [(4, 4, None), (8, 2, None), (4, 2, 96)])
def test_fused_plain_matches_reference_and_pallas_on_gappy_queries(H, KV, window):
    """A gappy query set over several tiles of a padded buffer (the Pallas
    kernel's fully-masked-block early-out and the invalid-row tail)."""
    rng = np.random.default_rng(3)
    Skv, total, Sq = 384, 300, 140
    q, k, v = _qkv(rng, Sq, Skv, H, KV)
    kv_pos = np.full((1, Skv), -1, np.int32)
    kv_pos[0, :total] = np.arange(total)
    q_pos = np.sort(rng.choice(total, Sq, replace=False)).astype(np.int32)[None]
    got, want, pallas = _three_ways(q, k, v, q_pos, kv_pos, window)
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL)
    np.testing.assert_allclose(got, pallas, atol=KERNEL_ATOL)


def test_fused_plain_padding_queries_give_zeros():
    """The engine's launch shape: the recompute queries then padding at
    -2^30 up to the bucket; padding outputs zeros in all three versions."""
    rng = np.random.default_rng(5)
    Skv, total, n_q, Sq = 256, 200, 90, 128
    q, k, v = _qkv(rng, Sq, Skv, 4, 2)
    kv_pos = np.full((1, Skv), -1, np.int32)
    kv_pos[0, :total] = np.arange(total)
    q_pos = np.full((1, Sq), PAD, np.int32)
    q_pos[0, :n_q] = np.sort(rng.choice(total, n_q, replace=False))
    got, want, pallas = _three_ways(q, k, v, q_pos, kv_pos, None)
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL)
    np.testing.assert_allclose(got, pallas, atol=KERNEL_ATOL)
    assert not got[0, n_q:].any() and not want[0, n_q:].any()


def test_fused_wrapper_never_falls_back():
    """The kernel wrapper given CPU tensors raises: only ``ops`` picks the
    plain version, and only by the tensors' device."""
    rng = np.random.default_rng(7)
    q, k, v = map(torch.from_numpy, _qkv(rng, 8, 32, 4, 4))
    q_pos = torch.arange(8, dtype=torch.int32)[None] * 3
    kv_pos = torch.arange(32, dtype=torch.int32)[None]
    before = fuk.fused_flash_attention.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fuk.fused_flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert fuk.fused_flash_attention.launches == before


# --------------------------------------------------------------------------- #
# Launch assembly
# --------------------------------------------------------------------------- #
CHUNK = 16


def _stored_and_schedule(cfg, jcfg, jparams, r, seed=5):
    """A stored three-chunk context and a query with its chunks permuted,
    one fresh chunk appended: reuse spans move both forward and backward
    (negative and positive delta-RoPE).  Returns (query context, prompt,
    the reference's host artifact, both packages' schedules)."""
    rng = np.random.default_rng(seed)
    pool = [list(map(int, rng.integers(0, cfg.vocab, CHUNK))) for _ in range(4)]
    ctx_stored = pool[0] + pool[1] + pool[2]
    ctx_query = pool[2] + pool[0] + pool[1] + pool[3]
    prompt = list(map(int, rng.integers(0, cfg.vocab, 8)))
    st = jlm.init_state(jcfg, 1, 128)
    _, st = jlm.prefill(jparams, jcfg, jnp.asarray([ctx_stored], jnp.int32), st)
    jart = jax.tree_util.tree_map(np.asarray, jpaged.extract_slot(jcfg, st, 0, len(ctx_stored)))
    jidx = jfusion.ChunkIndex(CHUNK)
    jidx.insert(ctx_stored, "e0")
    idx = fusion.ChunkIndex(CHUNK)
    idx.insert(ctx_stored, "e0")
    jsched = jfusion.select_recompute(jidx.match(ctx_query), r)
    sched = fusion.select_recompute(idx.match(ctx_query), r)
    return ctx_query, prompt, jart, jsched, sched


def _spans(sched):
    return [(s.start, s.end, s.kind, s.entry_id, s.src_start) for s in sched.spans]


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


@pytest.mark.parametrize("r", [0.0, 0.25, 1.0])
def test_fused_assembly_matches_reference(llama, r):
    """The same schedule, layout and index arrays as the reference, and the
    assembled buffers (delta-RoPE'd K, moved V, zero recompute rows) within
    1e-6, with one scratch row past the buffer."""
    jcfg, jparams, cfg, params = llama
    ctx, prompt, jart, jsched, sched = _stored_and_schedule(cfg, jcfg, jparams, r)
    assert _spans(sched) == _spans(jsched)
    if r < 1.0:
        deltas = {s.start - s.src_start for s in sched.spans if s.kind == "reuse"}
        assert min(deltas) < 0 < max(deltas), deltas
    layout = fusion.fused_layout(sched, len(prompt), align=128, bucket_min=16)
    jlayout = jfusion.fused_layout(jsched, len(prompt), align=128, bucket_min=16)
    assert dataclasses.asdict(layout) == dataclasses.asdict(jlayout)
    arrays = fusion.fused_arrays(sched, ctx, prompt, layout)
    jarrays = jfusion.fused_arrays(jsched, ctx, prompt, jlayout)
    assert arrays.keys() == jarrays.keys()
    for name in arrays:
        np.testing.assert_array_equal(arrays[name], jarrays[name], err_msg=name)
    caches = fusion.build_fused_caches(cfg, sched, {"e0": _port_artifact(jart)},
                                       layout.kv_len, "cpu")
    jcaches = jfusion.build_fused_caches(jcfg, jsched, {"e0": jart}, jlayout.kv_len)
    for got, want in ((caches[0].attn.k, jcaches[0].attn.k),
                      (caches[0].attn.v, jcaches[0].attn.v)):
        assert got.shape[2] == layout.kv_len + 1
        np.testing.assert_allclose(got[:, :, :layout.kv_len].numpy(), np.asarray(want),
                                   atol=BUFFER_ATOL)


def test_delta_rope_of_bf16_rows_matches_reference():
    """bf16 stored rows: cast to the cache dtype, rotate in f32, cast back —
    the reference's order.  Both give the same bf16 values up to one
    rounding step (the two libraries' cos and sin may differ in the last
    f32 bit)."""
    rng = np.random.default_rng(9)
    rows = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    for delta in (-37, 5, 1200):
        want = np.asarray(jfusion._delta_rope(np.asarray(jnp.asarray(rows, jnp.bfloat16)),
                                              delta, 10000.0).astype(np.float32))
        got = fusion._delta_rope(torch.from_numpy(rows).bfloat16(), delta, 10000.0)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


# --------------------------------------------------------------------------- #
# Model level
# --------------------------------------------------------------------------- #
def _fused_both(arch, r):
    """One fused launch of the same schedule through both packages."""
    jcfg, jparams, cfg, params = _setup(arch)
    ctx, prompt, jart, jsched, sched = _stored_and_schedule(cfg, jcfg, jparams, r, seed=2)
    jlayout = jfusion.fused_layout(jsched, len(prompt), align=128, bucket_min=16)
    ja = jfusion.fused_arrays(jsched, ctx, prompt, jlayout)
    jlogits, jcaches = jlm.prefill_fused(
        jparams, jcfg, jnp.asarray(ja["tokens"]),
        jfusion.build_fused_caches(jcfg, jsched, {"e0": jart}, jlayout.kv_len),
        q_pos=jnp.asarray(ja["q_pos"]), q_rows=jnp.asarray(ja["q_rows"]),
        kv_pos=jnp.asarray(ja["kv_pos"]), last_idx=jnp.asarray(ja["last_idx"]),
    )
    layout = fusion.fused_layout(sched, len(prompt), align=128, bucket_min=16)
    a = {n: torch.from_numpy(x) for n, x in fusion.fused_arrays(sched, ctx, prompt,
                                                                layout).items()}
    caches = fusion.build_fused_caches(cfg, sched, {"e0": _port_artifact(jart)},
                                       layout.kv_len, "cpu")
    before = tuple(t.clone() for t in (caches[0].attn.k, caches[0].attn.v))
    logits, caches = lm.prefill_fused(
        params, cfg, a["tokens"], caches, q_pos=a["q_pos"], q_rows=a["q_rows"],
        kv_pos=a["kv_pos"], last_idx=a["last_idx"],
    )
    return dict(cfg=cfg, params=params, ctx=ctx, prompt=prompt, sched=sched, layout=layout,
                logits=logits, caches=caches, before=before, jlogits=np.asarray(jlogits),
                jcaches=jcaches)


@pytest.mark.parametrize("r", [0.25, 1.0])
@pytest.mark.parametrize("arch", ["llama-7b", "qwen2-1.5b", "olmoe-1b-7b"])
def test_prefill_fused_matches_reference(arch, r):
    """Logits and every context+prompt cache row of ``lm.prefill_fused``
    within 1e-4 of the reference's, with the same argmax."""
    f = _fused_both(arch, r)
    np.testing.assert_allclose(f["logits"].numpy(), f["jlogits"], atol=MODEL_ATOL)
    assert f["logits"].argmax(-1).tolist() == f["jlogits"].argmax(-1).tolist()
    n = f["layout"].total
    for got, want in ((f["caches"][0].attn.k, f["jcaches"][0].attn.k),
                      (f["caches"][0].attn.v, f["jcaches"][0].attn.v)):
        np.testing.assert_allclose(got[:, :, :n].numpy(), np.asarray(want[:, :, :n]),
                                   atol=MODEL_ATOL)


@pytest.mark.parametrize("arch", ["llama-7b", "qwen2-1.5b", "olmoe-1b-7b"])
def test_prefill_fused_at_full_recompute_is_prefill(arch):
    """At r = 1.0 the fused launch recomputes every token: its logits and
    cache rows are ``lm.prefill``'s of the whole sequence, within tolerance
    (the two launches' sums run in other orders, so not bit for bit)."""
    f = _fused_both(arch, 1.0)
    cfg, params = f["cfg"], f["params"]
    state = lm.init_state(cfg, 1, 128, device="cpu")
    want, state = lm.prefill(params, cfg, torch.tensor([f["ctx"] + f["prompt"]]), state)
    np.testing.assert_allclose(f["logits"].numpy(), want.numpy(), atol=MODEL_ATOL)
    n = f["layout"].total
    for got, exp in ((f["caches"][0].attn.k, state.caches[0].attn.k),
                     (f["caches"][0].attn.v, state.caches[0].attn.v)):
        np.testing.assert_allclose(got[:, :, :n].numpy(), exp[:, :, :n].numpy(),
                                   atol=MODEL_ATOL)


def test_prefill_fused_leaves_reused_rows_untouched():
    """At r < 1 the launch writes only the recompute and prompt rows: the
    preloaded reused rows come out bit for bit."""
    f = _fused_both("llama-7b", 0.25)
    assert f["sched"].reused_tokens > 0 and f["sched"].selected_tokens > 0
    assert torch.isfinite(f["logits"]).all()
    for s in f["sched"].spans:
        if s.kind == "reuse":
            for got, was in zip((f["caches"][0].attn.k, f["caches"][0].attn.v), f["before"]):
                assert torch.equal(got[:, :, s.start:s.end], was[:, :, s.start:s.end])


# --------------------------------------------------------------------------- #
# Pricing and planning
# --------------------------------------------------------------------------- #
def _h100_both():
    """The port's H100 hardware and prices, and the same fields as the
    reference's types."""
    hw, pricing = h100(1), h100_pricing(1)
    jhw = jperf_mod.HardwareSpec(**dataclasses.asdict(hw))
    jp = jpricing.Pricing(
        compute=jpricing.ComputePrice(**dataclasses.asdict(pricing.compute)),
        tiers={n: jpricing.StorageTier(**dataclasses.asdict(t))
               for n, t in pricing.tiers.items()},
        default_tier=pricing.default_tier,
    )
    return PerfModel(hw), pricing, jperf_mod.PerfModel(jhw), jp


@pytest.mark.parametrize("arch", ["llama-7b", "qwen2-1.5b", "olmoe-1b-7b"])
def test_fused_prefill_pricing_matches_reference(arch):
    """``t_prefill_fused`` equals the reference's at 1e-12 relative; a small
    r is cheaper than a full prefill and monotone in the recompute count;
    full recompute delegates to ``t_prefill`` exactly; the launch never
    costs less than its parameter read."""
    perf, _, jperf, _ = _h100_both()
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    L = 8192
    for n in (0, 1, 128, int(0.15 * L), 2048, L, 10 * L):
        assert perf.t_prefill_fused(cfg, L, n) == pytest.approx(
            jperf.t_prefill_fused(jcfg, L, n), rel=1e-12)
    full = perf.t_prefill(cfg, L)
    assert 0 < perf.t_prefill_fused(cfg, L, int(0.15 * L)) < full
    assert perf.t_prefill_fused(cfg, L, 2048) >= perf.t_prefill_fused(cfg, L, 512)
    assert perf.t_prefill_fused(cfg, L, L) == full == perf.t_prefill_fused(cfg, L, 10 * L)
    assert perf.t_prefill_fused(cfg, 0, 128) == 0.0
    hw = perf.hw
    param_read = count_active_params(cfg) * 2 / (hw.devices * hw.hbm_bw * hw.membw_eff)
    assert perf.t_prefill_fused(cfg, L, 1) >= param_read


def _blend_case():
    """``tests/test_fusion.py``'s cost-gating case: a 2,048-token context
    whose eight 256-token chunks are stored in another order."""
    chunk = 256
    stored = list(range(8 * chunk))
    query = sum((stored[i * chunk:(i + 1) * chunk] for i in (4, 5, 0, 1, 2, 3, 6, 7)), [])
    return chunk, stored, query


@pytest.mark.parametrize("overlap", [False, True])
def test_fused_delay_and_cost_match_reference(overlap):
    perf, pricing, jperf, jp = _h100_both()
    cfg = get_config("llama-7b")
    jcfg = jget_config("llama-7b")
    by_tier = {"host_dram": s_storage_bytes(cfg, 1500), "io2": s_storage_bytes(cfg, 548)}
    wait = {"io2": 0.003}
    w = Workload(L_context=2048, L_prompt=16, L_output=16, N=4)
    jw = jcost.Workload(L_context=2048, L_prompt=16, L_output=16, N=4)
    d = cost_model.delay_fused(cfg, w, perf, pricing, bytes_by_tier=by_tier,
                               n_recompute_ctx=307, overlap_load=overlap, queue_wait_s=wait)
    jd = jcost.delay_fused(jcfg, jw, jperf, jp, bytes_by_tier=by_tier, n_recompute_ctx=307,
                           overlap_load=overlap, queue_wait_s=wait)
    assert dataclasses.asdict(d) == pytest.approx(dataclasses.asdict(jd), rel=1e-12)
    c = cost_model.cost_fused_request(cfg, w, pricing, perf, bytes_by_tier=by_tier,
                                      n_recompute_ctx=307)
    jc = jcost.cost_fused_request(jcfg, jw, jp, jperf, bytes_by_tier=by_tier,
                                  n_recompute_ctx=307)
    assert c == pytest.approx(jc, rel=1e-12)


def test_blend_planner_cost_gating():
    """``always=False``: fused competes on marginal cost.  It wins when the
    composite covers a long context (prefill compute dwarfs the fetch fees)
    and loses when nothing matches; the reference's planner, on the same
    H100 model and prices, plans the same."""
    perf, pricing, jperf, jp = _h100_both()
    cfg = get_config("llama-7b")
    jcfg = jget_config("llama-7b")
    planner = BlendPlanner(recompute_frac=0.15)
    planner.configure(cost_cfg=cfg, pricing=pricing, perf=perf, write_back=True,
                      min_store_tokens=32)
    jplanner = jserving.BlendPlanner(recompute_frac=0.15)
    jplanner.configure(cost_cfg=jcfg, pricing=jp, perf=jperf, write_back=True,
                       min_store_tokens=32)
    chunk, stored, query = _blend_case()
    idx, jidx = fusion.ChunkIndex(chunk), jfusion.ChunkIndex(chunk)
    idx.insert(stored, "e0")
    jidx.insert(stored, "e0")
    comp, jcomp = idx.match(query), jidx.match(query)
    assert comp.matched_tokens == len(query)
    by_tier = {"host_dram": s_storage_bytes(cfg, len(query))}
    lookup = StoreLookup(match=None, entry=None, fraction=0.0, partial_ok=True,
                         composite=comp, fused_bytes_by_tier=by_tier)
    jlookup = JStoreLookup(match=None, entry=None, fraction=0.0, partial_ok=True,
                           composite=jcomp, fused_bytes_by_tier=by_tier)
    req = dict(req_id=0, context_tokens=query, prompt_tokens=[1] * 16, max_new_tokens=16,
               expected_reuses=4)
    w = Workload(L_context=len(query), L_prompt=16, L_output=16, N=4)
    jw = jcost.Workload(L_context=len(query), L_prompt=16, L_output=16, N=4)
    plan = planner.plan(Request(**req), lookup, w)
    jplan = jplanner.plan(jserving.Request(**req), jlookup, jw)
    assert plan.action == jplan.action == "fused"
    assert plan.fused is not None and plan.fetch_bytes > 0
    assert _spans(plan.fused) == _spans(jplan.fused)
    for field in ("matched_tokens", "reused_fraction", "fetch_bytes", "est_ttft_s", "est_cost"):
        assert getattr(plan, field) == pytest.approx(getattr(jplan, field), rel=1e-12), field
    assert plan.est_cost < planner.base.plan(Request(**req), StoreLookup.miss(), w).est_cost
    miss = planner.plan(Request(**req), StoreLookup.miss(), w)
    assert miss.action == "recompute" and miss.fused is None
