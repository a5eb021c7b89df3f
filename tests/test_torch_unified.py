"""The port's unified continuous-batching step against the JAX package's.

``EngineConfig(paged_decode=True, unified_step=True)`` runs one launch per
engine step over the shared KV block pool, mixing every active slot's decode
token with kv_block-wide prefill chunks of pending admissions, through the
chunked-prefill attention.  On the CPU (f32, reduced configs, weights
converted from the reference's) this file holds the port against the JAX
package at three levels:

  * kernel: ``chunked_prefill_attention_plain`` against
    ``repro.kernels.ref.chunked_prefill_ref`` and the Pallas kernel in
    interpret mode (atol 2e-5), on mixed decode, chunk and idle rows;
  * model: ``lm.prefill_chunked`` against ``repro.models.lm.prefill_chunked``
    (logits atol 1e-4, identical argmax, the same pool rows written);
  * engine: the request mixes of ``tests/test_unified.py`` served by both
    engines, with the reference's hardware and prices rebuilt for the port:
    identical tokens and actions, every modelled time and dollar at 1e-9,
    the same unified counters and launches.

The CUDA kernel runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.perf_model import PerfModel as JPerfModel  # noqa: E402
from repro.core.perf_model import tpu_v5e  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chunked_prefill import chunked_prefill_attention as pallas_chunked  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import chunked_prefill as cpk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.kvcache.hierarchy import TierSpec  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving import events as ev  # noqa: E402
from test_torch_engine import _reference_perf_and_pricing, _replay_on_both, _setup  # noqa: E402
from test_torch_obs import _same_ledger  # noqa: E402

torch.set_num_threads(1)
KERNEL_ATOL = 2e-5
MODEL_ATOL = 1e-4
PAD = -(2**30)


# --------------------------------------------------------------------------- #
# Kernel level
# --------------------------------------------------------------------------- #
def _mixed_case(rows, KV, hd, block, max_len, C, seed=0):
    """A random pool and block tables for a mixed batch: row ``(n_landed,
    n_chunk)`` holds ``n_landed`` live rows in blocks scattered over the
    pool, the last ``n_chunk`` of them this launch's queries (1 = a decode
    row, 0 = an idle row of padding).  Table padding points at the dump
    block 0."""
    rng = np.random.default_rng(seed)
    B, nb = len(rows), max_len // block
    n_blocks = 1 + B * nb
    pool_k = rng.standard_normal((n_blocks * block, KV, hd)).astype(np.float32)
    pool_v = rng.standard_normal((n_blocks * block, KV, hd)).astype(np.float32)
    tables = np.zeros((B, nb), np.int32)
    q_pos = np.full((B, C), PAD, np.int32)
    order = list(rng.permutation(np.arange(1, n_blocks)))
    for b, (n_landed, n_chunk) in enumerate(rows):
        for j in range(-(-n_landed // block)):
            tables[b, j] = order.pop()
        q_pos[b, :n_chunk] = np.arange(n_landed - n_chunk, n_landed)
    q = rng.standard_normal((B, C, 2 * KV, hd)).astype(np.float32)
    return (q, pool_k, pool_v), dict(block_table=tables, q_pos=q_pos)


MIXED = [(97, 32), (128, 1), (0, 0), (40, 8)]  # chunk across a block boundary, decode, idle
WIDE = [(130, 64), (257, 1), (0, 0), (384, 128)]
KERNEL_CASES = [
    # (rows, KV, window, block, max_len, C)
    (MIXED, 4, None, 32, 128, 32),
    (MIXED, 2, None, 32, 128, 32),
    (MIXED, 1, 24, 32, 128, 32),
    (WIDE, 2, 200, 128, 384, 128),
    (WIDE, 1, None, 128, 384, 128),
    (WIDE, 4, 50, 128, 384, 128),
]


@pytest.mark.parametrize("rows,KV,window,block,max_len,C", KERNEL_CASES)
def test_chunked_plain_matches_reference_and_pallas(rows, KV, window, block, max_len, C):
    args, kw = _mixed_case(rows, KV=KV, hd=16, block=block, max_len=max_len, C=C,
                           seed=KV + C)
    got = ops.chunked_prefill(*map(torch.from_numpy, args),
                              **{n: torch.from_numpy(a) for n, a in kw.items()},
                              block=block, window=window).numpy()
    jargs = [jnp.asarray(a) for a in args]
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    want = np.asarray(jref.chunked_prefill_ref(*jargs, **jkw, block=block, window=window))
    pallas = np.asarray(pallas_chunked(*jargs, **jkw, block=block, window=window,
                                       interpret=True))
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL)
    np.testing.assert_allclose(got, pallas, atol=KERNEL_ATOL)
    assert not got[kw["q_pos"] < 0].any()  # padding queries, idle rows among them


def test_chunked_plain_c1_is_paged_decode_bitwise():
    """A C=1 call is paged decode: the same gather and the same mask give the
    port's ``paged_decode_ref`` bit for bit."""
    args, kw = _mixed_case([(5, 1), (97, 1), (128, 1), (33, 1)], KV=2, hd=16, block=32,
                           max_len=128, C=1, seed=3)
    t = [torch.from_numpy(a) for a in args]
    tkw = {n: torch.from_numpy(a) for n, a in kw.items()}
    for window in (None, 40):
        got = cpk.chunked_prefill_attention_plain(*t, **tkw, block=32, window=window)
        want = ref.paged_decode_ref(*t, **tkw, block=32, window=window)
        assert torch.equal(got, want)


def test_chunked_wrapper_never_falls_back():
    """The kernel wrapper given CPU tensors raises: only ``ops`` picks the
    plain version, and only by the tensors' device."""
    args, kw = _mixed_case([(40, 8)], KV=2, hd=32, block=16, max_len=64, C=8)
    before = cpk.chunked_prefill_attention.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cpk.chunked_prefill_attention(*map(torch.from_numpy, args),
                                      **{n: torch.from_numpy(a) for n, a in kw.items()},
                                      block=16)
    assert cpk.chunked_prefill_attention.launches == before


# --------------------------------------------------------------------------- #
# Model level
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama-7b", "qwen2-1.5b", "olmoe-1b-7b"])
def test_prefill_chunked_matches_reference(arch):
    """``lm.prefill_chunked`` on the port and on the reference, the same
    weights and inputs: slot 0 lands a 24-token prompt after 13 stored rows
    in 16-token chunks (crossing two block boundaries), slot 1 decodes one
    greedy token per launch after 37 rows, slot 2 is idle.  Logits at
    atol 1e-4 with identical argmax, and the same pool rows written."""
    jcfg, jparams, cfg, params = _setup(arch)
    rng = np.random.default_rng(2)
    max_len, block, C = 64, 16, 16
    ctx0, prompt0, ctx1 = 13, 24, 37
    B = 3
    toks0 = rng.integers(0, cfg.vocab, ctx0 + prompt0).astype(np.int32)
    toks1 = rng.integers(0, cfg.vocab, ctx1).astype(np.int32)

    ps = paged.PagedSlots(B, max_len, block)
    jpool = jpaged.init_pool_caches(jcfg, ps.pool.n_blocks, block, dtype=jnp.float32)
    tpool = paged.init_pool_caches(cfg, ps.pool.n_blocks, block, device="cpu")
    ps.admit(0, ctx0 + prompt0)  # blocks for the whole stream up front, as the engine
    ps.admit(1, ctx1)
    jk, jv = jpool[0].attn.k, jpool[0].attn.v
    for b, toks in ((0, toks0[:ctx0]), (1, toks1)):
        _, st = jlm.prefill(jparams, jcfg, jnp.asarray(toks[None]),
                            jlm.init_state(jcfg, 1, max_len))
        L = len(toks)
        dst = paged.block_rows(ps.tables[b, : -(-L // block)], block)[:L]
        k_rows = np.array(st.caches[0].attn.k[:, 0, :L])
        v_rows = np.array(st.caches[0].attn.v[:, 0, :L])
        jk, jv = jk.at[:, dst].set(k_rows), jv.at[:, dst].set(v_rows)
        tpool[0].attn.k[:, torch.from_numpy(dst)] = torch.from_numpy(k_rows)
        tpool[0].attn.v[:, torch.from_numpy(dst)] = torch.from_numpy(v_rows)
    jpool = (jpool[0]._replace(attn=jpool[0].attn._replace(k=jk, v=jv)),)

    landed, dec_tok = ctx0, 5
    while landed < ctx0 + prompt0:
        assert ps.prepare_append(1) is None
        n_new = min(C, ctx0 + prompt0 - landed)
        tokens = np.zeros((B, C), np.int32)
        q_pos = np.full((B, C), PAD, np.int32)
        tokens[0, :n_new] = toks0[landed:landed + n_new]
        q_pos[0, :n_new] = np.arange(landed, landed + n_new)
        tokens[1, 0], q_pos[1, 0] = dec_tok, ps.lens[1]
        last_idx = np.array([n_new - 1, 0, 0], np.int32)
        jl, jpool = jlm.prefill_chunked(
            jparams, jcfg, jnp.asarray(tokens), jpool, block_table=jnp.asarray(ps.tables),
            q_pos=jnp.asarray(q_pos), last_idx=jnp.asarray(last_idx), block=block)
        tl, tpool = lm.prefill_chunked(
            params, cfg, torch.from_numpy(tokens), tpool,
            block_table=torch.from_numpy(ps.tables), q_pos=torch.from_numpy(q_pos),
            last_idx=torch.from_numpy(last_idx), block=block)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl[:2].numpy(), jl[:2], atol=MODEL_ATOL)
        assert tl[:2].argmax(-1).tolist() == jl[:2].argmax(-1).tolist()
        ps.note_token(1)
        landed += n_new
        dec_tok = int(jl[1].argmax())

    for b, L in ((0, ctx0 + prompt0), (1, int(ps.lens[1]))):
        rows = paged.block_rows(ps.tables[b, : -(-L // block)], block)[:L]
        for got, want in ((tpool[0].attn.k, jpool[0].attn.k), (tpool[0].attn.v, jpool[0].attn.v)):
            np.testing.assert_allclose(got[:, torch.from_numpy(rows)].numpy(),
                                       np.asarray(want[:, rows]), atol=MODEL_ATOL)


# --------------------------------------------------------------------------- #
# Cost model of the mixed launch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("decode_lens,chunks", [
    ([2046, 0, 130], []),  # decode only: the paged decode price, exactly
    ([2046, 17], [(128, 2032), (32, 32)]),
    ([], [(128, 128)]),
    ([5], [(1, 9), (128, 4000)]),
])
def test_unified_step_pricing_matches_reference(decode_lens, chunks):
    """``t_step_unified`` and ``step_unified_shares`` at full llama-7b scale
    equal the reference's at 1e-12 relative; with no chunks the step costs
    exactly ``t_decode_paged``, and the shares sum to 1."""
    perf, _ = _reference_perf_and_pricing()
    jperf = JPerfModel(tpu_v5e(8, hosts=1))
    cfg, jcfg = get_config("llama-7b"), jget_config("llama-7b")
    got = perf.t_step_unified(cfg, decode_lens, chunks)
    assert got == pytest.approx(jperf.t_step_unified(jcfg, decode_lens, chunks), rel=1e-12)
    if not chunks:
        assert got == perf.t_decode_paged(cfg, [L for L in decode_lens if L > 0])
    dec, chk = perf.step_unified_shares(cfg, decode_lens, chunks)
    jdec, jchk = jperf.step_unified_shares(jcfg, decode_lens, chunks)
    assert dec + chk == pytest.approx(jdec + jchk, rel=1e-12)
    assert sum(dec) + sum(chk) == pytest.approx(1.0, abs=1e-12)


# --------------------------------------------------------------------------- #
# Engine level: the mixes of tests/test_unified.py on both engines
# --------------------------------------------------------------------------- #
def _burst(vocab, *, n, ctx_lens, prompt_len=8, new=4, seed=0, arrival=0.0):
    """``tests/test_unified.py``'s request burst, from the same seeds."""
    rng = np.random.default_rng(seed)
    ctxs = [list(map(int, rng.integers(0, vocab, L))) for L in ctx_lens]
    return [
        dict(req_id=i, context_tokens=ctxs[i % len(ctxs)],
             prompt_tokens=list(map(int, rng.integers(0, vocab, prompt_len))),
             max_new_tokens=new, arrival_s=arrival)
        for i in range(n)
    ]


def _victim_and_burst(vocab):
    """One request decoding 24 tokens while two 352-token contexts arrive."""
    victim = _burst(vocab, n=1, ctx_lens=[64], new=24, seed=3)
    burst = [dict(r, req_id=10 + i, arrival_s=0.02)
             for i, r in enumerate(_burst(vocab, n=2, ctx_lens=[352, 352], new=2, seed=4))]
    return victim + burst


# name -> (arch, requests, EngineConfig fields beyond the shared ones)
MIXES = {
    # recompute + write-back + reuse over two 64-token contexts
    "reuse_burst": ("llama-7b", lambda v: _burst(v, n=8, ctx_lens=[64, 64], seed=1), {}),
    "reuse_burst_qwen2": (
        "qwen2-1.5b", lambda v: _burst(v, n=8, ctx_lens=[64, 64], seed=1), {}),
    # the MoE family: the launch's B x C tokens, idle rows included, route
    # through the experts (``tests/test_unified.py:79``)
    "reuse_burst_olmoe": (
        "olmoe-1b-7b", lambda v: _burst(v, n=8, ctx_lens=[64, 64], seed=1), {}),
    # two context lengths: one launch shape for the whole serve
    "two_contexts": ("llama-7b", lambda v: _burst(v, n=8, ctx_lens=[64, 96], seed=2), {}),
    # a long burst landing mid-decode, priced at full llama-7b scale
    "victim_burst": ("llama-7b", _victim_and_burst, dict(max_len=512, cost_arch="llama-7b")),
    # the same burst at the served config's own scale
    "victim_burst_reduced": ("llama-7b", _victim_and_burst, dict(max_len=512)),
    # reuse_burst with the int8 tier: chunked write-backs are quantised and
    # the fetched rows dequantised before they land in the pool
    "reuse_burst_compressed": (
        "llama-7b", lambda v: _burst(v, n=8, ctx_lens=[64, 64], seed=1),
        dict(compress_tier="io2")),
}
RECORD_FIELDS = ("load_s", "prefill_s", "decode_s", "start_s", "finish_s", "compute_cost")


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


def _serve(eng, make_req, reqs):
    for r in reqs:
        eng.submit(make_req(**r))
    events = []
    while not eng.idle:
        events.extend(eng.step())
    return events


@pytest.fixture(scope="module")
def served(llama):
    """Every mix through the port's unified engine, the JAX unified engine
    and the port's legacy paged engine, once."""
    models = {"llama-7b": llama}
    perf, pricing = _reference_perf_and_pricing()
    out = {}
    for name, (arch, make, extra) in MIXES.items():
        if arch not in models:
            models[arch] = _setup(arch)
        jcfg, jparams, cfg, params = models[arch]
        reqs = make(cfg.vocab)
        kw = {**dict(max_slots=4, max_len=128, chunk_tokens=16, paged_decode=True,
                     unified_step=True), **extra}
        eng, legacy = (
            ServingEngine(cfg, params, engine_cfg=EngineConfig(**{**kw, "unified_step": u}),
                          planner=AlwaysReusePlanner(), perf=perf, pricing=pricing,
                          device="cpu")
            for u in (True, False))
        jeng = jserving.ServingEngine(jcfg, jparams, engine_cfg=jserving.EngineConfig(**kw),
                                      planner=jserving.AlwaysReusePlanner())
        events, jevents = _serve(eng, Request, reqs), _serve(jeng, jserving.Request, reqs)
        _serve(legacy, Request, reqs)
        out[name] = (reqs, eng, events, jeng, jevents, legacy)
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_unified_engine_replays_reference(served, mix):
    """Tokens, actions, every record's modelled times and dollars, the
    unified counters and each mixed launch's (decode rows, chunk tokens,
    modelled seconds) equal the JAX unified engine's; the TTFT identity
    holds, the launch has one shape, and the pool drains clean."""
    reqs, eng, events, jeng, jevents, _ = served[mix]
    assert len(eng.records) == len(reqs)
    recs = {r.req_id: r for r in eng.records}
    jrecs = {r.req_id: r for r in jeng.records}
    assert {i: r.tokens for i, r in recs.items()} == {i: r.tokens for i, r in jrecs.items()}
    for i, rec in recs.items():
        want = jrecs[i]
        assert (rec.action, rec.matched_tokens) == (want.action, want.matched_tokens), i
        for field in RECORD_FIELDS:
            assert getattr(rec, field) == pytest.approx(getattr(want, field), abs=1e-9), (
                i, field)
        assert rec.ttft_s == pytest.approx(rec.queue_s + rec.load_s + rec.prefill_s)
    got, want = eng.unified_stats(), jeng.unified_stats()
    assert got["busy_s"] == pytest.approx(want["busy_s"], abs=1e-9)
    assert {k: v for k, v in got.items() if k != "busy_s"} == {
        k: v for k, v in want.items() if k != "busy_s"}
    assert got["enabled"] and got["steps"] > 0 and got["chunk_tokens"] > 0
    assert got["jit"]["misses"] == 1 and got["jit"]["hits"] == got["steps"] - 1
    steps = [(e.n_decode, e.chunk_tokens, e.step_s, e.req_ids)
             for e in events if isinstance(e, ev.UnifiedStep)]
    jsteps = [(e.n_decode, e.chunk_tokens, e.step_s, e.req_ids)
              for e in jevents if isinstance(e, jev.UnifiedStep)]
    assert len(steps) == len(jsteps) == got["steps"]
    for (n, c, s, ids), (jn, jc, js, jids) in zip(steps, jsteps):
        assert (n, c, ids) == (jn, jc, jids)
        assert s == pytest.approx(js, abs=1e-12)
    assert sum(c for _, c, _, _ in steps) == got["chunk_tokens"]
    times = [e.t_s for e in events]
    assert times == sorted(times)
    summary, jsummary = eng.summary().as_dict(), jeng.summary().as_dict()
    for k, v in jsummary.items():
        assert summary[k] == pytest.approx(v, abs=1e-9), k
    eng._paged.audit()
    assert eng._paged.pool.n_used == 0


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_unified_tokens_equal_the_legacy_paged_path(served, mix):
    """The unified engine emits token for token and action for action what
    the port's legacy paged engine emits, and its chunks land every token
    that was not reused, exactly once (``test_unified.py:80-120, 175-195``)."""
    reqs, eng, _, _, _, legacy = served[mix]
    assert {r.req_id: (r.tokens, r.action) for r in eng.records} == {
        r.req_id: (r.tokens, r.action) for r in legacy.records}
    matched = {r.req_id: r.matched_tokens for r in eng.records}
    landed = sum(len(r["context_tokens"]) + len(r["prompt_tokens"]) - matched[r["req_id"]]
                 for r in reqs)
    assert eng.unified_stats()["chunk_tokens"] == landed
    assert legacy.unified_stats()["steps"] == 0


def test_unified_decode_gap_stays_flat_under_a_burst(served):
    """The burst's chunks ride along in the victim's decode launches: its
    worst token gap stays within 1.2x the median gap."""
    _, eng, events, _, _, _ = served["victim_burst"]
    ts = [e.t_s for e in events if isinstance(e, ev.TokenEmitted) and e.req_id == 0]
    gaps = np.diff(ts)
    assert len(gaps) == 23
    assert gaps.max() <= 1.2 * np.median(gaps)
    assert len(eng.records) == 3


def test_unified_write_back_artifact_matches_the_legacy_paths(llama):
    """A context recomputed through chunks is written back from the pool in
    the reference's layout: the same tree, shapes and bytes as the packed
    path's artifact of the same context, holding the same rows."""
    _, _, cfg, params = llama
    perf, pricing = _reference_perf_and_pricing()
    reqs = _burst(cfg.vocab, n=1, ctx_lens=[80], seed=5)
    stored = []
    for unified in (False, True):
        eng = ServingEngine(
            cfg, params, planner=AlwaysReusePlanner(), perf=perf, pricing=pricing,
            device="cpu", engine_cfg=EngineConfig(
                max_slots=2, max_len=128, chunk_tokens=16, paged_decode=True,
                unified_step=unified))
        eng.submit(Request(**reqs[0]))
        eng.run()
        (entry,) = eng.store.entries.values()
        art, _ = eng.store.fetch(entry.entry_id, fraction=1.0)
        stored.append((entry.nbytes, art))
    (nb_legacy, legacy), (nb_unified, unified) = stored
    assert nb_unified == nb_legacy
    assert int(unified.pos[0]) == int(legacy.pos[0]) == 80
    for got, want in ((unified.caches[0].attn.k, legacy.caches[0].attn.k),
                      (unified.caches[0].attn.v, legacy.caches[0].attn.v)):
        assert got.shape == want.shape == (cfg.n_layers, 1, 80, cfg.n_kv_heads,
                                           cfg.resolved_head_dim)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


@pytest.mark.parametrize("field,value", [
    ("prefetch_lookahead", 1), ("migration_interval_s", 1.0),
])
def test_unified_engine_runs_prefetch_and_migrations(llama, field, value):
    """The unified step carries the prefetch and migration branches: its
    intake issues the lookahead fetches (and consumes the carried walks),
    and the migration pass runs at the top of each step and through idle
    gaps.  The serve replays the JAX engine's at 1e-9, tokens exact."""
    from repro.kvcache.hierarchy import TierSpec as JTierSpec
    from repro_torch.kvcache.hierarchy import TierSpec
    from test_torch_engine import _replay_on_both, _requests

    reqs = _requests(llama[2].vocab)
    if field == "prefetch_lookahead":
        kw, jax_kw = dict(max_slots=1, cost_arch="llama-7b"), {}
    else:
        # arrivals half a modelled second apart: passes fall due mid-serve
        reqs = [dict(r, arrival_s=0.5 * r["req_id"]) for r in reqs]
        kw = dict(tier_specs=[TierSpec("host_dram", 1.0), TierSpec("s3", 1.0)],
                  store_tier="host_dram")
        jax_kw = dict(tier_specs=[JTierSpec("host_dram", 1.0), JTierSpec("s3", 1.0)])
    eng, events = _replay_on_both(llama, reqs, "always", jax_kw=jax_kw, paged_decode=True,
                                  unified_step=True, **{field: value}, **kw)
    assert eng.unified_stats()["steps"] > 0
    if field == "prefetch_lookahead":
        assert eng.lookup_reuses > 0
    else:
        assert any(isinstance(e, ev.TierMigrated) for e in events)
    assert all(e.pins == 0 for e in eng.store.entries.values())


def test_unified_conservation_with_telemetry(llama):
    """``tests/test_unified.py``'s conservation test on the port: under the
    unified step (the chunked kernel's plain version on the CPU) the
    ledger's compute, storage and transfer totals match the summary at
    1e-9, and the ledger equals the reference engine's entry by entry."""
    jcfg, jparams, cfg, params = llama
    perf, pricing = _reference_perf_and_pricing()
    reqs = _burst(cfg.vocab, n=6, ctx_lens=[64, 96], seed=8)
    kw = dict(max_slots=2, max_len=128, chunk_tokens=16, paged_decode=True, unified_step=True,
              store_tier="s3")
    tel, jtel = Telemetry(), jobs.Telemetry()
    eng = ServingEngine(
        cfg, params, engine_cfg=EngineConfig(
            **kw, tier_specs=[TierSpec("host_dram", 1.0), TierSpec("s3", 1.0)]),
        planner=AlwaysReusePlanner(), perf=perf, pricing=pricing, telemetry=tel,
        device="cpu")
    jeng = jserving.ServingEngine(
        jcfg, jparams, engine_cfg=jserving.EngineConfig(
            **kw, tier_specs=[jhierarchy.TierSpec("host_dram", 1.0),
                              jhierarchy.TierSpec("s3", 1.0)]),
        planner=jserving.AlwaysReusePlanner(), telemetry=jtel)
    for e, make in ((eng, Request), (jeng, jserving.Request)):
        for r in reqs:
            e.submit(make(**r))
    s, js = eng.run(), jeng.run()
    residuals = tel.check(s)
    assert max(residuals.values()) <= 1e-9
    assert eng.unified_stats()["steps"] > 0
    assert [r.tokens for r in eng.records] == [r.tokens for r in jeng.records]
    assert max(jtel.check(js).values()) <= 1e-9
    _same_ledger(tel.ledger, jtel.ledger)


def test_unified_engine_refuses_embeds(llama):
    """The unified step refuses an embedding context a place in its chunk
    stream: the engine admits the request whole through the per-request path
    (``_admit_single``), lands its rows in the pool and decodes it beside a
    chunked text request, as the reference's engine does; the serve replays
    the reference's (records, summary, events at 1e-9, tokens exact)."""
    _, _, cfg, _ = llama
    rng = np.random.default_rng(0)
    embeds = (rng.standard_normal((1, 8, cfg.d_model)) * 0.02).astype(np.float32)
    reqs = [dict(req_id=0, context_tokens=[1] * 8, prompt_tokens=[2] * 4, max_new_tokens=3,
                 embeds=embeds),
            dict(req_id=1, context_tokens=rng.integers(0, cfg.vocab, 40).tolist(),
                 prompt_tokens=[3] * 4, max_new_tokens=3)]
    eng, events = _replay_on_both(llama, reqs, "always", paged_decode=True, unified_step=True)
    assert type(events[0]).__name__ == "RequestAdmitted" and events[0].req_id == 0
    assert [type(e).__name__ for e in events[:4]] == [
        "RequestAdmitted", "PlanChosen", "PrefillDone", "TokenEmitted"]
    assert eng.unified_stats()["steps"] >= 1 and eng.decode_stats()["paged"]
    assert eng._paged.pool.n_used == 0
