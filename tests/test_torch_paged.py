"""The port's paged decode path against the JAX engine's.

``EngineConfig(paged_decode=True)`` serves from one shared KV block pool:
packed admissions land block-aligned in it, batch-mates that loaded the
same stored context share its full blocks, and every decode step reads each
slot's live blocks through its table.  On the CPU, with weights converted
from the reference's and the reference's hardware and prices rebuilt inside
the test, the port's paged engine must replay the golden scenarios at 1e-9
with tokens identical to the JAX engine's, report the same pool statistics,
and its ``BlockPool``/``PagedSlots`` must hold the same state as the
reference's under the same operations.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine  # noqa: E402
from test_torch_engine import (  # noqa: E402
    ENGINE_KW,
    GOLDEN,
    SCENARIOS,
    _reference_perf_and_pricing,
    _replay_on_both,
    _run_jax,
    _run_port,
    _setup,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_scenario_replays_on_port_paged(llama, name):
    """The golden test's paged variant (``tests/test_serving.py:282``): the
    same records and summary as the dense decode path at 1e-9 (uniform
    batches: ``t_decode_paged`` delegates to ``t_decode``), tokens identical
    to the JAX engine's paged run, and the pool drained at the end."""
    jcfg, jparams, cfg, params = llama
    make, kw = SCENARIOS[name]
    reqs = make(cfg.vocab)
    eng, summary = _run_port(cfg, params, reqs, paged_decode=True, **kw)
    assert eng.decode_stats()["paged"] is True
    want = json.loads(GOLDEN.read_text())[name]
    recs = sorted(eng.records, key=lambda r: r.req_id)
    assert len(recs) == len(want["records"])
    for rec, w in zip(recs, want["records"]):
        assert rec.action == w["action"], (name, rec.req_id)
        assert rec.matched_tokens == w["matched_tokens"], (name, rec.req_id)
        for field in ("load_s", "prefill_s", "decode_s", "start_s", "finish_s",
                      "compute_cost"):
            assert getattr(rec, field) == pytest.approx(w[field], abs=1e-9), (
                name, rec.req_id, field)
    got = summary.as_dict()
    for k, v in want["summary"].items():
        assert got[k] == pytest.approx(v, abs=1e-9), (name, k)
    tokens = {rec.req_id: rec.tokens for rec in eng.records}
    assert tokens == _run_jax(jcfg, jparams, reqs, paged_decode=True, **kw)
    eng._paged.audit()
    assert eng._paged.pool.n_used == 0


@pytest.mark.parametrize("name", ["always", "partial_always"])
def test_compressed_scenario_replays_jax_engine_paged(llama, name):
    """The golden scenario's paged variant with ``compress_tier="io2"``: the
    dequantised rows land in the block pool, and the serve replays the JAX
    engine's paged run; the pool drains clean."""
    make, kw = SCENARIOS[name]
    eng, events = _replay_on_both(llama, make(llama[2].vocab), compress_tier="io2",
                                  paged_decode=True, **kw)
    assert all(e.compressed for e in eng.store.entries.values())
    assert any(type(e).__name__ == "KVLoaded" for e in events)
    eng._paged.audit()
    assert eng._paged.pool.n_used == 0


def _burst(vocab, *, n, ctx_lens, prompt_len=8, new=4, seed=0, arrival=0.0):
    """``tests/test_paged_decode.py``'s request burst, from the same seeds."""
    rng = np.random.default_rng(seed)
    ctxs = [list(map(int, rng.integers(0, vocab, L))) for L in ctx_lens]
    return [
        dict(req_id=i, context_tokens=ctxs[i % len(ctxs)],
             prompt_tokens=list(map(int, rng.integers(0, vocab, prompt_len))),
             max_new_tokens=new, arrival_s=arrival,
             expected_reuses=max(n // len(ctxs), 1))
        for i in range(n)
    ]


def _serve_both(llama, reqs, **ec_kw):
    """The same requests through the port's and the JAX engine, always
    reusing, with the reference's hardware and prices on both sides."""
    jcfg, jparams, cfg, params = llama
    perf, pricing = _reference_perf_and_pricing()
    kw = dict(max_slots=4, max_len=512, chunk_tokens=16, **ec_kw)
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**kw),
                        planner=AlwaysReusePlanner(), perf=perf, pricing=pricing,
                        device="cpu")
    jeng = jserving.ServingEngine(jcfg, jparams, engine_cfg=jserving.EngineConfig(**kw),
                                  planner=jserving.AlwaysReusePlanner())
    for r in reqs:
        eng.submit(Request(**r))
        jeng.submit(jserving.Request(**r))
    eng.run()
    jeng.run()
    return eng, jeng


def test_shared_prefix_pool_stats_match_reference(llama):
    """Batch-mates loading the same stored 300-token context share its two
    full blocks in the pool (``tests/test_paged_decode.py:289``): the pool
    statistics, the records and the tokens equal the JAX engine's."""
    vocab = llama[2].vocab
    seed_req = _burst(vocab, n=1, ctx_lens=[300], new=1, seed=3)
    mates = [dict(r, req_id=10 + i, arrival_s=1.0, max_new_tokens=3)
             for i, r in enumerate(_burst(vocab, n=3, ctx_lens=[300], new=3, seed=3))]
    eng, jeng = _serve_both(llama, seed_req + mates, paged_decode=True)
    got, want = eng.decode_stats(), jeng.decode_stats()
    assert got["shared_block_hits"] >= 2
    for key in ("paged", "kv_block", "pool_blocks", "pool_blocks_used", "pool_blocks_peak",
                "shared_block_hits", "live_slots", "live_tokens", "decode_tokens"):
        assert got[key] == want[key], key
    assert got["decode_busy_s"] == pytest.approx(want["decode_busy_s"], abs=1e-12)
    assert ({r.req_id: r.tokens for r in eng.records}
            == {r.req_id: r.tokens for r in jeng.records})
    eng._paged.audit()


@pytest.mark.parametrize("ctx_len", [256, 300])
def test_engine_traffic_never_splits_a_shared_block(llama, ctx_len):
    """Batch-mates that load one stored context share only the blocks both
    reused prefixes cover fully, and a slot's first decode write lands at
    context + prompt, past those blocks: engine traffic shares blocks but
    never needs a copy-on-write split (the card's smoke copies one by hand).
    A context of whole blocks (256) is the edge case."""
    _, _, cfg, params = llama
    perf, pricing = _reference_perf_and_pricing()
    seed_req = _burst(cfg.vocab, n=1, ctx_lens=[ctx_len], new=1, seed=3)
    mates = [dict(r, req_id=10 + i, arrival_s=1.0, max_new_tokens=3)
             for i, r in enumerate(_burst(cfg.vocab, n=3, ctx_lens=[ctx_len], new=3, seed=3))]
    eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(
        max_slots=4, max_len=512, chunk_tokens=16, paged_decode=True),
        planner=AlwaysReusePlanner(), perf=perf, pricing=pricing, device="cpu")
    splits = []
    copy = eng._copy_pool_blocks
    eng._copy_pool_blocks = lambda s: (splits.extend(s), copy(s))
    for r in seed_req + mates:
        eng.submit(Request(**r))
    eng.run()
    assert eng.decode_stats()["shared_block_hits"] >= 2
    assert splits == []
    eng._paged.audit()


def test_mixed_lengths_bill_live_blocks_like_reference(llama):
    """Ragged context lengths: each slot is billed its own live blocks'
    bytes (``t_decode_paged``, ``decode_kv_bytes``), so the records' decode
    times and dollars equal the JAX engine's at 1e-9 and the paged decode
    is cheaper than the port's dense decode of the same tokens."""
    vocab = llama[2].vocab
    reqs = _burst(vocab, n=4, ctx_lens=[32, 96, 160, 352], new=6, seed=2)
    eng, jeng = _serve_both(llama, reqs, paged_decode=True, cost_arch="llama-7b")
    dense, _ = _serve_both(llama, reqs, cost_arch="llama-7b")
    jrecs = {r.req_id: r for r in jeng.records}
    for rec in eng.records:
        w = jrecs[rec.req_id]
        assert rec.tokens == w.tokens
        for field in ("decode_s", "finish_s", "compute_cost"):
            assert getattr(rec, field) == pytest.approx(getattr(w, field), abs=1e-9), field
    assert ({r.req_id: r.tokens for r in dense.records}
            == {r.req_id: r.tokens for r in eng.records})
    assert eng.decode_busy_s < dense.decode_busy_s


def _drive_pools(ops_seq, n_slots=4, max_len=8 * 16, block=16):
    """Apply one op stream (admit with optional sharing, append, free) to
    the port's and the reference's ``PagedSlots``; after every applied op
    both hold the same tables, lengths, block counts, ref counts, free list
    and counters.  Invalid ops are skipped, as the reference's fuzzer does."""
    ps, jps = paged.PagedSlots(n_slots, max_len, block), jpaged.PagedSlots(n_slots, max_len, block)
    applied = 0
    for kind, slot, arg, other in ops_seq:
        slot = int(slot) % n_slots
        if kind == 0:
            if ps.live[slot]:
                continue
            n_total = 1 + int(arg) % (ps.nb_max * block)
            shared_from, shared = None, 0
            donor = int(other) % n_slots
            if donor != slot and ps.live[donor]:
                limit = min(int(ps.n_blocks[donor]), -(-n_total // block))
                shared = int(other) % (limit + 1)
                shared_from = donor if shared else None
            got = ps.admit(slot, n_total, shared_from=shared_from, shared_blocks=shared)
            want = jps.admit(slot, n_total, shared_from=shared_from, shared_blocks=shared)
            assert got == want
        elif kind == 1:
            if not ps.live[slot] or ps.lens[slot] >= ps.nb_max * block:
                continue
            got, want = ps.prepare_append(slot), jps.prepare_append(slot)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.src, got.dst) == (want.src, want.dst)
            ps.note_token(slot)
            jps.note_token(slot)
        else:
            if not ps.live[slot]:
                continue
            ps.free(slot)
            jps.free(slot)
        for name in ("tables", "lens", "n_blocks", "live"):
            assert np.array_equal(getattr(ps, name), getattr(jps, name)), name
        assert np.array_equal(ps.pool.ref, jps.pool.ref)
        assert ps.pool.free_list() == jps.pool.free_list()
        assert ps.stats() == jps.stats()
        ps.audit()
        applied += 1
    return ps, jps, applied


@pytest.mark.parametrize("seed", range(3))
def test_block_pool_follows_reference(seed):
    rng = np.random.default_rng(seed)
    ops_seq = zip(rng.integers(0, 3, 300), rng.integers(0, 8, 300),
                  rng.integers(0, 1024, 300), rng.integers(0, 64, 300))
    ps, jps, applied = _drive_pools(ops_seq)
    assert applied > 50
    assert ps.shared_block_hits == jps.shared_block_hits > 0


def test_block_pool_cow_on_shared_boundary_follows_reference():
    """``tests/test_paged_decode.py:419``'s copy-on-write case, on both
    pools: a follower aliasing both of a donor's blocks appends into the
    shared boundary block, gets a fresh private copy, and the original
    frees only with its last reference."""
    ops_seq = [
        (0, 0, 31, 0),  # slot 0 admits 32 rows: two full blocks
        (0, 1, 29, 2),  # slot 1 admits 30 rows sharing both of slot 0's blocks
        (1, 1, 0, 0),  # slot 1 appends at 30, inside the shared block: CoW
        (2, 0, 0, 0),  # free the donor
        (2, 1, 0, 0),
    ]
    ps = paged.PagedSlots(2, 8 * 16, block=16)
    jps = jpaged.PagedSlots(2, 8 * 16, block=16)
    ps.admit(0, 32)
    jps.admit(0, 32)
    ps.admit(1, 30, shared_from=0, shared_blocks=2)
    jps.admit(1, 30, shared_from=0, shared_blocks=2)
    boundary = int(ps.tables[1, 1])
    split, jsplit = ps.prepare_append(1), jps.prepare_append(1)
    assert split == paged.CowSplit(src=boundary, dst=jsplit.dst) and jsplit.src == boundary
    assert ps.pool.ref[boundary] == 1 and np.array_equal(ps.pool.ref, jps.pool.ref)
    # the same case as an op stream, both pools compared after every op
    _, _, applied = _drive_pools(ops_seq, n_slots=2)
    assert applied == len(ops_seq)


@pytest.mark.parametrize("kw", [dict(kv_block=64), dict(max_len=200)])
def test_paged_engine_rejects_unaligned_blocks(llama, kw):
    """Packed spans must land block-aligned in the pool: ``kv_block`` must
    equal ``pack_align`` and divide ``max_len``, or the engine refuses."""
    _, _, cfg, params = llama
    with pytest.raises(ValueError, match="paged_decode needs"):
        ServingEngine(cfg, params, device="cpu",
                      engine_cfg=EngineConfig(**{**ENGINE_KW, "paged_decode": True, **kw}))
