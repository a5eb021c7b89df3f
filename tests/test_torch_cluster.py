"""Cluster serving on the port, against the JAX package.

The 14 tests of ``tests/test_cluster.py`` replay here on the port's modules,
grouped as the reference groups them: the shared cold tier (dedup,
refcounted ownership, crash safety, the hypothesis op sequence), the router
invariants, cluster serving (one-replica golden parity at 1e-9, bloom false
positives, copy-then-keep rebalancing, affinity against round robin,
``remove_replica``) and delta gossip.  The engines run on the CPU
(``device="cpu"``) with weights converted from the reference's, on reduced
``qwen2-0.5b`` as the reference's cluster tests take it.

Then the port is held to the reference directly: the same hashes give the
same bloom bits, the two consistent-hash rings name the same owners before
and after a removal, the routing terms agree at 1e-9 over a grid, and one
two-replica affinity cluster and one round-robin cluster with rebalancing
serve the same requests on both sides with the same tokens, records, routing
and rebalance events, gossip and shared-core stats and summary (floats at
1e-9).
"""
import dataclasses
import itertools
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.core.perf_model import PerfModel as JPerfModel  # noqa: E402
from repro.core.perf_model import V100_X4_HF as J_V100  # noqa: E402
from repro.core import perf_model as jperf_model  # noqa: E402
from repro.core import pricing as jpricing  # noqa: E402
from repro.core.pricing import AWS_PAPER as J_AWS  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import serving as pserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core.perf_model import V100_X4_HF, PerfModel, h100  # noqa: E402
from repro_torch.core.pricing import AWS_PAPER, h100_pricing  # noqa: E402
from repro_torch.kvcache import faults as pfaults  # noqa: E402
from repro_torch.kvcache import hierarchy as phierarchy  # noqa: E402
from repro_torch.kvcache.chunks import chunk_hash_chain  # noqa: E402
from repro_torch.kvcache.hierarchy import (  # noqa: E402
    HostMemoryBackend,
    SharedBackendCore,
    SharedTierBackend,
    TieredStore,
    TierSpec,
)
from repro_torch.kvcache.transfer import SimClock, TransferModel  # noqa: E402
from repro_torch.market import Marketplace, MarketPlanner  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.blocks import BlockCache  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AffinityRouter,
    AlwaysReusePlanner,
    ClusterConfig,
    CostAwarePlanner,
    EngineConfig,
    Request,
    RoundRobinRouter,
    ServingCluster,
    ServingEngine,
)
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.router import (  # noqa: E402
    BloomDigest,
    ConsistentHashRing,
    ReplicaView,
    RouteDecision,
)
from test_torch_engine import (  # noqa: E402
    GOLDEN,
    SCENARIOS,
    _close,
    _reference_perf_and_pricing,
    _requests,
    _run_port,
    _setup,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def qwen():
    return _setup("qwen2-0.5b")


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


def _transfer():
    return TransferModel(PerfModel(V100_X4_HF), AWS_PAPER)


def _art(i, floats=150):
    return {"k": np.full((1, floats), i, np.float32)}  # 4*floats bytes


def _shared_stores(n=2, cap_gb=1.0):
    """N stores, each host_dram + a namespaced view onto ONE shared s3 core."""
    core = SharedBackendCore()
    stores = []
    for i in range(n):
        clock = SimClock()
        tr = _transfer()
        backends = {
            "host_dram": HostMemoryBackend("host_dram", transfer=tr, clock=clock),
            "s3": SharedTierBackend("s3", core=core, namespace=f"r{i}", transfer=tr,
                                    clock=clock),
        }
        stores.append(TieredStore(
            tiers=[TierSpec("host_dram", cap_gb), TierSpec("s3", cap_gb)],
            transfer=tr, clock=clock, chunk_tokens=4, pricing=AWS_PAPER,
            backends=backends, device="cpu",
        ))
    return core, stores


def check_core_invariants(core, stores):
    """The shared tier's conservation laws, checked after every mutation:
    refcounts equal live key counts, every key resolves, resident bytes are
    the sum over DISTINCT contents (dedup), and every store's own s3 entries
    stay readable — no replica can orphan another's entry."""
    cnt = Counter(core._keys.values())
    assert dict(core._refs) == dict(cnt)
    assert set(core._contents) == set(cnt)
    stats = core.stats()
    assert stats["resident_bytes"] == pytest.approx(
        sum(nb for _, nb in core._contents.values()))
    assert stats["logical_bytes"] >= stats["resident_bytes"]
    for s in stores:
        for eid, e in s.entries.items():
            if e.tier == "s3":
                assert s.backends["s3"]._read(eid) is not None


# --------------------------------------------------------------------------- #
# Shared cold tier: dedup, refcounted ownership, crash safety
# --------------------------------------------------------------------------- #
class TestSharedColdTier:
    def test_dedup_and_byte_conservation(self):
        core, (s0, s1) = _shared_stores(2)
        toks = list(range(8))
        e0, _ = s0.put(toks, _art(1), tier="s3")
        e1, _ = s1.put(toks, _art(1), tier="s3")  # identical content
        check_core_invariants(core, [s0, s1])
        st_ = core.stats()
        assert st_["n_keys"] == 2 and st_["n_contents"] == 1
        assert st_["dedup_hits"] == 1
        assert st_["logical_bytes"] == 2 * st_["resident_bytes"]
        # each replica is billed its own logical bytes regardless of dedup
        assert s0.tiers["s3"].used_bytes == s1.tiers["s3"].used_bytes
        # the store's stats carry the shared core's
        assert s0.stats()["shared"] == {"s3": st_}

        # one replica evicts: the payload must survive for the other
        assert s0._evict_one("s3")
        check_core_invariants(core, [s0, s1])
        assert core.stats()["n_contents"] == 1
        art, h = s1.fetch(e1)
        assert art is not None and np.allclose(art["k"], 1.0)

        # last owner evicts: content is actually reclaimed
        assert s1._evict_one("s3")
        check_core_invariants(core, [s1])
        assert core.stats() == {
            "n_contents": 0, "n_keys": 0, "resident_bytes": 0, "logical_bytes": 0,
            "dedup_saved_bytes": core.stats()["dedup_saved_bytes"], "dedup_hits": 1,
        }

    def test_replica_crash_orphans_nothing(self):
        core, stores = _shared_stores(3)
        # overlapping working sets: ctx0 on all three, ctx1 on r0+r1, ctx2 r0
        ctxs = [list(range(i * 8, i * 8 + 8)) for i in range(3)]
        stores[0].put(ctxs[0], _art(0), tier="s3")
        stores[0].put(ctxs[1], _art(1), tier="s3")
        stores[0].put(ctxs[2], _art(2), tier="s3")
        stores[1].put(ctxs[0], _art(0), tier="s3")
        stores[1].put(ctxs[1], _art(1), tier="s3")
        stores[2].put(ctxs[0], _art(0), tier="s3")
        check_core_invariants(core, stores)
        assert core.stats()["n_contents"] == 3

        # r0 crashes out: its keys release, shared content survives
        released = stores[0].backends["s3"].release_namespace()
        assert released == 3
        check_core_invariants(core, stores[1:])
        assert core.stats()["n_contents"] == 2  # ctx2 died with its only owner
        for s, eids in ((stores[1], 2), (stores[2], 1)):
            assert len(s.entries) == eids
            for eid in s.entries:
                art, _ = s.fetch(eid)
                assert art is not None

    @settings(max_examples=25, deadline=None, derandomize=True)
    @given(
        ops=st.lists(
            st.tuples(
                st.sampled_from(["put", "evict", "crash"]),
                st.integers(0, 1),  # store index
                st.integers(0, 4),  # context index
            ),
            min_size=1, max_size=30,
        )
    )
    def test_ops_conserve_shared_bytes(self, ops):
        """Any interleaving of puts / evictions / a namespace crash keeps the
        shared core's refcounts and byte accounting exact, and never makes a
        surviving store's entry unreadable."""
        core, stores = _shared_stores(2)
        crashed = [False, False]
        for op, si, ci in ops:
            s = stores[si]
            if crashed[si]:
                continue
            if op == "put":
                s.put(list(range(ci * 8, ci * 8 + 8)), _art(ci), tier="s3")
            elif op == "evict":
                s._evict_one("s3")
            else:
                s.backends["s3"].release_namespace()
                s.entries.clear()  # the replica is gone; drop its metadata
                for t in s.tiers.values():
                    t.used_bytes = 0.0
                crashed[si] = True
            live = [x for x, c in zip(stores, crashed) if not c]
            check_core_invariants(core, live)
        # terminal state: resident bytes exactly cover the distinct contents
        stats = core.stats()
        assert stats["resident_bytes"] == sum(nb for _, nb in core._contents.values())


# --------------------------------------------------------------------------- #
# Router invariants
# --------------------------------------------------------------------------- #
def _affinity_router(n=3):
    r = AffinityRouter()
    r.configure(cost_cfg=get_config("llama-7b"), pricing=AWS_PAPER,
                perf=PerfModel(V100_X4_HF), chunk_tokens=16, replica_ids=list(range(n)))
    return r


def _req(ctx=None):
    return Request(req_id=0, context_tokens=ctx or list(range(64)),
                   prompt_tokens=list(range(8)), max_new_tokens=4)


class TestRouterInvariants:
    @settings(max_examples=50, deadline=None, derandomize=True)
    @given(
        frees=st.lists(st.integers(0, 3), min_size=2, max_size=5),
        loads=st.lists(st.integers(0, 6), min_size=5, max_size=5),
        with_digest=st.booleans(),
    )
    def test_never_routes_to_full_replica_when_another_has_room(self, frees, loads,
                                                                  with_digest):
        n = len(frees)
        digest = None
        if with_digest:
            digest = BloomDigest()
            digest.update([f"h{i}" for i in range(4)])
        views = [
            ReplicaView(replica=i, load=loads[i % len(loads)], free_slots=frees[i],
                        queue_s=0.1 * loads[i % len(loads)], digest=digest,
                        hit_tier="host_dram")
            for i in range(n)
        ]
        req = _req()
        for router in (_affinity_router(n), RoundRobinRouter()):
            d = router.decide(req, views)
            assert 0 <= d.replica < n
            if any(f > 0 for f in frees):
                assert frees[d.replica] > 0, (frees, d.replica)

    def test_full_replica_skipped_deterministic(self):
        """Deterministic mirror of the hypothesis property: replica 1 holds
        the whole context but has no free slot — both routers must divert to
        a replica with room."""
        ctx = list(range(64))
        holder = BloomDigest()
        holder.update(chunk_hash_chain(ctx, 16))
        views = [
            ReplicaView(replica=0, load=1, free_slots=1, digest=None, hit_tier="host_dram"),
            ReplicaView(replica=1, load=4, free_slots=0, digest=holder,
                        hit_tier="host_dram", queue_s=0.2),
        ]
        req = _req(ctx)
        for router in (_affinity_router(2), RoundRobinRouter()):
            for _ in range(4):
                assert router.decide(req, views).replica == 0
        # when NO replica has room, the affinity pick comes back
        views_full = [
            ReplicaView(replica=0, load=4, free_slots=0, digest=None,
                        hit_tier="host_dram", queue_s=0.2),
            views[1],
        ]
        assert _affinity_router(2).decide(req, views_full).replica == 1

    def test_affinity_prefers_digest_owner_when_costs_allow(self):
        router = _affinity_router(2)
        ctx = list(range(64))
        holder = BloomDigest()
        holder.update(chunk_hash_chain(ctx, 16))
        views = [
            ReplicaView(replica=0, load=0, free_slots=2, digest=None, hit_tier="host_dram"),
            ReplicaView(replica=1, load=0, free_slots=2, digest=holder, hit_tier="host_dram"),
        ]
        d = router.decide(_req(ctx), views)
        assert d.replica == 1 and d.matched_tokens == 64

    def test_cold_cluster_coloates_on_ring_owner(self):
        """No digests yet: identical contexts must still pick the SAME
        replica (the consistent-hash owner), so the first write-back lands
        where future traffic will look for it."""
        router = _affinity_router(3)
        views = [ReplicaView(replica=i, load=0, free_slots=2) for i in range(3)]
        ctx = list(range(64))
        picks = {router.decide(_req(ctx), views).replica for _ in range(5)}
        assert len(picks) == 1
        assert picks == {router.decide(_req(ctx), views).ring_owner}


# --------------------------------------------------------------------------- #
# Cluster end-to-end
# --------------------------------------------------------------------------- #
SPECS = [TierSpec("host_dram", 1.0), TierSpec("local_nvme", 1.0), TierSpec("s3", 1.0)]


def _cluster_ec(**kw):
    # cost_arch: price routing/planning at llama-7b scale while the actual
    # compute is the reduced arch — on the paper's V100+AWS numbers a
    # host_dram hit strictly beats recompute, so affinity has something to
    # win (at toy scale recompute is always cheapest and the router would
    # correctly ignore the cache).
    base = dict(max_slots=2, max_len=128, chunk_tokens=16, tier_specs=SPECS,
                store_tier="host_dram", cost_arch="llama-7b")
    base.update(kw)
    return EngineConfig(**base)


def _paper_hw():
    return dict(pricing=AWS_PAPER, perf=PerfModel(V100_X4_HF))


class TestClusterServing:
    def test_one_replica_golden_parity(self, llama):
        """A 1-replica cluster behind the affinity router IS the engine: the
        golden seed trace replays action- and cost-identically through it."""
        golden = json.loads(GOLDEN.read_text())
        cfg, params = llama[2], llama[3]
        perf, pricing = _reference_perf_and_pricing()
        planners = {"always": AlwaysReusePlanner, "cost": CostAwarePlanner}
        for name, (make, kw) in SCENARIOS.items():
            kw = dict(kw)
            planner = planners.get(kw.pop("planner", None))
            ec = EngineConfig(max_slots=2, max_len=128, chunk_tokens=16, **kw)
            cl = ServingCluster(cfg, params, cluster_cfg=ClusterConfig(n_replicas=1),
                                engine_cfg=ec, planner_factory=planner, perf=perf,
                                pricing=pricing, device="cpu")
            for r in make(cfg.vocab):
                cl.submit(Request(**r))
            s = cl.run()
            want = golden[name]
            recs = sorted(cl.replicas[0].records, key=lambda r: r.req_id)
            assert len(recs) == len(want["records"]), name
            for rec, w in zip(recs, want["records"]):
                assert rec.action == w["action"], (name, rec.req_id)
                assert rec.matched_tokens == w["matched_tokens"], (name, rec.req_id)
                for field in ("load_s", "prefill_s", "decode_s", "start_s", "finish_s",
                              "compute_cost"):
                    assert getattr(rec, field) == pytest.approx(w[field], abs=1e-9), (
                        name, rec.req_id, field)
            got = cl.replicas[0].summary().as_dict()
            for k, v in want["summary"].items():
                assert got[k] == pytest.approx(v, abs=1e-9), (name, k)
            assert s.n_requests == len(want["records"])

    def test_bloom_false_positives_cost_but_never_corrupt(self, qwen):
        """Force EVERY digest probe to hit (the worst staleness/FP case):
        routing is mispriced, but the landing replica recomputes what it
        doesn't hold — generated tokens are identical to a bare engine's."""
        cfg, params = qwen[2], qwen[3]
        reqs = _requests(cfg.vocab, n=8, n_ctx=2, ctx_len=64, prompt_len=8, new=4, seed=0)
        cl = ServingCluster(
            cfg, params, cluster_cfg=ClusterConfig(n_replicas=2, gossip_interval_s=0.0),
            engine_cfg=_cluster_ec(), planner_factory=AlwaysReusePlanner, device="cpu",
            **_paper_hw(),
        )
        lying = BloomDigest()
        lying._bits = (1 << lying.m) - 1  # every probe answers "present"
        lying.n_added = 1
        cl._digests = [lying, lying]
        for r in reqs:
            cl.submit(Request(**r))
        cl.run()
        routed = [e for _, e in cl.events if isinstance(e, ev.RequestRouted)]
        assert routed and all(e.matched_tokens == 64 for e in routed)

        eng, _ = _run_port(cfg, params, reqs, planner="always", tier_specs=SPECS,
                           store_tier="host_dram")
        tok_ref = {rec.req_id: rec.tokens for rec in eng.records}
        tok_cl = {rec.req_id: rec.tokens for rec in cl.records}
        assert tok_cl == tok_ref

    def test_rebalance_moves_hot_entry_toward_traffic(self, qwen):
        """Copy-then-keep: traffic for a context concentrates on a replica
        that does not hold its KV; rebalancing copies the donor's bytes into
        the target's hot tier (event-verified) with the donor's copy alive
        throughout, and the target then serves loads locally."""
        cfg, params = qwen[2], qwen[3]
        ctx = list(range(64))
        prompt = list(range(100, 108))

        # materialize a valid stored artifact via a throwaway engine
        seed_req = dict(req_id=0, context_tokens=ctx, prompt_tokens=prompt,
                        max_new_tokens=4, arrival_s=0.0, expected_reuses=4)
        donor_eng, _ = _run_port(cfg, params, [seed_req], planner="always",
                                 tier_specs=SPECS, store_tier="host_dram")
        (eid, entry), = donor_eng.store.entries.items()
        art = donor_eng.store.backends[entry.tier].peek(eid)
        assert art is not None

        class ScriptedRouter:
            """Pin every request on replica 1 (the non-holder)."""

            def configure(self, **_):
                pass

            def decide(self, req, views):
                return RouteDecision(replica=1, matched_tokens=0, score=0.0, ring_owner=-1)

        cl = ServingCluster(
            cfg, params,
            cluster_cfg=ClusterConfig(n_replicas=2, gossip_interval_s=0.05,
                                      rebalance_interval_s=0.05, rebalance_min_hits=2),
            engine_cfg=_cluster_ec(store_write_back=False), router=ScriptedRouter(),
            planner_factory=AlwaysReusePlanner, device="cpu", **_paper_hw(),
        )
        # replica 0 holds the context; nothing ever writes back (the
        # cost-aware "local frequency below break-even" regime)
        ck = cl.replicas[0].store.content_key(ctx)
        e0, _ = cl.replicas[0].store.put(ctx, art, tier="host_dram",
                                         saved_per_use=entry.saved_per_use)
        assert e0 is not None

        for i, t in enumerate((0.1, 0.4, 0.7)):
            cl.submit(Request(req_id=i, context_tokens=ctx, prompt_tokens=prompt,
                              max_new_tokens=4, arrival_s=t, expected_reuses=4))
        cl.run()

        reb = [e for _, e in cl.events if isinstance(e, ev.ReplicaRebalanced)]
        assert len(reb) == 1 and cl.rebalances == 1
        r = reb[0]
        assert (r.from_replica, r.to_replica, r.content_key) == (0, 1, ck)
        # no unreachable window: the donor's copy survived the whole run...
        assert cl.replicas[0].store.entries[e0].content_key == ck
        # ...and the target now holds its own hot-tier copy
        tgt = [e for e in cl.replicas[1].store.entries.values() if e.content_key == ck]
        assert len(tgt) == 1 and tgt[0].tier == "host_dram"
        # the copy landed between arrivals: the last request LOADED locally
        recs = sorted(cl.replicas[1].records, key=lambda x: x.req_id)
        assert [x.action for x in recs][:1] == ["recompute"]
        assert recs[-1].action == "load" and recs[-1].matched_tokens == 64

    def test_affinity_beats_round_robin_on_hit_rate(self, qwen):
        """The economics headline at fleet scale: affinity routing keeps each
        context's traffic on one replica, so aggregate hit rate strictly
        beats cache-oblivious round-robin on a skewed reuse workload."""
        cfg, params = qwen[2], qwen[3]
        reqs = _skewed_requests(cfg.vocab)

        def run(router):
            cl = ServingCluster(
                cfg, params, cluster_cfg=ClusterConfig(n_replicas=2, gossip_interval_s=0.05),
                engine_cfg=_cluster_ec(), router=router,
                planner_factory=AlwaysReusePlanner, device="cpu", **_paper_hw(),
            )
            for r in reqs:
                cl.submit(Request(**r))
            return cl, cl.run()

        cl_a, s_a = run(None)  # AffinityRouter default
        cl_r, s_r = run(RoundRobinRouter())
        assert s_a.n_requests == s_r.n_requests == 16
        assert s_a.hit_rate > s_r.hit_rate, (s_a.hit_rate, s_r.hit_rate)
        # identical tokens either way (routing never changes outputs)
        tok_a = {r.req_id: r.tokens for r in cl_a.records}
        tok_r = {r.req_id: r.tokens for r in cl_r.records}
        assert tok_a == tok_r

    def test_remove_replica_releases_only_its_shared_keys(self, qwen):
        cfg, params = qwen[2], qwen[3]
        cl = ServingCluster(cfg, params, cluster_cfg=ClusterConfig(n_replicas=2),
                            engine_cfg=_cluster_ec(store_tier="s3"), device="cpu",
                            **_paper_hw())
        ctx0, ctx1 = list(range(64)), list(range(64, 128))
        cl.replicas[0].store.put(ctx0, _art(0), tier="s3")
        cl.replicas[1].store.put(ctx0, _art(0), tier="s3")  # dedup'd twin
        cl.replicas[1].store.put(ctx1, _art(1), tier="s3")
        assert cl.core.stats() == dict(cl.core.stats(), n_keys=3, n_contents=2, dedup_hits=1)
        released = cl.remove_replica(0)
        assert released == 1
        stats = cl.core.stats()
        assert stats["n_keys"] == 2 and stats["n_contents"] == 2
        for eid in cl.replicas[1].store.entries:
            art, _ = cl.replicas[1].store.fetch(eid)
            assert art is not None
        # the removed replica is invisible to routing and the idle predicate
        assert all(v.replica == 1 for v in cl.views())
        assert cl.idle


def _skewed_requests(vocab):
    """``test_affinity_beats_round_robin_on_hit_rate``'s mix: 16 requests
    over three contexts, arrivals spread so capacity pressure never
    overrides affinity."""
    reqs = _requests(vocab, n=16, n_ctx=3, ctx_len=64, prompt_len=8, new=4, seed=1)
    for i, r in enumerate(reqs):
        r["arrival_s"] = i * 0.2
    return reqs


# --------------------------------------------------------------------------- #
# Delta gossip: incremental digests are bit-identical to full rebuilds
# --------------------------------------------------------------------------- #
class TestDeltaGossip:
    def _check_equiv(self, cl):
        """The staleness-equivalence invariant: after any gossip tick, each
        live replica's incrementally-maintained digest has EXACTLY the bits
        a from-scratch rebuild over the store's current hash surface would
        produce — delta shipping changes the wire bytes, never the answer."""
        for i, eng in enumerate(cl.replicas):
            if not cl._alive[i]:
                continue
            fresh = BloomDigest(cl.cc.digest_bits, cl.cc.digest_hashes)
            fresh.update(eng.store.digest_hashes())
            assert cl._digests[i]._bits == fresh._bits, i

    def _cluster(self, qwen):
        return ServingCluster(qwen[2], qwen[3], cluster_cfg=ClusterConfig(n_replicas=2),
                              engine_cfg=_cluster_ec(), device="cpu", **_paper_hw())

    def test_delta_ticks_equal_full_rebuild(self, qwen):
        cl = self._cluster(qwen)
        store = cl.replicas[0].store

        cl.gossip_now()  # first tick: both replicas full-sync from scratch
        self._check_equiv(cl)
        base_full = cl.gossip_full_syncs
        assert base_full == 2

        # put-only window: every tick ships only the add-set, no resyncs
        eids = []
        for j in range(4):
            eid, _ = store.put([j * 50 + k for k in range(32)], _art(j), tier="host_dram")
            eids.append(eid)
            cl.gossip_now()
            self._check_equiv(cl)
        assert cl.gossip_full_syncs == base_full
        assert cl.gossip_delta_hashes > 0

        # a removal (discard) bumps the digest epoch: bloom bits cannot be
        # cleared, so the next tick full-rebuilds — and stays exact
        assert store.discard(eids[1])
        cl.gossip_now()
        self._check_equiv(cl)
        assert cl.gossip_full_syncs == base_full + 1

        # an eviction is a removal too
        assert store._evict_one("host_dram")
        cl.gossip_now()
        self._check_equiv(cl)
        assert cl.gossip_full_syncs == base_full + 2

        # and after a resync, deltas resume
        deltas = cl.gossip_delta_hashes
        store.put(list(range(900, 932)), _art(9), tier="host_dram")
        cl.gossip_now()
        self._check_equiv(cl)
        assert cl.gossip_full_syncs == base_full + 2
        assert cl.gossip_delta_hashes > deltas

    def test_quiescent_ticks_ship_nothing(self, qwen):
        """No store mutations between ticks => no hashes, no resyncs (the
        steady-state wire cost of gossip is zero)."""
        cl = self._cluster(qwen)
        cl.replicas[0].store.put(list(range(32)), _art(0), tier="host_dram")
        cl.gossip_now()
        full, deltas = cl.gossip_full_syncs, cl.gossip_delta_hashes
        for _ in range(3):
            cl.gossip_now()
            self._check_equiv(cl)
        assert cl.gossip_full_syncs == full
        assert cl.gossip_delta_hashes == deltas


# --------------------------------------------------------------------------- #
# The port held to the reference
# --------------------------------------------------------------------------- #
def _hashes(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = [f"h{i}" for i in range(n)]
    for _ in range(3):
        out += chunk_hash_chain(rng.integers(0, 512, 96).tolist(), 16)
    return out


@pytest.mark.parametrize("m_bits,k", [(1 << 14, 4), (1 << 10, 3), (97, 7)])
def test_bloom_digest_bits_equal_reference(m_bits, k):
    hashes = _hashes()
    d, jd = BloomDigest(m_bits, k), jrouter.BloomDigest(m_bits, k)
    d.update(hashes)
    jd.update(hashes)
    assert d._bits == jd._bits and d.n_added == jd.n_added
    assert (d.fill, d.nbytes) == (jd.fill, jd.nbytes)
    probes = _hashes(seed=1)
    assert [h in d for h in probes] == [h in jd for h in probes]


def test_ring_owners_equal_reference():
    ring, jring = ConsistentHashRing(range(4)), jrouter.ConsistentHashRing(range(4))
    keys = [f"ctx{i}" for i in range(150)] + _hashes(seed=2)[:150]
    assert [ring.owner(k) for k in keys] == [jring.owner(k) for k in keys]
    assert len({ring.owner(k) for k in keys}) == 4
    ring.remove(1)
    jring.remove(1)
    owners = [ring.owner(k) for k in keys]
    assert owners == [jring.owner(k) for k in keys] and 1 not in owners
    ring.add(1)
    jring.add(1)
    assert [ring.owner(k) for k in keys] == [jring.owner(k) for k in keys]


def test_routing_terms_equal_reference():
    """``delay_routed`` and ``cost_routed_request`` over a grid of matched
    tokens, tiers, queue waits and compression factors, on the paper's
    hardware and prices from each package."""
    cfg, jcfg = get_config("llama-7b"), jget_config("llama-7b")
    perf, jperf = PerfModel(V100_X4_HF), JPerfModel(J_V100)
    for L_ctx, L_prompt, L_out in ((1000, 32, 16), (10_000, 8, 64)):
        w = cost_model.Workload(L_context=L_ctx, L_prompt=L_prompt, L_output=L_out, N=5)
        jw = jcost.Workload(L_context=L_ctx, L_prompt=L_prompt, L_output=L_out, N=5)
        grid = itertools.product((0, 16, L_ctx // 2, L_ctx, 2 * L_ctx),
                                 (None, "host_dram", "local_nvme", "io2", "s3"),
                                 (0.0, 0.05, 1.5), (1.0, 0.53))
        for matched, tier, queue_s, comp in grid:
            kw = dict(matched_tokens=matched, tier=tier, queue_s=queue_s, compression=comp)
            d = cost_model.delay_routed(cfg, w, perf, AWS_PAPER, **kw)
            jd = jcost.delay_routed(jcfg, jw, jperf, J_AWS, **kw)
            _close(d, jd, f"delay {kw}")
            assert d.ttft_s == pytest.approx(jd.ttft_s, abs=1e-9)
            c = cost_model.cost_routed_request(cfg, w, AWS_PAPER, perf, **kw)
            jc = jcost.cost_routed_request(jcfg, jw, J_AWS, jperf, **kw)
            assert c == pytest.approx(jc, abs=1e-9, rel=1e-12), kw


def _seed_artifacts(qwen, contexts):
    """Each context's stored artifact, made once by a throwaway reference
    engine on the paper's hardware: (reference tree, the same arrays as the
    port's tree, saved_per_use).  Both sides seed the same bytes, so a copy
    of them can be held to the reference exactly."""
    jcfg, jparams = qwen[0], qwen[1]
    out = []
    for ctx in contexts:
        eng = jserving.ServingEngine(
            jcfg, jparams, engine_cfg=jserving.EngineConfig(
                max_slots=2, max_len=128, chunk_tokens=16, store_tier="host_dram",
                tier_specs=[jhierarchy.TierSpec(t.name, t.capacity_gb) for t in SPECS]),
            planner=jserving.AlwaysReusePlanner(), pricing=J_AWS, perf=JPerfModel(J_V100))
        eng.submit(jserving.Request(req_id=0, context_tokens=ctx, prompt_tokens=[1, 2, 3],
                                    max_new_tokens=1, expected_reuses=4))
        eng.run()
        (eid, entry), = eng.store.entries.items()
        jart = eng.store.backends[entry.tier].peek(eid)
        c = jart.caches[0].attn
        art = lm.LMState(pos=np.asarray(jart.pos),
                         caches=(BlockCache(KVCache(np.asarray(c.k), np.asarray(c.v))),))
        out.append((jart, art, entry.saved_per_use))
    return out


def _both_clusters(qwen, reqs, router, cc_kw, ec_kw, seed_contexts=(), seed_tier="host_dram"):
    """The same cluster on the port and on the reference, serving ``reqs``
    on the paper's hardware and prices behind each package's ``router``
    (``"affinity"`` or ``"round_robin"``).  Each context of
    ``seed_contexts`` is first put into replica 0's ``seed_tier``, with the
    same bytes on both sides (``_seed_artifacts``)."""
    jcfg, jparams, cfg, params = qwen
    seeds = _seed_artifacts(qwen, seed_contexts)
    sides = []
    for mod, hmod, c, p in ((pserving, phierarchy, cfg, params),
                            (jserving, jhierarchy, jcfg, jparams)):
        port = mod is pserving
        specs = [hmod.TierSpec(t.name, t.capacity_gb) for t in SPECS]
        ec = mod.EngineConfig(**{**dict(max_slots=2, max_len=128, chunk_tokens=16,
                                        tier_specs=specs, store_tier="host_dram",
                                        cost_arch="llama-7b"), **ec_kw})
        hw = _paper_hw() if port else dict(pricing=J_AWS, perf=JPerfModel(J_V100))
        rt = {"affinity": mod.AffinityRouter, "round_robin": mod.RoundRobinRouter}[router]()
        cl = mod.ServingCluster(c, p, cluster_cfg=mod.ClusterConfig(**cc_kw), engine_cfg=ec,
                                router=rt, planner_factory=mod.AlwaysReusePlanner,
                                **hw, **(dict(device="cpu") if port else {}))
        for ctx, (jart, art, saved) in zip(seed_contexts, seeds):
            eid, _ = cl.replicas[0].store.put(ctx, art if port else jart, tier=seed_tier,
                                              saved_per_use=saved)
            assert eid is not None
        for r in reqs:
            cl.submit(mod.Request(**r))
        s = cl.run()
        sides.append((cl, s))
    return sides


def _kv(art):
    """(pos, k, v) of a stored dense artifact, as host arrays."""
    c = art.caches[0].attn
    return [np.asarray(x) for x in (art.pos, c.k, c.v)]


@pytest.mark.parametrize("case", ["affinity", "round_robin_rebalance",
                                  "round_robin_rebalance_int8"])
def test_cluster_replays_reference(qwen, case):
    """Two replicas over a shared s3 tier, on both packages: tokens exactly
    equal, every record field, the merged event stream (every
    ``RequestRouted`` and ``ReplicaRebalanced`` among them), gossip counts,
    ``stats()`` and the summary at 1e-9.  The round-robin cases run with
    write-back off and replica 0 holding the three contexts, so the context
    whose traffic concentrates on replica 1 is copied there: from the host
    tier, or, in the int8 case, from an int8 ``local_nvme`` entry that the
    rebalance dequantises (on the target store's device) into the target's
    host tier.  Each copy's bytes, nbytes and flags equal the reference's."""
    reqs = _skewed_requests(qwen[2].vocab)
    if case == "affinity":
        (cl, s), (jcl, js) = _both_clusters(qwen, reqs, "affinity",
                                            dict(n_replicas=2, gossip_interval_s=0.05), {})
    else:
        int8 = case.endswith("int8")
        contexts = list({tuple(r["context_tokens"]): None for r in reqs})
        (cl, s), (jcl, js) = _both_clusters(
            qwen, reqs, "round_robin",
            dict(n_replicas=2, gossip_interval_s=0.05, rebalance_interval_s=0.05,
                 rebalance_min_hits=2),
            dict(store_write_back=False, **(dict(compress_tier="local_nvme") if int8 else {})),
            seed_contexts=[list(c) for c in contexts],
            seed_tier="local_nvme" if int8 else "host_dram")
        assert cl.rebalances >= 1
        copies = [e for _, e in cl.events if isinstance(e, ev.ReplicaRebalanced)]
        for e in copies:
            donor = [d for d in cl.replicas[e.from_replica].store.entries.values()
                     if d.content_key == e.content_key]
            tgt = [d for d in cl.replicas[e.to_replica].store.entries.values()
                   if d.content_key == e.content_key]
            jtgt = [d for d in jcl.replicas[e.to_replica].store.entries.values()
                    if d.content_key == e.content_key]
            # the donor kept its copy, in the int8 tier in the int8 case
            assert [(d.tier, d.compressed) for d in donor] == (
                [("local_nvme", True)] if int8 else [("host_dram", False)])
            assert len(tgt) == len(jtgt) == 1 and not tgt[0].compressed
            assert (tgt[0].tier, tgt[0].nbytes, tgt[0].compressed) == (
                jtgt[0].tier, jtgt[0].nbytes, jtgt[0].compressed) == (
                "host_dram", e.nbytes, False)
            got = cl.replicas[e.to_replica].store.backends["host_dram"].peek(tgt[0].entry_id)
            want = jcl.replicas[e.to_replica].store.backends["host_dram"].peek(jtgt[0].entry_id)
            for g, w in zip(_kv(got), _kv(want)):
                assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
                assert np.abs(g.astype(np.float64) - w).max() <= 1e-9
    recs = sorted(cl.records, key=lambda r: r.req_id)
    jrecs = sorted(jcl.records, key=lambda r: r.req_id)
    assert [r.req_id for r in recs] == [r.req_id for r in jrecs] == list(range(16))
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    assert [(i, type(e).__name__) for i, e in cl.events] == \
        [(i, type(e).__name__) for i, e in jcl.events]
    routed = [e for _, e in cl.events if isinstance(e, ev.RequestRouted)]
    jrouted = [e for _, e in jcl.events if isinstance(e, jev.RequestRouted)]
    assert len(routed) == 16
    assert [(e.req_id, e.replica, e.matched_tokens, e.ring_owner) for e in routed] == \
        [(e.req_id, e.replica, e.matched_tokens, e.ring_owner) for e in jrouted]
    rebal = [dataclasses.asdict(e) for _, e in cl.events if isinstance(e, ev.ReplicaRebalanced)]
    jrebal = [dataclasses.asdict(e) for _, e in jcl.events
              if isinstance(e, jev.ReplicaRebalanced)]
    assert rebal == jrebal
    _close(cl.events, jcl.events, "events")
    for attr in ("gossip_ticks", "gossip_full_syncs", "gossip_delta_hashes", "rebalances"):
        assert getattr(cl, attr) == getattr(jcl, attr), attr
    _close(cl.stats(), jcl.stats(), "stats")
    assert cl.stats()["shared"] == jcl.stats()["shared"]
    _close(s.as_dict(), js.as_dict(), "summary")
    assert s.reuse_hits > 0 and cl.router.stats() == jcl.router.stats()


# --------------------------------------------------------------------------- #
# chip_smoke.py's cluster serves, on both packages
# --------------------------------------------------------------------------- #
SMOKE_CTX, SMOKE_PROMPT, SMOKE_NEW, SMOKE_VARIANT = 2000, 32, 16, 1600
# the time chip_smoke.py's round-robin serve crashes replica 1 at: half the
# modelled decode of request 7 after replica 1 admitted it (llama-7b on the
# H100 model, which cost_arch gives the reduced replicas too)
SMOKE_CRASH_S = 3.692335


def _smoke_mix(vocab):
    """``chip_smoke.py``'s prefix mix: eight requests over two 2,000-token
    contexts A and B in four waves one modelled second apart (A, B; A, B;
    A and a variant of B sharing its first 1,600 tokens; A, A)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, vocab, SMOKE_CTX).tolist()
    b = rng.integers(0, vocab, SMOKE_CTX).tolist()
    b_variant = b[:SMOKE_VARIANT] + rng.integers(
        0, vocab, SMOKE_CTX - SMOKE_VARIANT + 16).tolist()
    contexts = [a, b, a, b, a, b_variant, a, a]
    return [dict(req_id=i, context_tokens=ctx,
                 prompt_tokens=rng.integers(0, vocab, SMOKE_PROMPT).tolist(),
                 max_new_tokens=SMOKE_NEW, arrival_s=float(i // 2), expected_reuses=3)
            for i, ctx in enumerate(contexts)]


def _h100_both():
    """The port engine's default hardware and prices (``h100(1)``,
    ``h100_pricing(1)``), for each package, field by field."""
    hw, pr = h100(1), h100_pricing(1)
    jpr = jpricing.Pricing(
        compute=jpricing.ComputePrice(**dataclasses.asdict(pr.compute)),
        tiers={n: jpricing.StorageTier(**dataclasses.asdict(t)) for n, t in pr.tiers.items()},
        default_tier=pr.default_tier)
    return (dict(perf=PerfModel(hw), pricing=pr, device="cpu"),
            dict(perf=jperf_model.PerfModel(jperf_model.HardwareSpec(**dataclasses.asdict(hw))),
                 pricing=jpr))


@pytest.fixture(scope="module")
def smoke_mix(llama):
    """``chip_smoke.py``'s cluster serves 2 and 3 on both packages, at the
    reduced llama-7b's width priced as llama-7b (``cost_arch``): two
    replicas at the smoke's ``max_slots=4, max_len=4096`` over host_dram 64
    GB and one shared s3 1024 GB tier, gossip every 0.5 s,
    ``CostAwarePlanner``, H100 prices and perf.  Cases: affinity, round
    robin, and round robin with replica 1 crashing at ``SMOKE_CRASH_S``.
    Returns {case: ((cluster, summary), (reference cluster, summary))}."""
    jcfg, jparams, cfg, params = llama
    reqs = _smoke_mix(cfg.vocab)
    port_hw, ref_hw = _h100_both()
    runs = {}
    for case in ("affinity", "round_robin", "round_robin_crash"):
        sides = []
        for mod, hmod, fmod, c, p, hw in ((pserving, phierarchy, pfaults, cfg, params, port_hw),
                                          (jserving, jhierarchy, jfaults, jcfg, jparams, ref_hw)):
            ec_kw = {}
            if case.endswith("crash"):
                inj = fmod.FaultInjector(seed=0)
                inj.schedule_crash(1, SMOKE_CRASH_S)
                ec_kw = dict(faults=inj)
            ec = mod.EngineConfig(max_slots=4, max_len=4096, cost_arch="llama-7b",
                                  tier_specs=[hmod.TierSpec("host_dram", 64),
                                              hmod.TierSpec("s3", 1024)], **ec_kw)
            router = (mod.AffinityRouter if case == "affinity" else mod.RoundRobinRouter)()
            cl = mod.ServingCluster(
                c, p, cluster_cfg=mod.ClusterConfig(n_replicas=2, gossip_interval_s=0.5,
                                                    shared_tier="s3"),
                engine_cfg=ec, router=router, planner_factory=mod.CostAwarePlanner, **hw)
            for r in reqs:
                cl.submit(mod.Request(**r))
            sides.append((cl, cl.run()))
        runs[case] = sides
    return runs


@pytest.mark.parametrize("case", ["affinity", "round_robin", "round_robin_crash"])
def test_smoke_mix_cluster_replays_reference(smoke_mix, case):
    """Each of ``chip_smoke.py``'s two-replica serves, on both packages:
    tokens exact, the same routing (replica, matched tokens, ring owner),
    every record and event at 1e-9, the shared core's stats and the
    summary; the crash harvests a request in flight."""
    (cl, s), (jcl, js) = smoke_mix[case]
    recs = sorted(cl.records, key=lambda r: r.req_id)
    jrecs = sorted(jcl.records, key=lambda r: r.req_id)
    assert [r.req_id for r in recs] == [r.req_id for r in jrecs] == list(range(8))
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    routed = [(i, e.req_id, e.replica, e.matched_tokens, e.ring_owner) for i, e in cl.events
              if isinstance(e, ev.RequestRouted)]
    assert routed == [(i, e.req_id, e.replica, e.matched_tokens, e.ring_owner)
                      for i, e in jcl.events if isinstance(e, jev.RequestRouted)]
    assert [(i, type(e).__name__) for i, e in cl.events] == \
        [(i, type(e).__name__) for i, e in jcl.events]
    _close(cl.events, jcl.events, "events")
    assert cl.stats()["shared"] == jcl.stats()["shared"]
    _close(s.as_dict(), js.as_dict(), "summary")
    assert not [e for _, e in cl.events if isinstance(e, ev.FetchFailed)]
    crashed = [e for _, e in cl.events if isinstance(e, ev.ReplicaCrashed)]
    if case.endswith("crash"):
        assert len(crashed) == 1 and crashed[0].replica == 1
        assert crashed[0].inflight + crashed[0].queued >= 1
        assert cl.core.stats()["dedup_hits"] >= 1
    else:
        assert not crashed


def test_smoke_mix_affinity_trails_round_robin(smoke_mix):
    """On ``chip_smoke.py``'s mix both packages count 4 reuse hits behind
    the affinity router and 5 behind round robin, with the crash or without
    it.  Affinity keeps waves 0-2 on the contexts' ring owner; when wave 3
    arrives, the owner's four slots all hold requests of waves 1 and 2
    (their s3 loads are long), so the capacity rule sends both of wave 3's
    requests for A to the other replica, which holds nothing and
    recomputes."""
    hits = {case: (s.reuse_hits, js.reuse_hits) for case, ((_, s), (_, js)) in smoke_mix.items()}
    assert hits == {"affinity": (4, 4), "round_robin": (5, 5), "round_robin_crash": (5, 5)}
    for cl, _ in smoke_mix["affinity"]:
        routed = {e.req_id: e for _, e in cl.events if type(e).__name__ == "RequestRouted"}
        owner = routed[0].ring_owner
        assert all(routed[i].replica == owner for i in range(6))
        assert [(routed[i].replica, routed[i].matched_tokens) for i in (6, 7)] == \
            [(1 - owner, 0)] * 2
        busy = [r for r in cl.replicas[owner].records
                if r.arrival_s < 3.0 and r.finish_s > 3.0]
        assert len(busy) == cl.replicas[owner].ec.max_slots, busy


def test_default_hardware_is_the_port_engines(qwen):
    """With no pricing or perf, every replica's transfer model is a bare
    port engine's (``h100_pricing(1)``, ``PerfModel(h100(1))``), and its
    backends bill through it."""
    cfg, params = qwen[2], qwen[3]
    cl = ServingCluster(cfg, params, cluster_cfg=ClusterConfig(n_replicas=2),
                        engine_cfg=_cluster_ec(), device="cpu")
    bare = ServingEngine(cfg, params, engine_cfg=_cluster_ec(), device="cpu")
    for eng in cl.replicas:
        assert dataclasses.asdict(eng.transfer.perf.hw) == dataclasses.asdict(bare.transfer.perf.hw)
        assert dataclasses.asdict(eng.transfer.pricing) == \
            dataclasses.asdict(bare.transfer.pricing)
        assert dataclasses.asdict(eng.pricing) == dataclasses.asdict(bare.pricing)
        assert all(getattr(b, "transfer", eng.transfer) is eng.transfer
                   for b in eng.backends.values())
        assert isinstance(eng.backends["s3"], SharedTierBackend)


def test_cluster_takes_a_market(qwen):
    """``market=`` makes each replica its tenant of the marketplace: one
    session per replica under ``ClusterConfig.tenants``, each engine's store
    published, and a ``MarketPlanner`` built bare by the factory shopping
    through its own replica's session (served and held to the reference in
    ``tests/test_torch_market.py``)."""
    mp = Marketplace()
    cl = ServingCluster(qwen[2], qwen[3], engine_cfg=_cluster_ec(), device="cpu", market=mp,
                        cluster_cfg=ClusterConfig(n_replicas=2, tenants=["a", "b"]),
                        planner_factory=lambda: MarketPlanner(AlwaysReusePlanner()))
    assert sorted(mp.tenants) == sorted(mp.sessions) == ["a", "b"]
    for name, eng in zip(("a", "b"), cl.replicas):
        assert eng.market is mp.sessions[name] and eng.planner.session is eng.market
        assert mp.sessions[name].engine is eng and mp.tenants[name].store is eng.store


def test_cluster_needs_a_device_without_cuda(qwen):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingCluster(qwen[2], qwen[3], engine_cfg=_cluster_ec())
