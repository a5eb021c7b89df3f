"""Cluster serving: N engine replicas, private hot tiers, one shared cold.

The paper prices KV reuse for a single engine; a fleet changes two terms:

  * Reuse frequency is PER REPLICA.  A cache-oblivious router that scatters
    a context's requests over N replicas divides its frequency by N — enough
    to push stored KV below break-even.  The ``AffinityRouter`` keeps a
    context's traffic on the replica that holds (or will hold) its KV.
  * Cold storage need not be replicated.  All replicas mount one
    content-addressed ``SharedBackendCore`` as their last tier: identical
    write-backs dedup to a single payload, and refcounted ownership means
    one replica's eviction (or crash) can never orphan an entry another
    replica still serves from.

Topology (``ClusterConfig.n_replicas`` = N, ``shared_tier`` = "s3"):

    requests ──> router ──> engine r0: host_dram -> local_nvme ─┐
                       ──> engine r1: host_dram -> local_nvme ─┼──> shared s3
                       ──> engine rN: host_dram -> local_nvme ─┘    (one core)

Every replica runs on a PRIVATE SimClock + TransferModel: its queueing,
link fees, and storage accrual are its own bill.  The cluster advances the
simulation by always stepping the busy replica whose local clock is
furthest behind, so cross-replica state (gossip digests, routing views,
rebalancing) is only ever read at the cluster frontier
``min(busy clocks)`` — never from a replica's future.

Routing happens at ARRIVAL time, against the latest gossiped
``BloomDigest`` of each replica's stored hashes (staleness-tolerant: a
stale or false-positive digest bit mis-prices a route; the landing replica
recomputes on the miss and tokens are unaffected).  Rebalancing is
copy-then-keep: when a context's routed traffic concentrates on a replica
that does not hold its KV, the donor's bytes are copied over the shared
tier into the target's hot tier while the donor keeps serving — replicated
residency, no window where the entry is unreachable from either replica.

A 1-replica cluster with the affinity router is bit- and bill-identical to
a bare ``ServingEngine`` (tests/test_torch_cluster.py replays the golden
seed trace through it).

This is the port of the reference's cluster.  Every replica runs on
``device`` (the card unless the caller asks for another).  Its pricing and
perf default to the port engine's own, ``h100_pricing(1)`` and
``PerfModel(h100(1))``.  ``trace=`` (a ``serving.trace.TraceWriter``)
writes every replica-tagged event as it is emitted, and ``telemetry=`` (an
``obs.Telemetry``) is shared by every replica.  ``market=`` (a
``market.Marketplace``) makes each replica a tenant of it, under
``ClusterConfig.tenants``."""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.perf_model import PerfModel, h100
from repro_torch.core.pricing import Pricing, h100_pricing
from repro_torch.kvcache import compression
from repro_torch.kvcache.hierarchy import (
    _BACKEND_KINDS,
    _default_kind,
    ConcurrencyLimitedBackend,
    SharedBackendCore,
    SharedTierBackend,
    StoredEntry,
    TierSpec,
)
from repro_torch.kvcache.transfer import SimClock, TransferModel
from repro_torch.models.common import resolve_device
from repro_torch.serving import events as ev
from repro_torch.serving import metrics as metrics_mod
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request
from repro_torch.serving.router import AffinityRouter, BloomDigest, ReplicaView


@dataclasses.dataclass
class ClusterConfig:
    n_replicas: int = 2
    # Tier name (from the engine's tier specs) backed by ONE shared
    # SharedBackendCore across all replicas.  A name absent from the specs
    # (e.g. the default EngineConfig's host_dram/io2 hierarchy) silently
    # disables sharing — which is what keeps a 1-replica cluster on the
    # seed configuration bit-identical to a bare engine.
    shared_tier: Optional[str] = "s3"
    # Digest gossip cadence in cluster time; <=0 disables gossip (the
    # affinity router then routes on the consistent-hash ring alone).
    gossip_interval_s: float = 1.0
    digest_bits: int = 1 << 14
    digest_hashes: int = 4
    # Copy-then-keep rebalancing cadence; <=0 disables.  A context is copied
    # toward a replica once that replica has absorbed ``rebalance_min_hits``
    # routed requests for it without holding its KV.
    rebalance_interval_s: float = 0.0
    rebalance_min_hits: int = 3
    # Router view: expected per-request service time used to estimate the
    # queue wait of a replica with no free capacity.
    est_service_s: float = 0.05
    # Tenant tags, one per replica (marketplace runs: each replica serves a
    # tenant, and its shared-tier namespace carries the tenant's name so
    # dedup'd bytes stay attributable).  None = anonymous "r{i}" namespaces.
    tenants: Optional[List[str]] = None


class ServingCluster:
    """N ``ServingEngine`` replicas behind one router over a shared cold tier.

    Same surface shape as the engine: ``submit`` requests, ``step``/``run``
    the simulation, read ``events`` / ``records`` / ``summary()``.  Events
    come back replica-tagged: ``events`` is the merged cluster stream of
    ``(replica, event)`` pairs in emission order, ``events_by_replica[i]``
    each replica's own stream (cluster-level routing/rebalance events are
    filed under the replica they concern)."""

    def __init__(
        self,
        cfg,
        params,
        *,
        cluster_cfg: Optional[ClusterConfig] = None,
        engine_cfg: Optional[EngineConfig] = None,
        router=None,
        planner_factory=None,
        pricing: Optional[Pricing] = None,
        perf: Optional[PerfModel] = None,
        trace=None,
        on_token=None,
        telemetry=None,
        market=None,
        device=None,
    ):
        """``device`` is where every replica's model runs: the card unless
        the caller asks for another (``device="cpu"``); with no CUDA and no
        device given, this raises.  ``params`` must already live there."""
        self.device = resolve_device(device)
        self.trace = trace
        # replica engines feed their own events to telemetry from step(); the
        # cluster feeds only its cluster-level events (routing, rebalance,
        # crashes) and gossip ticks, so nothing is counted twice
        self.telemetry = telemetry
        # each replica joins the marketplace as its tenant; a MarketPlanner
        # built by planner_factory gets that replica's session.  None = no
        # market (the default cluster, unchanged).
        self.market = market
        self.cc = cluster_cfg or ClusterConfig()
        self.ec = engine_cfg or EngineConfig()
        n = self.cc.n_replicas
        assert n >= 1, n

        if self.ec.tier_specs is not None:
            specs = list(self.ec.tier_specs)
        else:
            specs = [
                TierSpec(nm, gb) for nm, gb in self.ec.tier_capacities_gb.items()
            ]
        shared = self.cc.shared_tier
        self.core: Optional[SharedBackendCore] = (
            SharedBackendCore()
            if shared is not None and any(s.name == shared for s in specs)
            else None
        )

        self.tenants: List[str] = (
            list(self.cc.tenants)
            if self.cc.tenants is not None
            else [f"r{i}" for i in range(n)]
        )
        assert len(self.tenants) == n, (self.tenants, n)
        self.replicas: List[ServingEngine] = [
            self._build_replica(
                i, cfg, params, specs, planner_factory, pricing, perf, on_token
            )
            for i in range(n)
        ]

        self._alive: List[bool] = [True] * n
        self._digests: List[Optional[BloomDigest]] = [None] * n
        # delta gossip: replica -> (store digest_epoch, log cursor) at the
        # last tick, so put-only windows ship just the add-set
        self._digest_state: Dict[int, Tuple[int, int]] = {}
        self.gossip_ticks = 0
        self.gossip_full_syncs = 0  # ticks that had to rebuild a digest
        self.gossip_delta_hashes = 0  # hashes shipped as deltas instead
        self._next_gossip = (
            self.cc.gossip_interval_s if self.cc.gossip_interval_s > 0
            else float("inf")
        )
        self._next_rebalance = (
            self.cc.rebalance_interval_s if self.cc.rebalance_interval_s > 0
            else float("inf")
        )

        self.router = router or AffinityRouter()
        r0 = self.replicas[0]
        self.router.configure(
            cost_cfg=r0.cost_cfg,
            pricing=r0.pricing,
            perf=r0.perf,
            chunk_tokens=self.ec.chunk_tokens,
            replica_ids=list(range(n)),
        )

        # pending heap: (arrival_s, seq, Request) — routed at arrival time so
        # gossip that lands between now and then can inform the decision
        self._pending: List[Tuple[float, int, Request]] = []
        self._seq = itertools.count()
        self.events: List[Tuple[int, ev.Event]] = []
        self.events_by_replica: List[List[ev.Event]] = [[] for _ in range(n)]
        # content_key -> routed-request counts per replica, and the tokens
        # needed to re-materialize the context on a rebalance target
        self._route_hits: Dict[str, Dict[int, int]] = {}
        self._ctx_tokens: Dict[str, Tuple[int, ...]] = {}
        self.rebalances = 0

    # ------------------------------------------------------------------ #
    # Construction
    # ------------------------------------------------------------------ #
    def _build_replica(
        self, i, cfg, params, specs, planner_factory, pricing, perf, on_token,
    ) -> ServingEngine:
        """One engine with a PRIVATE clock/transfer and private hot backends;
        the shared tier (if configured) is a namespaced view onto the one
        cluster core, billed through this replica's own transfer model."""
        clock = SimClock()
        eng_perf = perf
        eng_pricing = pricing
        # The engine defaults pricing/perf itself; to hand backends a
        # transfer model consistent with the engine's, resolve defaults the
        # same way the engine does.
        if eng_pricing is None or eng_perf is None:
            eng_pricing = eng_pricing or h100_pricing(1)
            eng_perf = eng_perf or PerfModel(h100(1))
        transfer = TransferModel(eng_perf, eng_pricing)

        backends: Dict[str, Any] = {}
        for spec in specs:
            if self.core is not None and spec.name == self.cc.shared_tier:
                b = SharedTierBackend(
                    spec.name, core=self.core, namespace=self.tenants[i],
                    transfer=transfer, clock=clock, faults=self.ec.faults,
                )
            else:
                kind = _BACKEND_KINDS[spec.backend or _default_kind(spec.name)]
                b = kind(
                    spec.name, transfer=transfer, clock=clock,
                    hedge=self.ec.hedge if kind.hedgeable else None,
                    faults=self.ec.faults,
                )
            if spec.concurrency is not None:
                b = ConcurrencyLimitedBackend(b, spec.concurrency, clock=clock)
            backends[spec.name] = b

        # a bare MarketPlanner from the factory gets the replica's session
        # from the engine, which binds it
        session = self.market.join(self.tenants[i]) if self.market is not None else None
        return ServingEngine(
            cfg,
            params,
            engine_cfg=self.ec,
            planner=planner_factory() if planner_factory else None,
            backends=backends,
            pricing=pricing,
            perf=perf,
            clock=clock,
            transfer=transfer,
            on_token=((lambda e, _i=i: on_token(_i, e)) if on_token else None),
            telemetry=self.telemetry,
            telemetry_replica=i,
            market=session,
            device=self.device,
        )

    # ------------------------------------------------------------------ #
    # Public API
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        heapq.heappush(self._pending, (req.arrival_s, next(self._seq), req))

    @property
    def idle(self) -> bool:
        return not self._pending and all(
            e.idle for e, a in zip(self.replicas, self._alive) if a
        )

    def cluster_now(self) -> Optional[float]:
        """The simulation frontier: the furthest-behind busy replica's local
        time (None = every replica idle)."""
        busy = [
            e.clock.now
            for e, a in zip(self.replicas, self._alive)
            if a and not e.idle
        ]
        return min(busy) if busy else None

    def step(self) -> List[Tuple[int, ev.Event]]:
        """One cluster scheduling step: dispatch due arrivals through the
        router, run due gossip/rebalance ticks, then step the busy replica
        with the smallest local clock.  Returns that step's replica-tagged
        events (also appended to ``events``)."""
        out: List[Tuple[int, ev.Event]] = []
        now = self.cluster_now()
        if now is None:
            if not self._pending:
                return out  # fully drained
            now = self._pending[0][0]  # all idle: jump to the next arrival

        # injected replica crashes fire at the cluster frontier, before any
        # replica steps past them
        if self.ec.faults is not None:
            for plan in self.ec.faults.due_crashes(now):
                if 0 <= plan.replica < len(self.replicas) and self._alive[
                    plan.replica
                ]:
                    self.crash_replica(plan.replica, now, out)

        # at most one tick per step: a long idle jump re-arms from `now`
        # instead of replaying every missed cadence slot
        if now >= self._next_gossip:
            self.gossip_now()
            self._next_gossip = now + self.cc.gossip_interval_s
        if now >= self._next_rebalance:
            self._rebalance(now, out)
            self._next_rebalance = now + self.cc.rebalance_interval_s

        while self._pending and self._pending[0][0] <= now:
            _, _, req = heapq.heappop(self._pending)
            self._dispatch(req, out)

        busy = [
            e for e, a in zip(self.replicas, self._alive) if a and not e.idle
        ]
        if busy:
            eng = min(busy, key=lambda e: e.clock.now)
            i = self.replicas.index(eng)
            for e_ in eng.step():
                self._emit(i, e_, out)
        self.events.extend(out)
        return out

    def run(self) -> metrics_mod.ClusterSummary:
        while not self.idle:
            self.step()
        return self.summary()

    def summary(self) -> metrics_mod.ClusterSummary:
        return metrics_mod.ClusterSummary(
            replicas=[e.summary() for e in self.replicas],
            tokens_generated=sum(
                len(r.tokens) for e in self.replicas for r in e.records
            ),
        )

    @property
    def records(self):
        return [r for e in self.replicas for r in e.records]

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "gossip_ticks": self.gossip_ticks,
            "rebalances": self.rebalances,
            "per_replica": [e.packed_stats() for e in self.replicas],
        }
        if self.core is not None:
            out["shared"] = self.core.stats()
        return out

    # ------------------------------------------------------------------ #
    # Routing
    # ------------------------------------------------------------------ #
    def views(self) -> List[ReplicaView]:
        """Live router view: load/capacity are current (the cluster owns
        both), digests are the last gossiped ones — stale by design."""
        vs = []
        for i, eng in enumerate(self.replicas):
            if not self._alive[i]:
                continue
            load = eng.load()
            free = eng.free_capacity()
            queue_s = (
                0.0 if free > 0
                else (load - eng.ec.max_slots + 1) * self.cc.est_service_s
            )
            vs.append(
                ReplicaView(
                    replica=i, load=load, free_slots=free, queue_s=queue_s,
                    digest=self._digests[i],
                    hit_tier=eng.store.tier_order[0],
                )
            )
        return vs

    def _dispatch(self, req: Request, out) -> None:
        d = self.router.decide(req, self.views())
        eng = self.replicas[d.replica]
        eng.submit(req)
        ck = eng.store.content_key(req.context_tokens)
        self._route_hits.setdefault(ck, {}).setdefault(d.replica, 0)
        self._route_hits[ck][d.replica] += 1
        self._ctx_tokens[ck] = tuple(req.context_tokens)
        self._emit_cluster(
            d.replica,
            ev.RequestRouted(
                t_s=req.arrival_s, req_id=req.req_id, replica=d.replica,
                matched_tokens=d.matched_tokens, score=d.score,
                ring_owner=d.ring_owner,
            ),
            out,
        )

    def _emit(self, replica: int, event: ev.Event, out) -> None:
        out.append((replica, event))
        self.events_by_replica[replica].append(event)
        if self.trace is not None:
            self.trace.write(event, replica=replica)

    def _emit_cluster(self, replica: int, event: ev.Event, out) -> None:
        """Emit a cluster-originated event (routing, rebalance, crash):
        engine events reach telemetry from the engine's own step(), these
        only from here."""
        self._emit(replica, event, out)
        if self.telemetry is not None:
            self.telemetry.on_events([event], replica=replica)

    # ------------------------------------------------------------------ #
    # Gossip
    # ------------------------------------------------------------------ #
    def gossip_now(self) -> None:
        """Refresh every live replica's bloom digest from its store's hash
        surface — incrementally.  Bloom adds are idempotent and commutative,
        so a put-only window ships just the ADD-SET since the last tick
        (``TieredStore.digest_view``); a removal (evict/discard) bumps the
        store's digest epoch — bloom bits cannot be cleared — forcing one
        full rebuild, after which deltas resume.  Either way the resulting
        bits are identical to a from-scratch rebuild every tick (the
        staleness-equivalence test in tests/test_torch_cluster.py).  Pure
        host-side work: nothing runs on the device."""
        nbytes = 0.0
        for i, eng in enumerate(self.replicas):
            if not self._alive[i]:
                continue
            epoch, log = eng.store.digest_view()
            state = self._digest_state.get(i)
            d = self._digests[i]
            if d is None or state is None or state[0] != epoch:
                d = BloomDigest(self.cc.digest_bits, self.cc.digest_hashes)
                d.update(log)
                self._digests[i] = d
                self.gossip_full_syncs += 1
                nbytes += self.cc.digest_bits / 8.0
            else:
                added = log[state[1]:]
                if added:
                    d.update(added)
                    self.gossip_delta_hashes += len(added)
                    # delta gossip ships the new hash ids, not the bitmap
                    nbytes += 16.0 * len(added)
            self._digest_state[i] = (epoch, len(log))
        self.gossip_ticks += 1
        if self.telemetry is not None:
            # digest traffic is host-side and unbilled: a zero-dollar ledger
            # entry records the bytes on the wire
            self.telemetry.note_gossip(nbytes=nbytes)

    # ------------------------------------------------------------------ #
    # Rebalancing (copy-then-keep)
    # ------------------------------------------------------------------ #
    def _find_entry(self, eng: ServingEngine, ck: str) -> Optional[StoredEntry]:
        for e in eng.store.entries.values():
            if e.content_key == ck:
                return e
        return None

    def _rebalance(self, now: float, out) -> None:
        """Move hot entries toward their traffic: for every context whose
        routed requests concentrate on a replica that does not hold its KV,
        copy the donor's bytes into the target's fastest tier.  The donor
        keeps its copy (replicated residency) — at no point is the entry
        unreachable from either replica."""
        for ck, hits in self._route_hits.items():
            target = max(
                hits, key=lambda r: (hits[r], -r),
            )
            if not self._alive[target]:
                continue
            if hits[target] < self.cc.rebalance_min_hits:
                continue
            t_eng = self.replicas[target]
            if self._find_entry(t_eng, ck) is not None:
                continue  # traffic already lands where the bytes are
            tokens = self._ctx_tokens.get(ck)
            if tokens is None:
                continue
            donor = None
            d_entry = None
            for i, eng in enumerate(self.replicas):
                if i == target or not self._alive[i]:
                    continue
                e = self._find_entry(eng, ck)
                if e is not None and e.pins == 0:
                    donor, d_entry = i, e
                    break
            if donor is None:
                continue
            d_eng = self.replicas[donor]
            payload = d_eng.store.backends[d_entry.tier].peek(d_entry.entry_id)
            if payload is None:
                continue
            # an int8 entry dequantises on the target store's device, and
            # its rows come back to the host, where the store keeps payloads
            art = (
                compression.to_host_tree(
                    compression.decompress_tree(payload, t_eng.store.device)
                )
                if d_entry.compressed else payload
            )
            with t_eng._attr("rebalance"):
                eid, _ = t_eng.store.put(
                    list(tokens), art,
                    tier=t_eng.store.tier_order[0],
                    saved_per_use=d_entry.saved_per_use,
                )
            if eid is None:
                continue
            self.rebalances += 1
            self._emit_cluster(
                target,
                ev.ReplicaRebalanced(
                    t_s=now, req_id=-1, content_key=ck,
                    from_replica=donor, to_replica=target,
                    nbytes=t_eng.store.entries[eid].nbytes,
                    hits=hits[target],
                ),
                out,
            )

    # ------------------------------------------------------------------ #
    # Membership
    # ------------------------------------------------------------------ #
    def crash_replica(self, idx: int, now: float, out) -> None:
        """Kill a replica mid-run and recover its work: harvest its in-flight
        (active-slot) and queued requests, release its shared-tier namespace
        and digest (``remove_replica``), and resubmit the harvested requests
        through the router to the survivors.  In-flight partial generations
        are discarded and replayed from scratch on the landing replica —
        decode is greedy and deterministic, so the resubmitted request's
        tokens are identical to the run where the crash never happened."""
        eng = self.replicas[idx]
        inflight = [
            s.request for s in eng.slots if s.active and s.request is not None
        ]
        queued = eng.queue.drain()
        released = self.remove_replica(idx)
        for req in inflight + queued:
            self.submit(dataclasses.replace(req, arrival_s=max(req.arrival_s, now)))
        self._emit_cluster(
            idx,
            ev.ReplicaCrashed(
                t_s=now, req_id=-1, replica=idx,
                inflight=len(inflight), queued=len(queued),
                released_keys=released,
            ),
            out,
        )

    def remove_replica(self, idx: int) -> int:
        """Take a replica out of the cluster (crash or drain-down): release
        every shared-tier key it owned — refcounting in the core keeps any
        content other replicas still reference alive — and drop it from the
        router's ring and view set.  Returns the number of shared keys
        released."""
        assert self._alive[idx], f"replica {idx} already removed"
        self._alive[idx] = False
        self._digests[idx] = None
        self._digest_state.pop(idx, None)
        released = 0
        for b in self.replicas[idx].backends.values():
            rel = getattr(b, "release_namespace", None)
            if callable(rel):
                released += rel()
        ring = getattr(self.router, "ring", None)
        if ring is not None:
            ring.remove(idx)
        return released
