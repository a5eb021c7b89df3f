"""The telemetry facade engines and clusters accept (off by default).

One ``Telemetry`` object bundles the three pillars:

  * ``registry`` — event-driven metrics (requests, TTFT/TBT/queue-wait
    histograms, loaded/written bytes per tier, the headline cache-hit-rate
    gauge) plus, after ``collect_engine``/``collect_cluster``, the absorbed
    engine/store/cluster counters (jit buckets, migration evals/skips,
    lookup walks, block-pool audit, packed/fused stats).
  * ``ledger`` — exact cost attribution: compute entries copy each finished
    record's accrued dollars, transfer entries arrive through the
    ``TransferModel`` fee hook (the engine brackets fetches/write-backs
    with an attribution context), storage settles from the store's per-tier
    meters at summary time.
  * ``events`` — the replica-tagged event buffer span trees build from.

Everything here is host-side Python on the engine's already-materialized
event objects: enabling telemetry launches no kernel and moves no tensor,
so a telemetry-on run gives the tokens, records, kernel launch counts and
shape-bucket counts of a telemetry-off run (asserted in
tests/test_torch_obs.py and by ``chip_smoke.py`` on the card).

The series and their names are the reference package's, so both packages
expose the same metrics.  The port runs eagerly: its ``jit_*`` gauges count
first calls (misses) and repeat calls (hits) per launch-shape bucket
(``serving/jit_cache.py``), not compiles.  A purchase's dollars settle in
the marketplace's own ``SettlementLedger``; here it is a zero-dollar
``kv_purchase`` marker, so the engine's conservation law holds with the
market on.

Usage::

    tel = Telemetry()
    eng = ServingEngine(cfg, params, ..., telemetry=tel)
    eng.run()
    tel.check(eng.summary())              # conservation at 1e-9
    print(tel.registry.to_prometheus())
    spans = tel.spans()
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.ledger import CostLedger, check_conservation
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import Span, build_cluster_spans, build_spans
from repro_torch.serving import events as ev

# decode-step gaps sit well under the latency buckets' floor
TBT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    0.01, 0.025, 0.05, 0.1, 0.5,
)


class Telemetry:
    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.ledger = CostLedger()
        self.events: List[Tuple[int, ev.Event]] = []
        self._last_token_t: Dict[Tuple[int, int], float] = {}
        self._hits = 0
        self._finished = 0

        r = self.registry
        self._m_requests = r.counter(
            "serving_requests_total", "Finished requests", ("replica", "action")
        )
        self._m_hit_rate = r.gauge(
            "kv_cache_hit_rate",
            "Headline gauge: fraction of finished requests served from "
            "stored KV (load/partial/fused)",
        )
        self._m_ttft = r.histogram(
            "ttft_seconds", "Time to first token", ("replica",)
        )
        self._m_tbt = r.histogram(
            "tbt_seconds", "Time between tokens (per-request decode gaps)",
            ("replica",), buckets=TBT_BUCKETS,
        )
        self._m_queue = r.histogram(
            "queue_wait_seconds", "Admission queue wait", ("replica",)
        )
        self._m_e2e = r.histogram(
            "e2e_seconds", "Request end-to-end latency", ("replica",)
        )
        self._m_tokens = r.counter(
            "tokens_emitted_total", "Generated tokens", ("replica",)
        )
        self._m_loaded = r.counter(
            "kv_loaded_bytes_total", "Billed KV fetch bytes",
            ("replica", "tier"),
        )
        self._m_writeback = r.counter(
            "kv_writeback_bytes_total", "KV write-back bytes",
            ("replica", "tier"),
        )
        self._m_migrations = r.counter(
            "tier_migrations_total", "Entries moved between tiers",
            ("replica", "reason"),
        )
        self._m_batches = r.counter(
            "packed_batches_total", "Packed admission batches",
            ("replica", "jit"),
        )
        self._m_fused = r.counter(
            "fused_admissions_total", "Fused (CacheBlend-style) admissions",
            ("replica", "jit"),
        )
        self._m_routed = r.counter(
            "requests_routed_total", "Router placements", ("replica",)
        )
        self._m_rebalanced = r.counter(
            "rebalances_total", "Copy-then-keep rebalance copies",
            ("replica",),
        )
        self._m_gossip = r.counter(
            "gossip_ticks_total", "Digest gossip rounds", ()
        )
        self._m_fetch_failed = r.counter(
            "kv_fetch_failures_total", "Failed KV fetch attempts",
            ("replica", "tier", "reason"),
        )
        self._m_fetch_retried = r.counter(
            "kv_fetch_retries_total",
            "Fetch attempts re-issued by the cost-aware retry policy",
            ("replica", "tier"),
        )
        self._m_degraded = r.counter(
            "requests_degraded_total",
            "Requests that fell back to exact recompute after fetch failure",
            ("replica",),
        )
        self._m_fetch_wasted = r.counter(
            "kv_fetch_wasted_bytes_total",
            "Bytes moved by fetch attempts that then failed",
            ("replica", "tier"),
        )
        self._m_crashes = r.counter(
            "replica_crashes_total", "Replicas lost mid-run", ("replica",)
        )
        self._m_purchases = r.counter(
            "kv_purchases_total", "Marketplace KV purchases settled",
            ("replica", "seller"),
        )
        self._m_purchased_bytes = r.counter(
            "kv_purchased_bytes_total", "Bytes bought from marketplace peers",
            ("replica", "seller"),
        )
        self._m_verifications = r.counter(
            "seller_verifications_total",
            "Purchased-payload verifications (checksum and/or spot check)",
            ("replica", "ok"),
        )
        self._m_blacklists = r.counter(
            "sellers_blacklisted_total",
            "Sellers ejected for corrupt deliveries", ("seller",),
        )

    # ------------------------------------------------------------------ #
    # Event-driven feed (engines call this from step())
    # ------------------------------------------------------------------ #
    def on_events(self, events: Iterable[ev.Event], *, replica: int = 0) -> None:
        for e in events:
            self.events.append((replica, e))
            self._observe(e, replica)

    def _observe(self, e: ev.Event, replica: int) -> None:
        if isinstance(e, ev.TokenEmitted):
            self._m_tokens.inc(replica=replica)
            key = (replica, e.req_id)
            last = self._last_token_t.get(key)
            if last is not None:
                self._m_tbt.observe(e.t_s - last, replica=replica)
            self._last_token_t[key] = e.t_s
        elif isinstance(e, ev.RequestAdmitted):
            self._m_queue.observe(e.queue_s, replica=replica)
        elif isinstance(e, ev.KVLoaded):
            self._m_loaded.inc(e.nbytes, replica=replica, tier=e.tier)
        elif isinstance(e, ev.StoreWriteBack):
            self._m_writeback.inc(e.nbytes, replica=replica, tier=e.tier)
        elif isinstance(e, ev.BatchAdmitted):
            self._m_batches.inc(
                replica=replica, jit="hit" if e.jit_hit else "miss"
            )
        elif isinstance(e, ev.FusedAdmitted):
            self._m_fused.inc(
                replica=replica, jit="hit" if e.jit_hit else "miss"
            )
        elif isinstance(e, ev.TierMigrated):
            self._m_migrations.inc(replica=replica, reason=e.reason)
            # uncharged byte movement: a zero-dollar entry keeps the "where
            # did the bytes go" view complete without breaking conservation
            self.ledger.add(
                "transfer", "migration", 0.0, replica=replica,
                tier=e.to_tier, nbytes=e.nbytes, kind="store",
            )
        elif isinstance(e, ev.FetchFailed):
            self._m_fetch_failed.inc(
                replica=replica, tier=e.tier, reason=e.reason
            )
            self._m_fetch_wasted.inc(
                e.wasted_bytes, replica=replica, tier=e.tier
            )
        elif isinstance(e, ev.FetchRetried):
            self._m_fetch_retried.inc(replica=replica, tier=e.tier)
        elif isinstance(e, ev.DegradedToRecompute):
            self._m_degraded.inc(replica=replica)
        elif isinstance(e, ev.ReplicaCrashed):
            self._m_crashes.inc(replica=e.replica)
        elif isinstance(e, ev.KVPurchased):
            self._m_purchases.inc(replica=replica, seller=e.seller)
            self._m_purchased_bytes.inc(
                e.nbytes, replica=replica, seller=e.seller
            )
            # purchase dollars settle in the marketplace's own
            # SettlementLedger (buyer debit == seller credit + fee at 1e-9);
            # a zero-dollar marker here keeps the bytes queryable per
            # request without double-billing the engine's conservation law
            self.ledger.add(
                "transfer", "kv_purchase", 0.0, replica=replica,
                req_id=e.req_id, tier=e.tier, nbytes=e.nbytes, kind="load",
            )
        elif isinstance(e, ev.SellerVerified):
            self._m_verifications.inc(
                replica=replica, ok="ok" if e.ok else "corrupt"
            )
        elif isinstance(e, ev.SellerBlacklisted):
            self._m_blacklists.inc(seller=e.seller)
        elif isinstance(e, ev.RequestRouted):
            self._m_routed.inc(replica=replica)
        elif isinstance(e, ev.ReplicaRebalanced):
            self._m_rebalanced.inc(replica=e.to_replica)
        elif isinstance(e, ev.RequestFinished):
            rec = e.record
            self._m_requests.inc(replica=replica, action=rec.action)
            self._m_ttft.observe(rec.ttft_s, replica=replica)
            self._m_e2e.observe(rec.e2e_s, replica=replica)
            self._finished += 1
            if rec.action in ("load", "partial", "fused"):
                self._hits += 1
            self._m_hit_rate.set(self._hits / max(self._finished, 1))
            self._last_token_t.pop((replica, e.req_id), None)
            # compute attribution: the record's accrued dollars are exactly
            # the engine's per-request prefill share + decode shares
            self.ledger.add(
                "compute", "request", rec.compute_cost,
                replica=replica, req_id=rec.req_id,
            )

    def note_gossip(self, nbytes: float = 0.0) -> None:
        """One gossip round (cluster digest rebuild): host-side, unbilled —
        a zero-dollar ledger entry records the digest bytes moved."""
        self._m_gossip.inc()
        self.ledger.add("transfer", "gossip", 0.0, nbytes=nbytes)

    # ------------------------------------------------------------------ #
    # Settlement + counter absorption
    # ------------------------------------------------------------------ #
    def settle_engine(self, engine, *, replica: int = 0) -> None:
        """Replace this replica's storage hold entries with the store's
        current per-tier accrual (called by ``ServingEngine.summary``)."""
        store = engine.store
        self.ledger.settle_storage(
            store.storage_cost_by_tier(engine.pricing),
            replica=replica,
            bytes_by_tier={
                n: t.used_bytes for n, t in store.tiers.items()
            },
        )

    def collect_engine(self, engine, *, replica: int = 0) -> None:
        """Absorb the engine's scattered counters into the registry (gauges
        set from the source of truth — idempotent, latest wins)."""
        r = self.registry
        rep = str(replica)
        info = r.gauge(
            "engine_info", "Engine identity", ("replica", "arch", "cost_arch")
        )
        info.set(
            1, replica=rep, arch=engine.cfg.name,
            cost_arch=engine.cost_cfg.name,
        )

        ps = engine.packed_stats()
        g = r.gauge("packed_occupancy", "Useful/padded packed tokens", ("replica",))
        g.set(ps["occupancy"], replica=rep)
        g = r.gauge("lookup_walks", "Real trie walks at admission", ("replica",))
        g.set(ps["lookup_walks"], replica=rep)
        g = r.gauge(
            "lookup_reuses", "Admissions served from the prefetch walk",
            ("replica",),
        )
        g.set(ps["lookup_reuses"], replica=rep)
        g = r.gauge("admission_busy_seconds", "Modeled load+prefill time", ("replica",))
        g.set(ps["admission_busy_s"], replica=rep)

        ds = engine.decode_stats()
        g = r.gauge("decode_busy_seconds", "Modeled decode time", ("replica",))
        g.set(ds["decode_busy_s"], replica=rep)
        g = r.gauge("decode_tokens", "Tokens emitted by decode steps", ("replica",))
        g.set(ds["decode_tokens"], replica=rep)
        if ds.get("paged"):
            for k in ("pool_blocks", "pool_blocks_used", "pool_blocks_peak",
                      "shared_block_hits"):
                g = r.gauge(k, "Shared KV block pool audit", ("replica",))
                g.set(ds[k], replica=rep)

        for path, jit in (
            ("packed", engine.jit_stats), ("fused", engine.fused_jit),
        ):
            g = r.gauge(
                "jit_cache_hits",
                "Launches on a shape bucket seen before (the port runs "
                "eagerly: a repeat call, not a compile-cache hit)",
                ("replica", "path"),
            )
            g.set(jit.hits, replica=rep, path=path)
            g = r.gauge(
                "jit_cache_misses",
                "First launches on a shape bucket (the port runs eagerly: "
                "a first call, not a compile)",
                ("replica", "path"),
            )
            g.set(jit.misses, replica=rep, path=path)
            g = r.gauge(
                "jit_calls_since_miss",
                "Consecutive launches on seen shape buckets since the "
                "last first call on a new shape bucket",
                ("replica", "path"),
            )
            g.set(jit.calls_since_miss, replica=rep, path=path)
            bg = r.gauge(
                "jit_bucket_calls",
                "Launches per (q_len, kv_len) shape bucket",
                ("replica", "path", "bucket"),
            )
            for bucket, n in jit.labeled_calls().items():
                bg.set(n, replica=rep, path=path, bucket=bucket)

        fs = engine.fused_stats()
        g = r.gauge("fused_reused_tokens", "Context tokens served from chunk KV", ("replica",))
        g.set(fs["reused_tokens"], replica=rep)
        g = r.gauge("fused_recompute_tokens", "Context tokens recomputed in fused launches", ("replica",))
        g.set(fs["recompute_tokens"], replica=rep)

        fls = engine.fault_stats()
        for k in ("fetch_failures", "fetch_retries", "degraded_requests",
                  "fetch_wasted_s", "fetch_wasted_bytes"):
            g = r.gauge(f"fault_{k}", "Failure-handling audit", ("replica",))
            g.set(fls[k], replica=rep)

        ss = engine.store.stats()
        for k in ("entries", "evictions", "rejected_puts", "migration_evals",
                  "migration_skips", "migration_queue", "content_chunks",
                  "failed_puts", "discards"):
            g = r.gauge(f"store_{k}", "Tiered store audit", ("replica",))
            g.set(ss[k], replica=rep)
        tg = r.gauge("tier_used_gb", "Resident GB per tier", ("replica", "tier"))
        hg = r.gauge("tier_gb_hours", "Accrued GB-hours per tier", ("replica", "tier"))
        for name, t in ss["tiers"].items():
            tg.set(t["used_gb"], replica=rep, tier=name)
            hg.set(t["gb_hours"], replica=rep, tier=name)

        self.settle_engine(engine, replica=replica)

    def collect_cluster(self, cluster) -> None:
        for i, eng in enumerate(cluster.replicas):
            self.collect_engine(eng, replica=i)
        r = self.registry
        g = r.gauge("cluster_gossip_ticks", "Digest gossip rounds run")
        g.set(cluster.gossip_ticks)
        g = r.gauge("cluster_rebalances", "Copy-then-keep rebalance copies")
        g.set(cluster.rebalances)
        rs = getattr(cluster.router, "stats", None)
        if callable(rs):
            for k, v in rs().items():
                g = r.gauge(f"router_{k}", "Router decision audit")
                g.set(v)
        if cluster.core is not None:
            cs = cluster.core.stats()
            g = r.gauge(
                "shared_tier_dedup_hits",
                "Write-backs deduped by the shared content-addressed core",
            )
            g.set(cs["dedup_hits"])
            g = r.gauge("shared_tier_contents", "Distinct shared payloads")
            g.set(cs["n_contents"])

    # ------------------------------------------------------------------ #
    # Views
    # ------------------------------------------------------------------ #
    def spans(self) -> List[Span]:
        """Span trees over everything observed so far (cluster-aware: the
        buffer is replica-tagged)."""
        return build_cluster_spans(self.events)

    def engine_spans(self, *, replica: int = 0) -> List[Span]:
        return build_spans(
            [e for rep, e in self.events if rep == replica], replica=replica
        )

    def check(self, summary, *, replica: Optional[int] = None,
              atol: float = 1e-9) -> Dict[str, float]:
        """Conservation law against a ServingSummary (see ledger module)."""
        return check_conservation(
            self.ledger, summary, replica=replica, atol=atol
        )

    def check_cluster(self, summary, *, atol: float = 1e-9) -> Dict[int, Dict[str, float]]:
        """Conservation per replica against a ``ClusterSummary`` (each
        replica's ledger slice vs its own ServingSummary)."""
        return {
            i: self.check(s, replica=i, atol=atol)
            for i, s in enumerate(summary.replicas)
        }

    def snapshot(self) -> dict:
        """JSON-ready dump: metrics + ledger aggregations."""
        return {
            "metrics": self.registry.snapshot(),
            "ledger": self.ledger.as_dict(),
        }
