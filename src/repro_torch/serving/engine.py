"""Continuous-batching serving engine, structured as plan -> execute.

The paper's pipeline, end to end: on admission a request's context is looked
up in the ``TieredStore`` (chain-hash prefix match); a ``ReusePlanner`` turns
(request, lookup, workload) into a declarative ``ReusePlan`` (recompute /
load / partial-load, plus write-back); the engine executes it — storage
fetch through the tier's backend, one packed suffix-prefill of every
admitted request's unmatched context tail and prompt, break-even-gated
write-back — and decode runs batched across slots, one step at a time, over
the slotted dense cache or, with ``paged_decode``, over one shared KV block
pool that the packed admissions land in block-aligned.

The engine is step-driven: ``submit()`` enqueues, ``step()`` performs one
scheduling step (admit a batch of requests, or one batched decode step, or a
clock jump to the next arrival) and returns the typed ``events`` it
produced; ``drain()`` iterates steps to completion; ``run()`` drains and
summarizes.

With ``paged_decode`` and ``unified_step`` a step is instead one launch over
the block pool that mixes every active slot's decode token with kv_block-wide
prefill chunks of pending admissions (``_step_unified``): admission never
stalls the slots that are decoding.

With ``fusion_enabled`` (and a ``BlendPlanner``) a context whose stored
chunks match out of order is admitted ``"fused"`` (CacheBlend-style): the
matched chunks' KV is fetched from every source entry, assembled in query
order with delta-RoPE, and only a recompute fraction of it, with the
unmatched tokens and the prompt, runs through one selective-recompute launch
(``_execute_fused``); under the unified step those tokens land as chunks
instead.  A source that cannot be fetched degrades the admission to exact
recompute.

With ``compress_tier`` the store keeps that tier's entries as int8 rows and
f32 scales: a write-back into it is quantised where the rows lie (on the
card, by ``kv_quant``), and a fetch from it dequantises on the engine's
device (``kv_dequant``) before any admission mode consumes the rows.

Archs that cannot be packed (the SSM family: its state mixes along the
sequence) are admitted one request per step through ``ModelApi.prefill``
(``_admit_single``): a load inserts the stored state snapshot and prefills
the prompt after it; a recompute that writes back prefills the context
alone, stores the state, then prefills the prompt on the same state.  For
them ``paged_decode``, ``unified_step`` and ``fusion_enabled`` stay off, as
in the reference, and decode is the dense slotted step.

Failure handling and latency hiding: with ``faults`` every storage backend
consults a seeded ``FaultInjector`` (transient failures, in-flight
corruption, brownouts); a failed fetch retries under ``retry_policy`` and,
once retrying stops paying, the admission degrades to exact recompute.  A
lookup plans around browned-out tiers.  ``hedge`` hedges reads from remote
tiers, ``overlap_load`` charges only the part of a fetch the prefill does
not hide, ``prefetch_lookahead`` starts the fetches of queued requests
(their entries pinned until admission) and ``migration_interval_s`` runs the
break-even migration pass on the clock, idle gaps included.

``load()`` and ``free_capacity()`` are what a cluster's router reads of a
replica (``serving/cluster.py``).

``telemetry=`` (an ``obs.Telemetry``, off by default) sees every step's
events and every charged fee, each fee attributed to the request and
activity (fetch, retried fetch, write-back) that caused it, and settles the
store's GB-hours at each ``summary()``: host-side only, it launches nothing.

``market=`` (a ``market.MarketSession``, off by default) publishes the
store as the tenant's catalog and lets a ``MarketPlanner`` buy a context's
KV from a peer: a bought plan's fetch is the marketplace's delivery,
verification and settlement (``_market_fetch``), checked against a fresh
prefill of a prefix sample (``market_spot_check``), and a full-entry
purchase is absorbed into the local store.

This is the port of the JAX engine under every ``EngineConfig`` option.
It serves the dense archs (``llama-7b``, ``qwen2-1.5b``, ``qwen2-0.5b``,
``mistral-nemo-12b``) and the MoE arch ``olmoe-1b-7b`` through every
admission and decode path, and the SSM arch ``mamba2-1.3b`` through the
per-request path.  Compute runs eagerly in PyTorch (no jit): on CUDA tensors the kernels are
the hand-written ones, on CPU tensors their plain versions.  Times and
dollars are modelled (``PerfModel``), as in the reference, so the
reference's golden records replay on the port.  Embedding contexts raise
``NotImplementedError`` naming the ROADMAP item that will carry them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import Workload, s_storage_bytes
from repro_torch.core.perf_model import PerfModel, h100
from repro_torch.core.pricing import Pricing, h100_pricing
from repro_torch.kvcache import compression, fusion, paged
from repro_torch.kvcache.backend import StorageBackend
from repro_torch.kvcache.faults import FaultInjector, RetryPolicy, StorageError
from repro_torch.kvcache.hierarchy import (
    BreakEvenMigrator,
    TieredStore,
    TierSpec,
    build_backends,
)
from repro_torch.kvcache.transfer import SimClock, TransferModel
from repro_torch.models import registry
from repro_torch.models.common import resolve_device
from repro_torch.serving import events as ev
from repro_torch.serving import metrics as metrics_mod
from repro_torch.serving.jit_cache import JitBucketStats
from repro_torch.serving.planner import (
    CostAwarePlanner,
    ReusePlan,
    ReusePlanner,
    StoreLookup,
)
from repro_torch.serving.request import Request, RequestRecord, Slot
from repro_torch.serving.scheduler import AdmissionQueue, HedgePolicy

# The market's spot check, per model dtype: a purchased state passes when,
# for every leaf, max|bought - fresh| <= tol * max(1, max|fresh|), with
# ``fresh`` a prefill of the same prefix sample on this engine.  A tolerance,
# not bitwise equality: the seller's rows come out of a packed admission (or
# the unified step's chunks) and the check's out of a per-request prefill,
# whose launches and matmul shapes differ, so their roundings do (ROADMAP C9).
# f32: the North star's attention rule; honest purchases of the reduced
# llama-7b read ~4e-7 in the reference on the CPU, and 0 (packed seller) and
# 7.2e-7 (unified seller) in the port on the H100.  bf16, full llama-7b on the
# H100 (``chip_smoke.py``'s market phase, PERF.md): the largest honest
# reading over the prefix mix's contexts and C, from packed and unified
# sellers, is 0.0202; each bf16 side alone reads 0.016-0.017 against an f32
# prefill, so the honest reading is two bf16 roundings through 32 layers.
# The least control, another context's rows under these tokens, is 1.343.
# 0.1 sits 5x above the one and 13x below the other.
SPOT_CHECK_TOL = {"float32": 2e-5, "bfloat16": 1e-1}


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine options."""

    max_slots: int = 4
    max_len: int = 512
    chunk_tokens: int = 16
    reuse_enabled: bool = True
    tier_capacities_gb: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"host_dram": 64.0, "io2": 1024.0}
    )
    # Full hierarchy declaration (fastest first); overrides tier_capacities_gb
    # and enables per-tier backend kinds + link concurrency limits.
    tier_specs: Optional[List[TierSpec]] = None
    # Tier write-backs land in (default: the last/cheapest tier).
    store_tier: Optional[str] = None
    # >0 runs the clock-driven break-even migration pass at this cadence;
    # migrations surface as TierMigrated events.
    migration_interval_s: float = 0.0
    migration_policy: Optional[BreakEvenMigrator] = None
    # Under capacity pressure, demote the least valuable entry one tier down
    # instead of deleting it outright.
    spill_on_pressure: bool = False
    compress_tier: Optional[str] = None
    # charge only the part of a fetch that the admission's prefill does not
    # hide (the load streams while the model computes)
    overlap_load: bool = False
    # hedged reads from the tiers whose backends can hedge (remote ones)
    hedge: Optional[HedgePolicy] = None
    eviction: str = "cost"
    store_write_back: bool = True
    # Economics-at-scale: model times/costs as if serving this FULL arch while
    # the actual compute uses a reduced config.  None = the served config.
    cost_arch: Optional[str] = None
    # Lookahead prefetch: on admission, start fetching the stored contexts
    # of up to this many queued requests that have arrived, so only the
    # unfinished remainder of their fetch shows up in their TTFT.
    prefetch_lookahead: int = 0
    # Max requests admitted per step as one packed ragged prefill (None =
    # every admissible request with a free slot).
    admit_batch: Optional[int] = None
    # Each segment's kv span starts at a multiple of this, so a kernel kv
    # tile never mixes two requests.
    pack_align: int = 128
    # Smallest bucket for the packed q length (lengths round up to the next
    # power of two, so steady traffic reuses a small set of launch shapes).
    pack_bucket_min: int = 16
    paged_decode: bool = False
    kv_block: int = 128
    fusion_enabled: bool = False
    unified_step: bool = False
    step_token_budget: int = 160
    # Seeded fault injection: every storage backend consults it for
    # transient failures, brownouts and corruption.  None = no injection
    # (the put/get checksums are verified either way).
    faults: Optional[FaultInjector] = None
    # Cost-aware retry applied when a planned fetch fails.  None =
    # RetryPolicy() defaults.
    retry_policy: Optional[RetryPolicy] = None
    # Contexts shorter than this many tokens are never written back.
    min_cache_tokens: int = 0


@dataclasses.dataclass
class _Admission:
    """One request's admission in flight: plan phase fills the first five
    fields, packed execution the rest."""

    req: Request
    rec: RequestRecord
    slot: Slot
    plan: ReusePlan
    lookup: StoreLookup
    artifact: Any = None  # fetched stored state (None = recompute)
    delay: float = 0.0  # raw storage fetch delay
    load_s: float = 0.0  # delay charged to this request (post-overlap)
    nbytes: float = 0.0
    matched: int = 0
    new_tokens: List[int] = dataclasses.field(default_factory=list)
    # fused admissions: source entries pinned between plan and execute (a
    # batch-mate's write-back pressure must not evict a fusion source)
    pins: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _ChunkStream:
    """One admission's pending suffix-prefill under the unified step: the
    query tokens still to land (context tail + prompt; for fused plans the
    recompute spans + prompt) with each token's absolute position.  The
    slot's pool blocks are admitted up front; chunks of up to kv_block
    tokens land per unified launch until the stream drains, when the first
    generated token is emitted and the slot starts decoding."""

    a: _Admission
    tokens: np.ndarray  # int32 [n_q] query tokens still to prefill
    positions: np.ndarray  # int32 [n_q] absolute positions, increasing
    n_ctx: int  # context length (write-back row count)
    ready_s: float  # clock time the storage fetch completes
    store_after: bool = False  # write the context rows back on completion
    done: int = 0  # tokens already landed

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.done


class ServingEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        *,
        engine_cfg: Optional[EngineConfig] = None,
        planner: Optional[ReusePlanner] = None,
        backends: Optional[Dict[str, StorageBackend]] = None,
        pricing: Optional[Pricing] = None,
        perf: Optional[PerfModel] = None,
        clock: Optional[SimClock] = None,
        transfer: Optional[TransferModel] = None,
        on_token=None,
        telemetry=None,
        telemetry_replica: int = 0,
        market=None,
        device=None,
    ):
        """``device`` is where the model runs: the card unless the caller
        asks for another (``device="cpu"``); with no CUDA and no device
        given, this raises.  ``params`` must already live there.
        ``telemetry`` (an ``obs.Telemetry``, off by default) observes the
        event stream and the transfer model's fees; ``telemetry_replica``
        tags this engine's events and ledger entries inside a cluster.
        ``market`` (a ``market.MarketSession``, off by default) is this
        engine's tenant on a marketplace."""
        self.cfg = cfg
        self.params = params
        self.ec = engine_cfg or EngineConfig()
        self.device = resolve_device(device)
        self.pricing = pricing or h100_pricing(1)
        self.perf = perf or PerfModel(h100(1))
        self.api = registry.get_model(cfg)
        # packed admission, paged decode, the unified step and fusion need
        # per-position attention state: other archs (SSM state, an
        # encoder-decoder) admit one request per step (``_admit_single``) and
        # keep dense decode, with those options quietly off, as in the
        # reference
        self._packable = paged.packable_arch(cfg, self.ec.max_len)
        if self.ec.cost_arch is not None:
            from repro_torch.configs import get_config

            self.cost_cfg = get_config(self.ec.cost_arch)
        else:
            self.cost_cfg = cfg

        self.clock = clock or SimClock()
        self.transfer = transfer or TransferModel(self.perf, self.pricing)
        # streaming per-token hook: called with every TokenEmitted event
        self.on_token = on_token
        # Telemetry is host-side only: it reads the events already built and
        # the fees already charged, so it launches nothing and cannot change
        # a token.  Off, each site pays one ``is None`` test.
        self.telemetry = telemetry
        self._replica = telemetry_replica
        if telemetry is not None:
            self.transfer.bind_ledger(telemetry.ledger, replica=telemetry_replica)
        self._c_gpu_s = self.pricing.compute.cost_per_hour / 3600.0
        if self.ec.tier_specs is not None:
            specs = list(self.ec.tier_specs)
        else:
            specs = [TierSpec(n, gb) for n, gb in self.ec.tier_capacities_gb.items()]
        self.backends = backends or build_backends(
            specs, transfer=self.transfer, clock=self.clock, hedge=self.ec.hedge,
            faults=self.ec.faults,
        )
        self.retry_policy = self.ec.retry_policy or RetryPolicy()
        migration = self.ec.migration_policy
        if migration is None and self.ec.migration_interval_s > 0:
            migration = BreakEvenMigrator(compute_cost_per_s=self._c_gpu_s)
        self.store = TieredStore(
            tiers=specs,
            transfer=self.transfer,
            clock=self.clock,
            chunk_tokens=self.ec.chunk_tokens,
            compress_tier=self.ec.compress_tier,
            eviction=self.ec.eviction,
            backends=self.backends,
            pricing=self.pricing,
            migration=migration,
            spill_on_pressure=self.ec.spill_on_pressure,
            device=self.device,
        )
        self.planner: ReusePlanner = planner or CostAwarePlanner()
        self.planner.configure(
            cost_cfg=self.cost_cfg,
            pricing=self.pricing,
            perf=self.perf,
            write_back=self.ec.reuse_enabled and self.ec.store_write_back,
            min_store_tokens=max(self.ec.chunk_tokens, self.ec.min_cache_tokens),
        )
        # Marketplace session, duck-typed so the engine never imports the
        # market package.  Binding publishes this engine's store as the
        # tenant's catalog and hands the market the spot check
        # (``market_spot_check``).  None = no market: every plan and token
        # is what it was without one.
        self.market = market
        if market is not None:
            market.bind_engine(self)
            # a MarketPlanner built without a session shops through this
            # engine's (only planners that can buy have the attribute)
            if getattr(self.planner, "session", "no") is None:
                self.planner.session = market
        self.queue = AdmissionQueue()
        self.slots = [Slot(i) for i in range(self.ec.max_slots)]
        self.records: List[RequestRecord] = []
        # req_id -> clock time its context prefetch completes
        self._prefetch_ready: Dict[int, float] = {}
        # req_id -> entry pinned on its behalf (prefetch/eviction race guard)
        self._prefetch_pins: Dict[int, str] = {}
        # req_id -> (PrefixMatch, entry_id, trie_version): the prefetch pass's
        # trie walk, carried forward to admission so the same context is not
        # walked twice; invalidated by any trie mutation (version bump)
        self._prefetch_lookup: Dict[int, tuple] = {}
        self._next_migration_s = self.ec.migration_interval_s
        # Paged batched decode over the shared KV block pool: packed spans
        # land block-aligned in the pool, and the pool IS the device KV
        # state (no dense slotted cache beside it).
        self._paged_on = self.ec.paged_decode and self._packable
        self._paged: Optional[paged.PagedSlots] = None
        self._state = None
        if self._paged_on:
            if self.ec.kv_block != self.ec.pack_align:
                raise ValueError(
                    "paged_decode needs kv_block == pack_align, so packed spans "
                    f"land block-aligned in the pool (got {self.ec.kv_block}, "
                    f"{self.ec.pack_align})"
                )
            if self.ec.max_len % self.ec.kv_block:
                raise ValueError(
                    f"paged_decode needs max_len ({self.ec.max_len}) to be a "
                    f"multiple of kv_block ({self.ec.kv_block})"
                )
            self._paged = paged.PagedSlots(
                self.ec.max_slots, self.ec.max_len, self.ec.kv_block
            )
            self._pool_caches = paged.init_pool_caches(
                cfg, self._paged.pool.n_blocks, self.ec.kv_block, device=self.device
            )
        else:
            self._state = self.api.init_state(
                cfg, self.ec.max_slots, self.ec.max_len, device=self.device
            )
        # Unified continuous-batching step: chunked prefill interleaved with
        # decode in one launch over the block pool (the reference's rule:
        # without paged decode the option leaves the legacy loop in place).
        self._unified_on = self.ec.unified_step and self._paged_on
        # slot index -> in-flight prefill stream (unified mode only)
        self._chunks: Dict[int, _ChunkStream] = {}
        # context-token tuples an unfinished chunk stream will write back:
        # the unified analogue of the packed batch's write-back dedup
        self._wb_inflight: Dict[tuple, int] = {}
        self.unified_jit = JitBucketStats()
        self.unified_steps = 0  # mixed (chunk-carrying) launches
        self.unified_chunk_tokens = 0  # prefill tokens landed through chunks
        self.unified_busy_s = 0.0  # modelled time in mixed launches
        # Fused non-prefix reuse (CacheBlend-style): chunk-composite lookups
        # and the selective-recompute launch (packable archs only)
        self._fusion_on = self.ec.fusion_enabled and self.ec.reuse_enabled and self._packable
        self.fused_jit = JitBucketStats()
        self.fused_admissions = 0
        self.fused_reused_tokens = 0
        self.fused_recompute_tokens = 0
        self.fused_sources = 0
        self.fused_busy_s = 0.0
        # packed-admission observability: launch-shape buckets (the same
        # (q_len, kv_len) keys as the reference's jit cache counters)
        self.jit_stats = JitBucketStats()
        self.batches = 0
        self.packed_q_tokens = 0  # useful tokens through the packed kernel
        self.packed_q_len = 0  # padded (bucketed) tokens launched
        self.lookup_walks = 0  # real trie walks
        self.lookup_reuses = 0  # admissions served from the prefetch walk
        self.admission_busy_s = 0.0  # modeled time spent in load+prefill
        self.decode_busy_s = 0.0  # modeled time spent in decode steps
        self.decode_tokens = 0  # tokens emitted by decode steps
        self.decode_steps = 0  # batched decode launches
        # failure handling (fault injection, retry, degrade)
        self.fetch_failures = 0  # failed fetch attempts (every attempt)
        self.fetch_retries = 0  # attempts the retry policy re-issued
        self.degraded_requests = 0  # admissions that fell back to recompute
        self.fetch_wasted_s = 0.0  # time burned by failed attempts + backoff
        self.fetch_wasted_bytes = 0.0  # transfer bytes charged but unusable
        # marketplace (all stay 0 without a market)
        self.market_purchases = 0  # plans served with bought peer KV
        self.market_failed = 0  # purchases that degraded to recompute
        self.market_spend = 0.0  # buyer dollars settled through the market

    # ------------------------------------------------------------------ #
    # Public API: submit / step / drain / run
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        self.queue.push(req)

    @property
    def idle(self) -> bool:
        """Nothing queued, nothing decoding, no prefill chunks in flight."""
        return (
            len(self.queue) == 0
            and not any(s.active for s in self.slots)
            and not self._chunks
        )

    def load(self) -> int:
        """Requests this replica currently owes work to (queued + in a slot,
        including slots mid-chunked-prefill) — the router's load signal."""
        return (
            len(self.queue)
            + sum(1 for s in self.slots if s.active)
            + len(self._chunks)
        )

    def free_capacity(self) -> int:
        """Slots not yet spoken for by queued or active requests (floor 0)."""
        return max(0, self.ec.max_slots - self.load())

    def step(self) -> List[ev.Event]:
        """Advance the engine by one scheduling step and return its events:
        admit every admissible request with a free slot as one packed batch
        (one ragged suffix-prefill launch per layer), else run one batched
        decode step, else jump the clock to the next arrival.  Under the
        unified step, one mixed launch instead (``_step_unified``).  A due
        migration pass (``migration_interval_s``) runs at the top of the step
        and surfaces as TierMigrated events."""
        events = self._step()
        if self.telemetry is not None and events:
            self.telemetry.on_events(events, replica=self._replica)
        return events

    def _step(self) -> List[ev.Event]:
        if self._unified_on:
            return self._step_unified()
        events: List[ev.Event] = []
        self._run_migrations(events)
        if self._admit_batch(events):
            return events
        if any(s.active for s in self.slots):
            self._decode_step(events)
            return events
        nxt = self.queue.next_arrival()
        if nxt is not None:
            self._advance_clock(nxt, events)
        return events

    def _advance_clock(self, to_s: float, events: List[ev.Event]) -> None:
        """Jump the idle clock to ``to_s``, stepping through every migration
        pass whose scheduled time falls inside the gap: each missed pass runs
        at its own due time, so an idle gap accrues storage dollars and
        demotes cold entries on schedule instead of in one late pass."""
        if self.ec.migration_interval_s > 0 and self.store.migration is not None:
            while self._next_migration_s <= to_s:
                at = self._next_migration_s
                self.clock.at_least(at)
                self.store.run_migrations()
                self._next_migration_s = at + self.ec.migration_interval_s
                self._emit_migrations(events)
        self.clock.at_least(to_s)
        events.append(ev.ClockAdvanced(t_s=self.clock.now, req_id=-1, to_s=to_s))

    def drain(self) -> Iterator[ev.Event]:
        """Iterate events until every submitted request has finished."""
        while not self.idle:
            yield from self.step()

    def run(self) -> metrics_mod.ServingSummary:
        """Serve everything submitted; returns the summary."""
        for _ in self.drain():
            pass
        return self.summary()

    def summary(self) -> metrics_mod.ServingSummary:
        if self.telemetry is not None:
            # settle the accrued GB-hours into the ledger at the instant the
            # summary reads them, so the conservation check is exact
            self.telemetry.settle_engine(self, replica=self._replica)
        return metrics_mod.summarize(
            self.records,
            storage_cost=self.store.storage_cost(self.pricing),
            transfer_cost=self.transfer.transfer_fees(),
        )

    def _attr(self, activity: str, req_id: Optional[int] = None):
        """Attribution scope for the transfer fees charged inside; a
        nullcontext when telemetry is off."""
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.transfer.attributed(activity=activity, req_id=req_id)

    def _run_migrations(self, events: List[ev.Event]) -> None:
        """The clock-driven migration pass, when one is due."""
        if (
            self.ec.migration_interval_s <= 0
            or self.store.migration is None
            or self.clock.now < self._next_migration_s
        ):
            return
        self.store.run_migrations()
        self._next_migration_s = self.clock.now + self.ec.migration_interval_s
        self._emit_migrations(events)

    def packed_stats(self) -> Dict[str, Any]:
        """Packed-admission counters: launch-shape bucket hits and misses,
        packing occupancy, trie walks (and the walks the prefetch pass saved)
        and modeled admission busy time."""
        return {
            "jit": self.jit_stats.as_dict(),
            "batches": self.batches,
            "packed_q_tokens": self.packed_q_tokens,
            "packed_q_len": self.packed_q_len,
            "occupancy": self.packed_q_tokens / max(self.packed_q_len, 1),
            "lookup_walks": self.lookup_walks,
            "lookup_reuses": self.lookup_reuses,
            "admission_busy_s": self.admission_busy_s,
        }

    def decode_stats(self) -> Dict[str, Any]:
        """Decode-side counters: steps, tokens and modeled busy time, and
        under paged decode the block pool's occupancy and the blocks shared
        across batch-mates."""
        out: Dict[str, Any] = {
            "paged": self._paged_on,
            "decode_steps": self.decode_steps,
            "decode_busy_s": self.decode_busy_s,
            "decode_tokens": self.decode_tokens,
        }
        if self._paged_on:
            ps = self._paged.stats()
            out.update(kv_block=ps.pop("block"), **ps)
        return out

    def fused_stats(self) -> Dict[str, Any]:
        """Fusion-path counters: fused admissions, reused-vs-recomputed
        context tokens (the realized CacheBlend ratio), distinct source
        entries fetched, modelled fused busy time, and the fused launch's
        own shape-bucket hit/miss split."""
        return {
            "enabled": self._fusion_on,
            "admissions": self.fused_admissions,
            "reused_tokens": self.fused_reused_tokens,
            "recompute_tokens": self.fused_recompute_tokens,
            "sources": self.fused_sources,
            "busy_s": self.fused_busy_s,
            "jit": self.fused_jit.as_dict(),
        }

    def fault_stats(self) -> Dict[str, Any]:
        """Failure-handling counters: failed and retried fetch attempts,
        requests degraded to recompute, burned fetch time and bytes, the
        store's rolled-back puts and discarded entries, and the injector's
        own tally when one is wired."""
        out = {
            "fetch_failures": self.fetch_failures,
            "fetch_retries": self.fetch_retries,
            "degraded_requests": self.degraded_requests,
            "fetch_wasted_s": self.fetch_wasted_s,
            "fetch_wasted_bytes": self.fetch_wasted_bytes,
            "failed_puts": self.store.failed_puts,
            "discards": self.store.discards,
        }
        if self.ec.faults is not None:
            out["injector"] = self.ec.faults.stats()
        return out

    # ------------------------------------------------------------------ #
    # Admission: pop -> plan (per request) -> execute (one packed batch)
    # ------------------------------------------------------------------ #
    def _admit_batch(self, events: List[ev.Event]) -> bool:
        """Admit every admissible request with a free slot (up to
        ``admit_batch``): plan each individually, then execute all their
        suffix-prefills as ONE packed ragged launch, and each fused plan as
        its own selective-recompute launch.  A request the packed path
        cannot carry (an arch that cannot be packed, or embeds) takes the
        per-request path instead, one per step: one at the head of the queue
        is admitted alone, one behind packable requests waits a step."""
        free = [s for s in self.slots if not s.active]
        if not free:
            return False
        limit = min(len(free), self.ec.admit_batch or self.ec.max_slots)
        reqs: List[Request] = []
        while len(reqs) < limit:
            nxt = self.queue.peek_next(self.clock.now)
            if nxt is None:
                break
            if not (self._packable and nxt.embeds is None):
                if reqs:
                    break
                return self._admit_single(self.queue.pop_admissible(self.clock.now),
                                          free[0], events)
            reqs.append(self.queue.pop_admissible(self.clock.now))
        if not reqs:
            return False

        # Plan sequentially, carrying each planned fetch's bytes forward so
        # batch-mate i's predicted queue wait sees mates 0..i-1 on the same
        # contended link.
        pending: Dict[str, List[float]] = {}
        admissions: List[_Admission] = []
        for req, slot in zip(reqs, free):
            a = self._plan_admission(req, slot, events, pending=pending)
            admissions.append(a)
            self._note_pending(a, pending)
        packed = [a for a in admissions if a.plan.action != "fused"]
        if packed:
            self._execute_packed(packed, events)
        for a in admissions:
            if a.plan.action == "fused":
                self._execute_fused(a, events)
        self._issue_prefetches()
        return True

    def _note_pending(self, a: _Admission, pending: Dict[str, List[float]]) -> None:
        """Carry a planned admission's fetches into ``pending`` for the
        batch-mates planned after it.  A fused plan first pins its sources:
        a batch-mate's write-back could otherwise evict one before the fused
        fetch executes; its fetches hit their tiers' links at the shared
        admission instant too."""
        if a.plan.action == "fused":
            for eid in a.plan.fused.source_entries:
                if eid in self.store.entries:
                    self.store.pin(eid)
                    a.pins.append(eid)
            for tier, b in a.lookup.fused_bytes_by_tier.items():
                pending.setdefault(tier, []).append(b)
        if a.plan.loads_kv and a.lookup.entry is not None:
            pending.setdefault(a.lookup.entry.tier, []).append(
                self._entry_fetch_bytes(a.lookup.entry, a.plan.matched_tokens)
            )

    def _plan_admission(
        self,
        req: Request,
        slot: Slot,
        events: List[ev.Event],
        pending: Optional[Dict[str, List[float]]] = None,
    ) -> _Admission:
        rec = RequestRecord(
            req_id=req.req_id,
            arrival_s=req.arrival_s,
            context_len=len(req.context_tokens),
            prompt_len=len(req.prompt_tokens),
            start_s=self.clock.now,
        )
        total_len = len(req.context_tokens) + len(req.prompt_tokens) + req.max_new_tokens
        if total_len > self.ec.max_len:
            raise ValueError(
                f"request {req.req_id} needs {total_len} tokens > max_len {self.ec.max_len}"
            )
        events.append(
            ev.RequestAdmitted(
                t_s=self.clock.now, req_id=req.req_id, slot=slot.index,
                queue_s=rec.queue_s,
            )
        )
        lookup = self._lookup(req, pending)
        workload = Workload(
            L_context=len(req.context_tokens),
            L_prompt=len(req.prompt_tokens),
            L_output=req.max_new_tokens,
            N=max(int(req.expected_reuses), 1),
            slo_ttft_s=req.slo_ttft_s,
        )
        plan = self.planner.plan(req, lookup, workload)
        events.append(ev.PlanChosen(t_s=self.clock.now, req_id=req.req_id, plan=plan))
        return _Admission(req=req, rec=rec, slot=slot, plan=plan, lookup=lookup)

    def _finish_admission(self, a: _Admission, first_tok: int, events: List[ev.Event]) -> None:
        """Admission epilogue (post clock-advance): record the action, emit
        the first token, activate the slot."""
        a.rec.action = (
            a.plan.action if (a.plan.reuses_kv and not a.rec.degraded) else "recompute"
        )
        a.rec.plan = a.plan
        a.rec.tokens.append(first_tok)
        tok_ev = ev.TokenEmitted(
            t_s=self.clock.now, req_id=a.req.req_id, token=first_tok, index=0
        )
        events.append(tok_ev)
        if self.on_token is not None:
            self.on_token(tok_ev)
        a.slot.request = a.req
        a.slot.record = a.rec
        a.slot.generated = 1
        a.slot.last_token = first_tok
        a.slot.active = True
        self._maybe_finish(a.slot, events)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill(self, tokens: List[int], state, embeds=None):
        """``ModelApi.prefill`` of one request's ``tokens`` after the state's
        cached positions (written in place), with its ``embeds`` context
        where given; returns (logits, state)."""
        with torch.inference_mode():
            return self.api.prefill(self.params, self.cfg,
                                    self._tensor(np.asarray([tokens], np.int32)), state,
                                    embeds=embeds)

    # -- per-request execution (archs that cannot be packed, embeds) ---- #
    def _admit_single(self, req: Request, slot: Slot, events: List[ev.Event]) -> bool:
        """Plan, fetch and prefill one request through ``ModelApi.prefill``
        into a batch-1 state, then install it in ``slot`` (under paged
        decode, in newly admitted pool blocks)."""
        a = self._plan_admission(req, slot, events)
        if a.plan.market is not None:
            self._market_fetch(a, events)
        elif a.plan.loads_kv and a.lookup.entry is not None:
            self._fetch_kv_resilient(a, events)
        if a.artifact is not None:
            load_s, prefill_s, logits, temp = self._execute_load(req, a, events)
            matched = a.matched
        else:
            # plain recompute, or a degraded fetch falling back to exact
            # recompute mid-admission: the burned fetch time rides on load_s
            # (a.delay is 0.0 on the plain path)
            load_s, matched = a.delay, 0
            prefill_s, logits, temp = self._execute_recompute(
                req, events, store_after=a.plan.store_after)
        self._release_prefetch(req.req_id)
        if self._paged_on:
            self._land_state_in_pool(slot, temp)
        else:
            paged.insert_slot(self.cfg, self._state, slot.index, temp)
        first_tok = int(logits[0].argmax())
        self.clock.advance(load_s + prefill_s)
        self.admission_busy_s += load_s + prefill_s
        a.rec.matched_tokens = matched
        a.rec.load_s = load_s
        a.rec.prefill_s = prefill_s
        a.rec.compute_cost += self._c_gpu_s * prefill_s
        self._finish_admission(a, first_tok, events)
        self._issue_prefetches()
        return True

    def _execute_load(self, req: Request, a: _Admission, events: List[ev.Event]):
        """Insert the fetched stored context state into a fresh batch-1 state
        and prefill only the unmatched tail and the prompt after it (for SSM
        state, all or nothing, the tail is empty; an embeds context is
        stored whole, so its tail is empty too).  Returns (load_s,
        prefill_s, logits, state)."""
        matched = a.matched
        temp = self.api.init_state(self.cfg, 1, self.ec.max_len, device=self.device)
        paged.insert_slot(self.cfg, temp, 0, a.artifact, n_tokens=matched)
        tail = [] if req.embeds is not None else list(req.context_tokens)[matched:]
        tokens = tail + list(req.prompt_tokens)
        logits, temp = self._prefill(tokens, temp)
        prefill_s = self.perf.t_prefill(self.cost_cfg, len(tokens))
        load_s = self._overlapped(a.delay, prefill_s)
        events.append(ev.KVLoaded(
            t_s=self.clock.now, req_id=req.req_id, tier=self._loaded_tier(a),
            nbytes=a.nbytes, load_s=load_s, matched_tokens=matched,
        ))
        events.append(ev.PrefillDone(
            t_s=self.clock.now, req_id=req.req_id, n_tokens=len(tokens), prefill_s=prefill_s,
        ))
        return load_s, prefill_s, logits, temp

    @staticmethod
    def _loaded_tier(a: _Admission) -> str:
        """The tier a ``KVLoaded`` names: the local entry's, else (a bought
        plan with no local match) the plan's ``market:<seller>``."""
        if a.lookup.entry is not None:
            return a.lookup.entry.tier
        return a.plan.tier or "market"

    def _overlapped(self, delay: float, prefill_s: float) -> float:
        """The part of a fetch's delay charged to the request: all of it, or
        under ``overlap_load`` only what the prefill does not hide."""
        return max(0.0, delay - prefill_s) if self.ec.overlap_load else delay

    def _execute_packed(self, admissions: List[_Admission], events: List[ev.Event]) -> None:
        """Execute an admission batch as one packed ragged suffix-prefill:
        per-request storage fetches (queueing on contended links is modeled
        at the shared admission instant), one launch per layer over the
        concatenated token runs, outputs scattered back into each request's
        batch slot."""
        t0 = self.clock.now
        for a in admissions:
            if a.plan.market is not None:
                self._market_fetch(a, events)
            elif a.plan.loads_kv and a.lookup.entry is not None:
                self._fetch_kv_resilient(a, events)
            self._release_prefetch(a.req.req_id)
            ctx = list(a.req.context_tokens)
            a.new_tokens = ctx[a.matched:] + list(a.req.prompt_tokens)

        layout = paged.pack_layout(
            [a.slot.index for a in admissions],
            [a.matched for a in admissions],
            [len(a.new_tokens) for a in admissions],
            align=self.ec.pack_align,
            bucket_min=self.ec.pack_bucket_min,
        )
        arrays = paged.pack_arrays(layout, [a.new_tokens for a in admissions])
        caches = paged.build_packed_caches(
            self.cfg, layout, [a.artifact for a in admissions], self.device
        )
        last_idx = np.zeros((self.ec.max_slots,), np.int64)
        for i, seg in enumerate(layout.segments):
            last_idx[i] = seg.q_last
        jit_hit = self.jit_stats.record((layout.q_len, layout.kv_len))
        self.batches += 1
        self.packed_q_tokens += layout.q_tokens
        self.packed_q_len += layout.q_len
        events.append(
            ev.BatchAdmitted(
                t_s=t0, req_id=-1,
                req_ids=tuple(a.req.req_id for a in admissions),
                q_tokens=layout.q_tokens, q_len=layout.q_len,
                kv_len=layout.kv_len, jit_hit=jit_hit,
            )
        )

        with torch.inference_mode():
            logits, new_caches = self.api.prefill_packed(
                self.params, self.cfg, self._tensor(arrays["tokens"]), caches,
                q_pos=self._tensor(arrays["q_pos"]), q_seg=self._tensor(arrays["q_seg"]),
                q_rows=self._tensor(arrays["q_rows"]), kv_pos=self._tensor(arrays["kv_pos"]),
                kv_seg=self._tensor(arrays["kv_seg"]), last_idx=self._tensor(last_idx),
            )
        first = logits.argmax(dim=-1).tolist()

        lens = [len(a.new_tokens) for a in admissions]
        prefill_s = self.perf.t_prefill_packed(self.cost_cfg, lens)
        total_new = sum(lens)
        written = set()  # contexts written back within THIS batch (dedup:
        # several batch-mates recomputing the same context store it once)
        for a, seg in zip(admissions, layout.segments):
            if a.artifact is not None:
                a.load_s = self._overlapped(a.delay, prefill_s)
                # KVLoaded carries this request's own fetch remainder; the
                # batch-barrier wait it experiences lands on the record below
                events.append(
                    ev.KVLoaded(
                        t_s=t0, req_id=a.req.req_id, tier=self._loaded_tier(a),
                        nbytes=a.nbytes, load_s=a.load_s, matched_tokens=a.matched,
                    )
                )
            else:
                if a.rec.degraded:
                    # the burned fetch time still delays this request (and,
                    # through the batch barrier below, its batch-mates)
                    a.load_s = a.delay
                if a.plan.store_after and tuple(a.req.context_tokens) not in written:
                    written.add(tuple(a.req.context_tokens))
                    art = paged.packed_to_artifact(
                        self.cfg, new_caches, seg, len(a.req.context_tokens)
                    )
                    self._write_back(a.req, art, events)
            events.append(
                ev.PrefillDone(
                    t_s=t0, req_id=a.req.req_id,
                    n_tokens=len(a.new_tokens), prefill_s=prefill_s,
                )
            )

        batch_load = max((a.load_s for a in admissions), default=0.0)
        self.clock.advance(batch_load + prefill_s)
        self.admission_busy_s += batch_load + prefill_s

        if self._paged_on:
            # the packed outputs land straight in the shared block pool: one
            # scatter for the whole batch
            self._land_packed_in_pool(admissions, layout, new_caches)
        for i, (a, seg) in enumerate(zip(admissions, layout.segments)):
            if not self._paged_on:
                paged.insert_slot(
                    self.cfg, self._state, seg.slot,
                    paged.packed_to_artifact(self.cfg, new_caches, seg, seg.n_total),
                )
            a.rec.matched_tokens = a.matched
            # every batch member waits the load BARRIER (max of the batch's
            # fetches) before the shared launch
            a.rec.load_s = batch_load
            a.rec.prefill_s = prefill_s
            a.rec.compute_cost += self._c_gpu_s * prefill_s * (len(a.new_tokens) / total_new)
            self._finish_admission(a, int(first[i]), events)

    # -- fused (chunk-composite) execution ------------------------------- #
    def _execute_fused(self, a: _Admission, events: List[ev.Event]) -> None:
        """Execute a ``"fused"`` plan: fetch each source entry's matched rows
        (fetches issue concurrently — the request waits the slowest),
        assemble one query-ordered KV buffer on the device with the reused
        spans preloaded (K delta-RoPE'd to its target position), run ONE
        selective-recompute launch over just the recompute spans + prompt,
        and land the whole context+prompt state in the slot (block pool or
        dense).  At ``recompute_frac=1.0`` the launch is a full prefill of
        the sequence."""
        t0 = self.clock.now
        req, schedule = a.req, a.plan.fused
        ctx, prompt = list(req.context_tokens), list(req.prompt_tokens)

        out = self._fetch_fused_sources(a, events)
        if out is None:
            # one lost source spoils the composite: the whole admission
            # degrades to exact recompute (time already burned on earlier
            # sources rides along, on a.delay)
            self._degrade_fused(a, events)
            return
        sources, fetched = out

        layout = fusion.fused_layout(
            schedule, len(prompt), align=self.ec.pack_align, bucket_min=self.ec.pack_bucket_min,
        )
        caches = fusion.build_fused_caches(
            self.cfg, schedule, sources, layout.kv_len, self.device
        )
        arrays = fusion.fused_arrays(schedule, ctx, prompt, layout)
        jit_hit = self.fused_jit.record((layout.q_len, layout.kv_len))
        with torch.inference_mode():
            logits, new_caches = self.api.prefill_fused(
                self.params, self.cfg, self._tensor(arrays["tokens"]), caches,
                q_pos=self._tensor(arrays["q_pos"]), q_rows=self._tensor(arrays["q_rows"]),
                kv_pos=self._tensor(arrays["kv_pos"]),
                last_idx=self._tensor(arrays["last_idx"]),
            )
        first_tok = int(logits[0].argmax())

        prefill_s = self.perf.t_prefill_fused(self.cost_cfg, layout.total, layout.n_q)
        load_s = self._overlapped(max((d for _, _, d, _ in fetched), default=0.0), prefill_s)
        # like the prefix load, each KVLoaded carries the delay charged after
        # the overlap, not the raw link time
        charged = [(t, nb, self._overlapped(d, prefill_s), rows) for t, nb, d, rows in fetched]
        self._note_fused(a, t0, len(sources), charged, layout.q_len, layout.kv_len, jit_hit,
                         events)
        events.append(ev.PrefillDone(
            t_s=t0, req_id=req.req_id, n_tokens=layout.n_q, prefill_s=prefill_s,
        ))

        # land the assembled+recomputed state: rows [0, total) ARE the
        # context+prompt state in sequence order.  The artifact covers whole
        # kv_blocks (the pool landing copies whole blocks) while its pos
        # stays the true token count.
        seg = paged.PackSegment(
            slot=a.slot.index, kv_start=0, q_start=0, matched=schedule.reused_tokens,
            n_new=layout.n_q, n_total=layout.total,
        )
        n_rows = -(-layout.total // self.ec.kv_block) * self.ec.kv_block
        art = paged.packed_to_artifact(
            self.cfg, new_caches, seg, min(n_rows, layout.kv_len)
        )._replace(pos=np.full((1,), layout.total, np.int32))
        if self._paged_on:
            self._land_state_in_pool(a.slot, art)
        else:
            paged.insert_slot(self.cfg, self._state, a.slot.index, art)

        self.clock.advance(load_s + prefill_s)
        self.admission_busy_s += load_s + prefill_s
        self.fused_busy_s += load_s + prefill_s
        a.rec.matched_tokens = schedule.reused_tokens
        a.rec.load_s = load_s
        a.rec.prefill_s = prefill_s
        a.rec.compute_cost += self._c_gpu_s * prefill_s
        self._finish_admission(a, first_tok, events)

    def _note_fused(self, a: _Admission, t0: float, n_sources: int, fetched: List[tuple],
                    q_len: int, kv_len: int, jit_hit: bool, events: List[ev.Event]) -> None:
        """Emit a fused admission's KVLoaded per fetched source and its
        FusedAdmitted, and count it in ``fused_stats``."""
        req, schedule = a.req, a.plan.fused
        for tier, nbytes, delay, rows in fetched:
            events.append(ev.KVLoaded(
                t_s=t0, req_id=req.req_id, tier=tier, nbytes=nbytes, load_s=delay,
                matched_tokens=rows,
            ))
        events.append(ev.FusedAdmitted(
            t_s=t0, req_id=req.req_id, slot=a.slot.index,
            reused_tokens=schedule.reused_tokens,
            recompute_tokens=schedule.recompute_tokens,
            n_spans=len(schedule.spans), n_sources=n_sources,
            q_len=q_len, kv_len=kv_len, jit_hit=jit_hit,
        ))
        self.fused_admissions += 1
        self.fused_reused_tokens += schedule.reused_tokens
        self.fused_recompute_tokens += schedule.recompute_tokens
        self.fused_sources += n_sources

    def _fetch_fused_sources(self, a: _Admission, events: List[ev.Event]):
        """Fetch every fused source entry's matched rows (pinned at plan
        time) under the retry policy.  On success returns ``(sources,
        fetched)`` — ``sources[entry_id]`` the artifact, ``fetched`` one
        (tier, nbytes, delay_s, rows) tuple per source — with the pins and
        the prefetch released.  On exhaustion of any source, degrades the
        admission in place (record marked, DegradedToRecompute emitted, the
        burned time left on ``a.delay``) and returns None: the caller falls
        back to exact recompute."""
        req, schedule = a.req, a.plan.fused
        sources: Dict[str, Any] = {}
        fetched: List[tuple] = []  # (tier, nbytes, delay, rows) per source
        wasted_total = 0.0
        for eid, rows in schedule.rows_by_entry().items():
            e = self.store.entries[eid]  # pinned at plan time: must exist
            nbytes = self._entry_fetch_bytes(e, rows)
            override = nbytes if self.cost_cfg is not self.cfg else None

            def attempt(activity, eid=eid, e=e, rows=rows, override=override):
                with self._attr(activity, req.req_id):
                    return self.store.fetch(eid, fraction=rows / max(e.n_tokens, 1),
                                            nbytes=override)

            out, wasted, attempts = self._retry_fetch(
                req, tier=e.tier, entry_id=eid, matched=rows, nbytes=nbytes,
                attempt_fn=attempt, events=events,
            )
            wasted_total += wasted
            if out is None:
                self._unpin(a)
                self._release_prefetch(req.req_id)
                self.degraded_requests += 1
                a.rec.degraded = True
                a.delay = wasted_total
                events.append(ev.DegradedToRecompute(
                    t_s=self.clock.now, req_id=req.req_id, tier=e.tier, entry_id=eid,
                    attempts=attempts, wasted_s=wasted_total, reason="fused_source_failed",
                ))
                return None
            art, delay = out
            sources[eid] = art
            fetched.append((e.tier, nbytes, wasted + delay, rows))
        self._unpin(a)
        self._release_prefetch(req.req_id)
        return sources, fetched

    def _unpin(self, a: _Admission) -> None:
        for eid in a.pins:
            self.store.unpin(eid)
        a.pins.clear()

    def _degrade_fused(self, a: _Admission, events: List[ev.Event]) -> None:
        """A fused source fetch exhausted its retries (record already marked
        by ``_fetch_fused_sources``, burned time on ``a.delay``): run the
        request as one exact full recompute (recompute is the ground truth
        the fusion approximates)."""
        req, wasted_s = a.req, a.delay
        prefill_s, logits, temp = self._execute_recompute(req, events)
        if self._paged_on:
            self._land_state_in_pool(a.slot, temp)
        else:
            paged.insert_slot(self.cfg, self._state, a.slot.index, temp)
        first_tok = int(logits[0].argmax())
        self.clock.advance(wasted_s + prefill_s)
        self.admission_busy_s += wasted_s + prefill_s
        a.rec.matched_tokens = 0
        a.rec.load_s = wasted_s
        a.rec.prefill_s = prefill_s
        a.rec.compute_cost += self._c_gpu_s * prefill_s
        self._finish_admission(a, first_tok, events)

    def _execute_recompute(self, req: Request, events: List[ev.Event],
                           store_after: bool = False):
        """Full prefill of one request's context and prompt into a fresh
        batch-1 state through ``ModelApi.prefill``: the recompute of the
        per-request path, and the exact recompute a degraded fused admission
        falls back to (fused plans never write back).  With ``store_after``
        it runs in two phases, so the stored snapshot holds no prompt token
        (SSM state mixes them in): the context alone, its write-back, then
        the prompt on the same state.  An embeds context (a VLM's image, an
        audio's frames) is one phase: the prompt after the embeds, the
        context's positions depending on the embeds alone, so the artifact
        is taken after the call.  Returns (prefill_s, logits, state)."""
        ctx, prompt = list(req.context_tokens), list(req.prompt_tokens)
        temp = self.api.init_state(self.cfg, 1, self.ec.max_len, device=self.device)
        if req.embeds is not None:
            logits, temp = self._prefill(prompt, temp, embeds=req.embeds)
            if store_after:
                self._write_back(req, paged.slot_artifact(temp, 0, len(ctx)), events)
        elif store_after:
            _, temp = self._prefill(ctx, temp)
            self._write_back(req, paged.slot_artifact(temp, 0, len(ctx)), events)
            logits, temp = self._prefill(prompt, temp)
        else:
            logits, temp = self._prefill(ctx + prompt, temp)
        prefill_s = self.perf.t_prefill(self.cost_cfg, len(ctx) + len(prompt))
        events.append(ev.PrefillDone(
            t_s=self.clock.now, req_id=req.req_id, n_tokens=len(ctx) + len(prompt),
            prefill_s=prefill_s,
        ))
        return prefill_s, logits, temp

    # -- shared-block-pool landings (paged decode) ----------------------- #
    def _pool_update(self, dst: np.ndarray, k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
        """Land KV rows at pool rows ``dst`` in place: the one scatter every
        landing shares.  The pool holds one attention cache, since the port
        builds it for attention-only archs (``paged.init_pool_caches``)."""
        idx = self._tensor(dst)
        pool = self._pool_caches[0].attn
        pool.k.index_copy_(1, idx, k_rows)
        pool.v.index_copy_(1, idx, v_rows)

    def _land_packed_in_pool(
        self, admissions: List[_Admission], layout: paged.PackLayout, new_caches
    ) -> None:
        """Move every segment's kv span from the packed buffers into the
        shared block pool.  Segments are kv_block-aligned (pack_align ==
        kv_block), so a span is a run of whole blocks and the batch lands as
        ONE scatter.  Batch-mates that loaded the same stored entry point
        their table prefixes at one refcounted copy of its full blocks; only
        each segment's own blocks are copied."""
        block = self.ec.kv_block
        src_blocks: List[int] = []
        dst_blocks: List[int] = []
        leaders: Dict[str, tuple] = {}  # entry_id -> (slot, matched)
        for a, seg in zip(admissions, layout.segments):
            shared_from, shared = None, 0
            if a.artifact is not None and a.lookup.entry is not None:
                led = leaders.get(a.lookup.entry.entry_id)
                if led is not None:
                    shared_from, led_matched = led
                    # a block is shareable iff BOTH mates' reused prefixes
                    # cover it fully; the boundary block stays private
                    shared = min(a.matched, led_matched) // block
                else:
                    leaders[a.lookup.entry.entry_id] = (seg.slot, a.matched)
            own = self._paged.admit(
                seg.slot, seg.n_total, shared_from=shared_from, shared_blocks=shared,
            )
            first = seg.kv_start // block
            for j, bid in enumerate(own, start=shared):
                src_blocks.append(first + j)
                dst_blocks.append(bid)
        src = self._tensor(paged.block_rows(src_blocks, block))
        dst = paged.block_rows(dst_blocks, block)
        packed = new_caches[0].attn
        self._pool_update(dst, packed.k[:, 0, src], packed.v[:, 0, src])

    def _land_state_in_pool(self, slot: Slot, temp) -> None:
        """Copy a batch-1 state's (or artifact's) first ``pos`` tokens into
        newly allocated pool blocks: the single-request landing of fused and
        degraded admissions (the one-segment analogue of
        ``_land_packed_in_pool``)."""
        block = self.ec.kv_block
        own = self._paged.admit(slot.index, int(temp.pos[0]))
        dst = paged.block_rows(own, block)
        n_rows = len(own) * block  # <= max_len (max_len % kv_block == 0)
        c = temp.caches[0].attn
        self._pool_update(dst, c.k[:, 0, :n_rows], c.v[:, 0, :n_rows])

    def _copy_pool_blocks(self, splits: List[paged.CowSplit]) -> None:
        """Copy-on-write: duplicate shared boundary blocks onto private ones
        before a decode write touches them (one gather/scatter pair)."""
        block = self.ec.kv_block
        src = self._tensor(paged.block_rows([s.src for s in splits], block))
        dst = paged.block_rows([s.dst for s in splits], block)
        pool = self._pool_caches[0].attn
        self._pool_update(dst, pool.k[:, src], pool.v[:, src])

    # -- storage fetch with cost-aware retry ----------------------------- #
    def _fetch_kv(self, req: Request, plan: ReusePlan, lookup: StoreLookup,
                  activity: str = "fetch"):
        """Charge + execute the storage fetch of a load/partial plan; returns
        (artifact, delay_s, billed_nbytes).  A lookahead prefetch already in
        flight shrinks the delay to its unfinished remainder.  ``activity``
        tags the ledger attribution ("fetch_retry" on re-issued attempts)."""
        entry = lookup.entry
        matched = plan.matched_tokens
        nbytes = plan.fetch_bytes
        override = None
        if self.cost_cfg is not self.cfg:
            # economics-at-scale: charge the FULL arch's KV bytes, and occupy
            # the tier's link for them
            nbytes = self._entry_fetch_bytes(entry, matched)
            override = nbytes
        with self._attr(activity, req.req_id):
            artifact, delay = self.store.fetch(
                entry.entry_id, fraction=matched / entry.n_tokens, nbytes=override
            )
        ready = self._prefetch_ready.pop(req.req_id, None)
        if ready is not None:
            # the fetch was issued while earlier requests were served: only
            # the unfinished remainder delays this request
            delay = max(0.0, min(delay, ready - self.clock.now))
        return artifact, delay, nbytes

    def _retry_fetch(self, req: Request, *, tier: str, entry_id: str, matched: int,
                     nbytes: float, attempt_fn, events: List[ev.Event]):
        """Run one storage fetch (``attempt_fn(activity)``) under the
        cost-aware retry policy.  Returns (result | None, wasted_s, attempts): the
        result is whatever ``attempt_fn`` returned on success; None means
        every attempt failed (or retrying stopped beating recompute) and the
        caller must degrade.  ``wasted_s`` sums the failed attempts' charged
        delays and the backoff waits."""
        policy = self.retry_policy
        wasted = 0.0
        attempt = 0
        while True:
            attempt += 1
            try:
                return attempt_fn("fetch" if attempt == 1 else "fetch_retry"), wasted, attempt
            except StorageError as exc:
                wasted += exc.delay_s
                self.fetch_failures += 1
                self.fetch_wasted_s += exc.delay_s
                self.fetch_wasted_bytes += exc.wasted_bytes
                events.append(ev.FetchFailed(
                    t_s=self.clock.now, req_id=req.req_id, tier=tier, entry_id=entry_id,
                    attempt=attempt, reason=exc.reason, wasted_s=exc.delay_s,
                    wasted_bytes=exc.wasted_bytes,
                ))
                if self.telemetry is not None:
                    # zero-dollar marker: the attempt's dollars were charged
                    # (stats and ledger) when its bytes moved; this makes the
                    # waste queryable per request and tier
                    self.telemetry.ledger.add(
                        "transfer", "fetch_failed", 0.0,
                        replica=self._replica, req_id=req.req_id,
                        tier=tier, nbytes=exc.wasted_bytes, kind="load",
                    )
                backoff = policy.backoff(attempt)
                retry_cost = policy.retry_cost(
                    backoff_s=backoff,
                    est_load_s=self.store.estimate_load_delay(tier, nbytes),
                    nbytes=nbytes,
                    gpu_cost_per_s=self._c_gpu_s,
                    per_gb_fee=self.pricing.tier(tier).per_gb_transfer_fee,
                )
                recompute_cost = self._c_gpu_s * self.perf.t_prefill(
                    self.cost_cfg, max(matched, 1)
                )
                if policy.should_retry(exc, attempt, tier=tier, retry_cost=retry_cost,
                                       recompute_cost=recompute_cost):
                    wasted += backoff
                    self.fetch_wasted_s += backoff
                    self.fetch_retries += 1
                    events.append(ev.FetchRetried(
                        t_s=self.clock.now, req_id=req.req_id, tier=tier, entry_id=entry_id,
                        attempt=attempt + 1, backoff_s=backoff,
                    ))
                    continue
                return None, wasted, attempt

    def _fetch_kv_resilient(self, a: _Admission, events: List[ev.Event]) -> None:
        """Execute a load/partial plan's fetch under the retry policy.  On
        success fills ``a.artifact/delay/nbytes/matched``; on exhaustion
        leaves ``a.artifact`` None with the wasted time on ``a.delay`` and
        marks the record degraded — the request falls back to recompute."""
        req, plan, entry = a.req, a.plan, a.lookup.entry
        nbytes = plan.fetch_bytes
        if self.cost_cfg is not self.cfg:
            nbytes = self._entry_fetch_bytes(entry, plan.matched_tokens)
        out, wasted, attempts = self._retry_fetch(
            req, tier=entry.tier, entry_id=entry.entry_id, matched=plan.matched_tokens,
            nbytes=nbytes,
            attempt_fn=lambda activity: self._fetch_kv(req, plan, a.lookup, activity),
            events=events,
        )
        if out is None:
            self.degraded_requests += 1
            a.rec.degraded = True
            a.artifact, a.nbytes, a.matched = None, 0.0, 0
            a.delay = wasted
            events.append(ev.DegradedToRecompute(
                t_s=self.clock.now, req_id=req.req_id, tier=entry.tier,
                entry_id=entry.entry_id, attempts=attempts, wasted_s=wasted,
                reason="fetch_exhausted",
            ))
            return
        artifact, delay, billed = out
        a.artifact, a.nbytes = artifact, billed
        a.delay = wasted + delay
        a.matched = plan.matched_tokens

    # -- marketplace: purchased KV --------------------------------------- #
    def _market_fetch(self, a: _Admission, events: List[ev.Event]) -> None:
        """Execute a bought plan (``ReusePlan.market``): delivery,
        verification and settlement run inside the marketplace.  On success
        a full-entry purchase is absorbed into this engine's own store, so a
        repeat of the context loads locally; on any failure (seller gone,
        fetch error, failed verification) the request degrades to exact
        recompute."""
        req, quote = a.req, a.plan.market
        res = self.market.execute(
            quote, req_id=req.req_id, now=self.clock.now,
            context_tokens=req.context_tokens, replica=self._replica,
        )
        events.extend(res.events)
        # the spot check ran on this engine's device: its GPU seconds are
        # compute this request caused, charged win or lose
        a.rec.compute_cost += res.verify_cost
        if not res.ok:
            self.degraded_requests += 1
            self.market_failed += 1
            a.rec.degraded = True
            a.artifact, a.nbytes, a.matched = None, 0.0, 0
            a.delay = res.wasted_s
            events.append(ev.DegradedToRecompute(
                t_s=self.clock.now, req_id=req.req_id, tier=a.plan.tier,
                entry_id=quote.entry_id, attempts=1, wasted_s=res.wasted_s,
                reason=f"market:{res.reason}",
            ))
            return
        a.artifact = res.artifact
        a.nbytes = res.nbytes
        a.matched = res.matched_tokens
        a.delay = res.delay_s + res.verify_s
        self.market_purchases += 1
        self.market_spend += res.price
        if self.ec.store_write_back and res.matched_tokens >= quote.n_tokens:
            # full-entry purchase: the artifact's rows cover exactly the
            # matched prefix, so the stored identity is sound; partial
            # matches are served but not stored
            ctx = list(req.context_tokens[:res.matched_tokens])
            saved = self._c_gpu_s * self.perf.t_prefill(self.cost_cfg, len(ctx))
            tier = self._store_tier()
            art = res.artifact
            if tier != self.ec.compress_tier:
                # a delivery dequantised on the card comes to the host first
                art = compression.to_host_tree(art)
            with self._attr("market_absorb", req.req_id):
                entry_id, _ = self.store.put(ctx, art, tier=tier, saved_per_use=saved)
            self._note_dedup(entry_id, req)
            self._emit_migrations(events)
            if entry_id is not None:
                e = self.store.entries[entry_id]
                events.append(ev.StoreWriteBack(
                    t_s=self.clock.now, req_id=req.req_id,
                    entry_id=entry_id, tier=e.tier, nbytes=e.nbytes,
                ))

    def _note_dedup(self, entry_id: Optional[str], req: Request) -> bool:
        """KVShare dedup: whether the put just made found its bytes already
        in a shared core (another tenant stored them); if so the market books
        a zero-dollar credit for the bytes the core did not duplicate.  Only
        the market and telemetry read it: with both off nothing is read."""
        if entry_id is None or (self.market is None and self.telemetry is None):
            return False
        dedup = self.store.last_put_handle.dedup
        if dedup and self.market is not None:
            self.market.note_dedup(
                self.store.entries[entry_id].nbytes,
                req_id=req.req_id, replica=self._replica,
            )
        return dedup

    def market_spot_check(self, context_tokens, artifact, n_tokens: int):
        """The market's check of purchased KV: prefill the first
        ``n_tokens`` of the context fresh through ``lm.prefill`` and compare
        the purchased state with it, both canonicalised through the same
        slot layout.  It passes when every leaf is within
        ``SPOT_CHECK_TOL`` of the model dtype (``spot_check_reading``).

        A tolerance check, not the reference's bitwise one: the seller's
        rows come out of a packed admission and the check's out of a
        per-request prefill, whose launches and matmul shapes differ, so
        even an honest seller's rows differ in their last bits (the
        reference's own check rejects its honest purchase on the CPU).  The
        checksum, checked on every delivery, catches tampered bytes; this
        catches a seller whose published KV is not what this model computes
        for these tokens, which lands orders of magnitude above the
        tolerance (ROADMAP C9).  Returns (ok, verify_s, verify_cost): the
        sample prefill's modelled GPU seconds and dollars, which the caller
        charges to the request."""
        n = int(min(n_tokens, len(context_tokens)))
        if n <= 0:
            return True, 0.0, 0.0
        reading = self.spot_check_reading(list(context_tokens)[:n], artifact)
        verify_s = self.perf.t_prefill(self.cost_cfg, n)
        return reading <= SPOT_CHECK_TOL[self.cfg.dtype], verify_s, self._c_gpu_s * verify_s

    def spot_check_reading(self, tokens: List[int], artifact) -> float:
        """max over the state's leaves of max|bought - fresh| / max(1,
        max|fresh|): ``fresh`` is a prefill of ``tokens`` into an empty
        batch-1 state, ``bought`` the first ``len(tokens)`` positions of
        ``artifact`` inserted into another (an SSM state whole, as the
        reference inserts it)."""
        n = len(tokens)
        temp = self.api.init_state(self.cfg, 1, self.ec.max_len, device=self.device)
        _, fresh = self._prefill(tokens, temp)
        want = paged.slot_artifact(fresh, 0, n)
        temp = self.api.init_state(self.cfg, 1, self.ec.max_len, device=self.device)
        paged.insert_slot(self.cfg, temp, 0, artifact, n_tokens=n)
        got = paged.slot_artifact(temp, 0, n)
        reading = 0.0
        for g, w in zip(compression.tree_leaves(got), compression.tree_leaves(want)):
            g = torch.as_tensor(g).double()
            w = torch.as_tensor(w).double()
            scale = max(1.0, w.abs().max().item())
            reading = max(reading, (g - w).abs().max().item() / scale)
        return reading

    def _write_back(self, req: Request, artifact: Any, events: List[ev.Event]) -> None:
        """Store a context's device-side artifact.  The int8 tier takes it as
        it lies, so ``kv_quant`` runs where the rows are and only the int8
        rows and scales cross to the host; any other tier takes a host copy."""
        ctx = list(req.context_tokens)
        saved = self._c_gpu_s * self.perf.t_prefill(self.cost_cfg, len(ctx))
        tier = self._store_tier()
        if tier != self.ec.compress_tier:
            artifact = paged.artifact_to_host(artifact)
        with self._attr("write_back", req.req_id):
            entry_id, _ = self.store.put(ctx, artifact, tier=tier, saved_per_use=saved)
        if self._note_dedup(entry_id, req) and self.telemetry is not None:
            # a content-addressed shared tier already held these bytes: no
            # upload, no fee; a zero-dollar entry shows the saving per request
            self.telemetry.ledger.add(
                "transfer", "write_back_dedup", 0.0,
                replica=self._replica, req_id=req.req_id,
                tier=self.store.last_put_handle.tier, nbytes=0.0, kind="store",
            )
        self._emit_migrations(events)
        if entry_id is not None:
            e = self.store.entries[entry_id]
            events.append(
                ev.StoreWriteBack(
                    t_s=self.clock.now, req_id=req.req_id,
                    entry_id=entry_id, tier=e.tier, nbytes=e.nbytes,
                )
            )

    def _emit_migrations(self, events: List[ev.Event]) -> None:
        """Surface capacity-pressure spills of a put as typed events."""
        for m in self.store.drain_migrations():
            events.append(
                ev.TierMigrated(
                    t_s=m.t_s, req_id=-1, entry_id=m.entry_id,
                    from_tier=m.from_tier, to_tier=m.to_tier,
                    nbytes=m.nbytes, reason=m.reason,
                )
            )

    def _lookup(
        self, req: Request, pending: Optional[Dict[str, List[float]]] = None
    ) -> StoreLookup:
        """Consult the store about the request's context; quantify how much of
        it the architecture can consume.  ``pending`` — per-tier fetch bytes
        already planned by earlier batch-mates this admission instant,
        folded into the predicted queue wait.  A lookup already walked by the
        prefetch pass is carried forward as long as the store's trie has not
        mutated since, and tiers inside a brownout are marked unavailable."""
        if not self.ec.reuse_enabled:
            return StoreLookup.miss()
        cached = self._prefetch_lookup.pop(req.req_id, None)
        if cached is not None and cached[2] == self.store.trie_version:
            match = cached[0]
            entry = self.store.entries.get(cached[1]) if cached[1] else None
            self.lookup_reuses += 1
        else:
            match, entry = self.store.lookup(list(req.context_tokens))
            self.lookup_walks += 1
        partial_ok = paged.partial_reuse_allowed(self.cfg) and req.embeds is None
        unavailable = frozenset(
            t for t in self.store.tier_order
            if self.ec.faults is not None and self.ec.faults.browned_out(t, self.clock.now)
        )
        frac = 0.0
        n_ctx = len(req.context_tokens)
        if (entry is not None and match.matched_tokens > 0
                and self._ring_rows_usable(entry, match.matched_tokens)):
            if match.matched_tokens >= n_ctx:
                frac = 1.0
            elif partial_ok:
                frac = match.matched_tokens / n_ctx
        queue_wait: Dict[str, float] = {}
        if entry is not None and frac > 0:
            ahead = () if pending is None else tuple(pending.get(entry.tier, ()))
            wait = self.store.estimated_queue_wait(
                entry.tier,
                self._entry_fetch_bytes(entry, match.matched_tokens),
                pending=ahead,
            )
            if wait > 0:
                queue_wait[entry.tier] = wait
        composite = None
        fused_bytes: Dict[str, float] = {}
        if self._fusion_on and req.embeds is None and frac < 1.0:
            comp = self.store.lookup_composite(list(req.context_tokens))
            if comp.matched_tokens > 0 and not any(
                (e := self.store.entries.get(eid)) is not None and e.tier in unavailable
                for eid in comp.rows_by_entry()
            ):
                # a composite touching a browned-out tier is unplannable: one
                # dead source spoils the whole assembly
                composite = comp
                for eid, rows in comp.rows_by_entry().items():
                    src = self.store.entries.get(eid)
                    if src is None:
                        continue
                    fused_bytes[src.tier] = fused_bytes.get(src.tier, 0.0) + (
                        self._entry_fetch_bytes(src, rows)
                    )
                for t, b in fused_bytes.items():
                    # contended-link visibility for the fused option (and
                    # batch-mates planned behind it)
                    ahead = () if pending is None else tuple(pending.get(t, ()))
                    wait = self.store.estimated_queue_wait(t, b, pending=ahead)
                    if wait > 0:
                        queue_wait[t] = max(queue_wait.get(t, 0.0), wait)
        return StoreLookup(
            match=match, entry=entry, fraction=frac, partial_ok=partial_ok,
            queue_wait_s=queue_wait, composite=composite, fused_bytes_by_tier=fused_bytes,
            unavailable_tiers=unavailable,
        )

    def _ring_rows_usable(self, entry, matched: int) -> bool:
        """``paged.ring_match_usable`` for a stored entry: on a sliding-window
        arch a match counts only if its rows lie in the artifact as
        positions (ROADMAP C11); otherwise the request plans as a miss, as
        an SSM arch's partial match does.  The stored context's length is
        its artifact's own ``pos`` (``entry.n_tokens`` rounds it down to
        whole chunks), read without a transfer; a payload the tier no
        longer holds keeps the match, so its fetch fails as any other."""
        if not self.cfg.sliding_window:
            return True
        try:
            stored = paged.artifact_length(self.store.backends[entry.tier].peek(entry.entry_id))
        except StorageError:
            return True
        return paged.ring_match_usable(self.cfg, stored, matched)

    def _entry_fetch_bytes(self, e, matched_tokens: int) -> float:
        """Bytes a fetch of ``matched_tokens`` moves, at economics scale."""
        if self.cost_cfg is not self.cfg:
            return s_storage_bytes(
                self.cost_cfg, matched_tokens,
                compression=0.5 if self.ec.compress_tier == e.tier else 1.0,
            )
        return e.nbytes * matched_tokens / max(e.n_tokens, 1)

    def _issue_prefetches(self) -> None:
        """Lookahead: start the storage fetches of queued requests whose
        contexts are stored (each fetch streams while the engine computes)."""
        if self.ec.prefetch_lookahead <= 0 or not self.ec.reuse_enabled:
            return
        for nxt in self.queue.peek_arrived(self.clock.now, self.ec.prefetch_lookahead):
            if nxt.req_id in self._prefetch_ready:
                continue
            cached = self._prefetch_lookup.get(nxt.req_id)
            if cached is not None and cached[2] == self.store.trie_version:
                # an earlier pass walked this context and the trie has not
                # mutated since: necessarily a miss (hits sit in
                # _prefetch_ready), so there is nothing new to fetch
                continue
            m, e = self.store.lookup(list(nxt.context_tokens))
            self.lookup_walks += 1
            # carry this walk forward to admission (hits and misses): the
            # admission's lookup reuses it unless the trie mutated since
            self._prefetch_lookup[nxt.req_id] = (
                m, e.entry_id if e is not None else None, self.store.trie_version
            )
            if e is None or m.matched_tokens == 0:
                continue
            nbytes = self._entry_fetch_bytes(e, m.matched_tokens)
            delay = self.store.estimate_load_delay(e.tier, nbytes)
            self._prefetch_ready[nxt.req_id] = self.clock.now + delay
            # pinned until admission consumes or abandons the prefetch:
            # another request's write-back pressure and demotion must not
            # invalidate a fetch in flight (the prefetch/eviction race)
            self.store.pin(e.entry_id)
            self._prefetch_pins[nxt.req_id] = e.entry_id

    def _release_prefetch(self, req_id: int) -> None:
        """Admission consumed (or abandoned) this request's prefetch: drop
        the ready-time record and the carried walk, release the pin."""
        self._prefetch_ready.pop(req_id, None)
        self._prefetch_lookup.pop(req_id, None)
        entry_id = self._prefetch_pins.pop(req_id, None)
        if entry_id is not None:
            self.store.unpin(entry_id)

    def _store_tier(self) -> str:
        if self.ec.store_tier is not None:
            return self.ec.store_tier
        return self.store.tier_order[-1]  # cloud tier (paper's EBS)

    # ------------------------------------------------------------------ #
    # Unified continuous-batching step (chunked prefill + decode)
    # ------------------------------------------------------------------ #
    def _step_unified(self) -> List[ev.Event]:
        """One unified scheduling step: take admissible requests in as chunk
        streams (plan, fetch, pool-block admission; no compute yet), then
        launch: every active slot's decode token with the ready streams'
        prefill chunks in ONE launch over the block pool.  A long
        suffix-prefill lands kv_block tokens at a time while the slots that
        are decoding keep stepping in the same launches."""
        events: List[ev.Event] = []
        self._run_migrations(events)
        admitted = self._unified_intake(events)
        if self._unified_launch(events) or admitted:
            return events
        # idle: jump to the next instant something can happen, the next
        # arrival or the earliest fetch completion
        targets = [c.ready_s for c in self._chunks.values() if c.ready_s > self.clock.now]
        nxt = self.queue.next_arrival()
        if nxt is not None and nxt > self.clock.now:
            targets.append(nxt)
        if targets:
            self._advance_clock(min(targets), events)
        return events

    def _unified_intake(self, events: List[ev.Event]) -> bool:
        """Take every admissible request with a free slot in as a pending
        chunk stream: plan it, execute its storage fetch (the delay becomes
        the stream's ready time, so a load overlaps other slots' compute)
        and admit its pool blocks.  A request the pool cannot take in chunks
        (embeds) is admitted whole through the per-request path
        (``_admit_single``)."""
        free = [s for s in self.slots if not s.active and s.index not in self._chunks]
        if not free:
            return False
        limit = min(len(free), self.ec.admit_batch or self.ec.max_slots)
        pending: Dict[str, List[float]] = {}
        n = 0
        while n < limit and self.queue.peek_next(self.clock.now) is not None:
            req = self.queue.pop_admissible(self.clock.now)
            if req.embeds is not None:
                self._admit_single(req, free[n], events)
                n += 1
                continue
            a = self._plan_admission(req, free[n], events, pending=pending)
            self._note_pending(a, pending)
            self._start_chunk_stream(a, events)
            n += 1
        if n:
            self._issue_prefetches()
        return n > 0

    def _start_chunk_stream(self, a: _Admission, events: List[ev.Event]) -> None:
        """Turn one planned admission into a pending chunk stream: fetch the
        stored KV (the prefix of load and partial plans, or a fused plan's
        sources), admit the slot's pool blocks for the whole context +
        prompt, land the reused rows, and queue the remaining tokens for
        chunked landing."""
        req, t0 = a.req, self.clock.now
        ctx, prompt = list(req.context_tokens), list(req.prompt_tokens)
        n_ctx, n_total = len(ctx), len(ctx) + len(prompt)
        ps = self._paged
        block = self.ec.kv_block
        fused_out = None
        if a.plan.action == "fused":
            fused_out = self._fetch_fused_sources(a, events)  # releases the prefetch
        else:
            if a.plan.market is not None:
                self._market_fetch(a, events)
            elif a.plan.loads_kv and a.lookup.entry is not None:
                self._fetch_kv_resilient(a, events)
            self._release_prefetch(req.req_id)
        own = ps.admit(a.slot.index, n_total)
        if fused_out is not None:
            sources, fetched = fused_out
            schedule = a.plan.fused
            layout = fusion.fused_layout(
                schedule, len(prompt), align=self.ec.pack_align,
                bucket_min=self.ec.pack_bucket_min,
            )
            # land the assembled valid rows (no bucket padding) before the
            # first chunk: reuse spans carry stored (delta-RoPE'd) KV,
            # recompute and prompt rows are zero and get overwritten as
            # their chunks land
            caches = fusion.build_fused_caches(self.cfg, schedule, sources, n_total, self.device)
            rows = paged.block_rows(ps.tables[a.slot.index, : len(own)], block)[:n_total]
            buf = caches[0].attn
            self._pool_update(rows, buf.k[:, 0, :n_total], buf.v[:, 0, :n_total])
            del caches, buf
            arrays = fusion.fused_arrays(schedule, ctx, prompt, layout)
            tokens = np.asarray(arrays["tokens"][0, : layout.n_q], np.int32)
            positions = np.asarray(arrays["q_pos"][0, : layout.n_q], np.int32)
            a.delay = max((d for _, _, d, _ in fetched), default=0.0)
            a.matched = schedule.reused_tokens
            # the stream's tokens land through the chunked launches: the
            # event names the stream's length and the rows it fills, and no
            # fused launch shape is compiled for it
            self._note_fused(a, t0, len(sources), fetched, layout.n_q, n_total, True, events)
        elif a.artifact is not None:
            matched = a.matched
            rows = paged.block_rows(ps.tables[a.slot.index, : -(-matched // block)], block)
            stored = a.artifact.caches[0].attn
            dtype = self._pool_caches[0].attn.k.dtype
            self._pool_update(
                rows[:matched],
                paged.to_device(stored.k[:, 0, :matched], dtype, self.device),
                paged.to_device(stored.v[:, 0, :matched], dtype, self.device),
            )
            events.append(ev.KVLoaded(
                t_s=t0, req_id=req.req_id, tier=self._loaded_tier(a), nbytes=a.nbytes,
                load_s=a.delay, matched_tokens=matched,
            ))
            tokens = np.asarray(ctx[matched:] + prompt, np.int32)
            positions = np.arange(matched, n_total, dtype=np.int32)
        else:
            # plain recompute, or a degraded fetch falling back to exact
            # recompute (the burned time rides on a.delay -> ready_s)
            tokens = np.asarray(ctx + prompt, np.int32)
            positions = np.arange(0, n_total, dtype=np.int32)

        store_after = a.plan.store_after and a.artifact is None and fused_out is None
        if store_after:
            key = tuple(ctx)
            if key in self._wb_inflight:
                # a pending stream already owes this context's write-back
                # (the packed batch's dedup, carried over)
                store_after = False
            else:
                self._wb_inflight[key] = a.slot.index
        self._chunks[a.slot.index] = _ChunkStream(
            a=a, tokens=tokens, positions=positions, n_ctx=n_ctx,
            ready_s=t0 + a.delay, store_after=store_after,
        )

    def _unified_launch(self, events: List[ev.Event]) -> bool:
        """Run one launch if there is anything to run: a mixed chunked
        launch when any chunk stream is ready, else a plain paged decode
        step (the legacy path's numerics, pricing and billing)."""
        now = self.clock.now
        ready = [self._chunks[i] for i in sorted(self._chunks) if self._chunks[i].ready_s <= now]
        if not ready:
            if any(s.active for s in self.slots):
                self._decode_step(events)
                return True
            return False
        self._unified_mixed_step(ready, events)
        return True

    def _unified_mixed_step(self, ready: List[_ChunkStream], events: List[ev.Event]) -> None:
        """ONE launch over the block pool: a decode row for every active
        slot (always granted) and prefill chunks of the ready streams (up to
        kv_block tokens each, under the step token budget).  Priced once
        (``PerfModel.t_step_unified``: the parameters stream once) and
        billed per row by normalised standalone-cost shares, so the step's
        dollars are conserved exactly."""
        ps = self._paged
        B, C = self.ec.max_slots, self.ec.kv_block
        t0 = self.clock.now
        decoding = [s for s in self.slots if s.active]
        splits = []
        for s in decoding:
            cow = ps.prepare_append(s.index)
            if cow is not None:
                splits.append(cow)
        if splits:
            self._copy_pool_blocks(splits)

        toks = np.zeros((B, C), np.int32)
        q_pos = np.full((B, C), -(2 ** 30), np.int32)
        last_idx = np.zeros((B,), np.int32)
        decode_lens = []
        for s in decoding:
            toks[s.index, 0] = s.last_token
            q_pos[s.index, 0] = int(ps.lens[s.index])
            decode_lens.append(s.record.context_len + s.record.prompt_len + s.generated)
        budget = max(self.ec.step_token_budget - len(decoding), 0)
        grants: List[tuple] = []  # (stream, tokens granted this step)
        chunk_desc: List[tuple] = []  # (n_new, L_end) for pricing
        for c in ready:
            g = min(C, c.remaining, budget)
            if g <= 0:
                if grants or decoding:
                    continue  # budget spent; this stream waits a step
                g = min(C, c.remaining)  # guarantee progress
            budget -= g
            sl = c.a.slot.index
            toks[sl, :g] = c.tokens[c.done:c.done + g]
            q_pos[sl, :g] = c.positions[c.done:c.done + g]
            last_idx[sl] = g - 1
            grants.append((c, g))
            chunk_desc.append((g, int(c.positions[c.done + g - 1]) + 1))

        jit_hit = self.unified_jit.record((B, C, ps.nb_max))
        with torch.inference_mode():
            logits, self._pool_caches = self.api.prefill_chunked(
                self.params, self.cfg, self._tensor(toks), self._pool_caches,
                block_table=self._tensor(ps.tables), q_pos=self._tensor(q_pos),
                last_idx=self._tensor(last_idx), block=C,
            )
        nxt_tok = logits.argmax(dim=-1).tolist()
        for s in decoding:
            ps.note_token(s.index)

        step_s = self.perf.t_step_unified(self.cost_cfg, decode_lens, chunk_desc)
        dec_sh, chk_sh = self.perf.step_unified_shares(self.cost_cfg, decode_lens, chunk_desc)
        self.clock.advance(step_s)
        n_chunk_tokens = sum(g for _, g in grants)
        self.unified_steps += 1
        self.unified_chunk_tokens += n_chunk_tokens
        self.unified_busy_s += step_s
        self.decode_tokens += len(decoding)
        dec_busy = step_s * sum(dec_sh)
        self.decode_busy_s += dec_busy
        self.admission_busy_s += step_s - dec_busy
        events.append(ev.UnifiedStep(
            t_s=t0, req_id=-1,
            req_ids=tuple([s.request.req_id for s in decoding]
                          + [c.a.req.req_id for c, _ in grants]),
            n_decode=len(decoding), chunk_tokens=n_chunk_tokens, step_s=step_s,
            jit_hit=jit_hit,
        ))

        for s, share in zip(decoding, dec_sh):
            tok = int(nxt_tok[s.index])
            s.record.tokens.append(tok)
            s.record.decode_s += step_s
            s.record.compute_cost += self._c_gpu_s * step_s * share
            s.last_token = tok
            tok_ev = ev.TokenEmitted(
                t_s=self.clock.now, req_id=s.request.req_id, token=tok, index=s.generated,
            )
            events.append(tok_ev)
            if self.on_token is not None:
                self.on_token(tok_ev)
            s.generated += 1
            self._maybe_finish(s, events)
        for (c, g), share in zip(grants, chk_sh):
            a = c.a
            a.rec.compute_cost += self._c_gpu_s * step_s * share
            c.done += g
            if c.remaining > 0:
                continue
            del self._chunks[a.slot.index]
            key = tuple(a.req.context_tokens)
            if self._wb_inflight.get(key) == a.slot.index:
                self._wb_inflight.pop(key)
            if c.store_after:
                self._write_back(a.req, self._pool_slot_artifact(a.slot.index, c.n_ctx), events)
            a.rec.matched_tokens = a.matched
            a.rec.load_s = a.delay
            # ttft_s = queue_s + load_s + prefill_s must equal the first
            # token's instant: prefill_s absorbs the chunked landing time,
            # the steps spent waiting on the budget included
            a.rec.prefill_s = max(0.0, self.clock.now - a.rec.start_s - a.delay)
            events.append(ev.PrefillDone(
                t_s=self.clock.now, req_id=a.req.req_id, n_tokens=len(c.tokens),
                prefill_s=a.rec.prefill_s,
            ))
            self._finish_admission(a, int(nxt_tok[a.slot.index]), events)

    def _pool_slot_artifact(self, slot: int, n_tokens: int) -> paged.LMState:
        """A slot's first ``n_tokens`` pool rows, gathered on the device, as a
        batch-1 artifact in the reference's layout: the unified path's
        write-backs (``_write_back`` copies it to the host or quantises it)."""
        block = self.ec.kv_block
        rows = paged.block_rows(self._paged.tables[slot, : -(-n_tokens // block)], block)
        idx = self._tensor(rows[:n_tokens])
        pool = self._pool_caches[0].attn
        return paged.LMState(
            pos=np.full((1,), n_tokens, np.int32),
            caches=(paged.BlockCache(paged.KVCache(
                pool.k[:, idx][:, None], pool.v[:, idx][:, None],
            )),),
        )

    def unified_stats(self) -> Dict[str, Any]:
        """Unified-step counters: mixed launches run, prefill tokens landed
        through chunks, modelled mixed-launch busy time, and the launch
        shape's bucket hits and misses (one shape: a whole unified serve
        shows exactly one miss)."""
        return {
            "enabled": self._unified_on,
            "steps": self.unified_steps,
            "chunk_tokens": self.unified_chunk_tokens,
            "busy_s": self.unified_busy_s,
            "jit": self.unified_jit.as_dict(),
        }

    # ------------------------------------------------------------------ #
    # Batched decode
    # ------------------------------------------------------------------ #
    def _decode_step(self, events: List[ev.Event]) -> None:
        active = np.array([s.active for s in self.slots])
        toks = np.array([[s.last_token if s.active else 0] for s in self.slots], np.int32)
        if self._paged_on:
            logits = self._decode_paged_launch(toks)
        else:
            state = self._state
            with torch.inference_mode():
                logits, new_state = self.api.decode(
                    self.params, self.cfg, self._tensor(toks), state
                )
            # inactive slots keep their position (their cache row writes are
            # masked by position for the next request placed there)
            self._state = new_state._replace(
                pos=torch.where(self._tensor(active), new_state.pos, state.pos)
            )
        nxt = logits.argmax(dim=-1).tolist()
        n_active = int(active.sum())
        lens = [
            s.record.context_len + s.record.prompt_len + s.generated
            for s in self.slots
            if s.active
        ]
        if self._paged_on:
            # live-blocks pricing: each slot is priced the KV bytes its
            # block table streams, not the longest slot's padded length
            step_s = self.perf.t_decode_paged(self.cost_cfg, lens)
        else:
            step_s = self.perf.t_decode(self.cost_cfg, 1, max(lens), batch=n_active)
        self.decode_steps += 1
        self.decode_busy_s += step_s
        self.decode_tokens += n_active
        self.clock.advance(step_s)
        if self._paged_on:
            # bill each slot by the KV bytes its own live blocks stream (the
            # weights are normalised, so the split conserves the step's
            # dollars; uniform lengths give the dense equal split)
            w = [self.perf.decode_kv_bytes(self.cost_cfg, n) for n in lens]
            costs = [self._c_gpu_s * step_s * wi / sum(w) for wi in w]
        else:
            costs = [self._c_gpu_s * step_s / n_active] * n_active
        cost_it = iter(costs)
        for s in self.slots:
            if not s.active:
                continue
            tok = int(nxt[s.index])
            s.record.tokens.append(tok)
            s.record.decode_s += step_s
            s.record.compute_cost += next(cost_it)
            s.last_token = tok
            tok_ev = ev.TokenEmitted(
                t_s=self.clock.now, req_id=s.request.req_id, token=tok, index=s.generated,
            )
            events.append(tok_ev)
            if self.on_token is not None:
                self.on_token(tok_ev)
            s.generated += 1
            self._maybe_finish(s, events)

    def _decode_paged_launch(self, toks: np.ndarray) -> torch.Tensor:
        """One paged decode step across all slots: grow or copy-on-write
        split the active slots' block tables for the incoming token, run the
        shared-pool step, and count the appended tokens (tables and lengths
        live on the host, in ``PagedSlots``)."""
        ps = self._paged
        splits = []
        for s in self.slots:
            if s.active:
                cow = ps.prepare_append(s.index)
                if cow is not None:
                    splits.append(cow)
        if splits:
            self._copy_pool_blocks(splits)
        with torch.inference_mode():
            logits, self._pool_caches = self.api.decode_paged(
                self.params, self.cfg, self._tensor(toks), self._pool_caches,
                block_table=self._tensor(ps.tables),
                pos=self._tensor(ps.lens.astype(np.int32)), block=self.ec.kv_block,
            )
        for s in self.slots:
            if s.active:
                ps.note_token(s.index)
        return logits

    def _maybe_finish(self, s: Slot, events: List[ev.Event]) -> None:
        req = s.request
        done = s.generated >= req.max_new_tokens or (
            req.eos_token is not None and s.last_token == req.eos_token
        )
        if done:
            s.record.finish_s = self.clock.now
            self.records.append(s.record)
            events.append(
                ev.RequestFinished(t_s=self.clock.now, req_id=req.req_id, record=s.record)
            )
            s.active = False
            s.request = None
            if self._paged_on:
                # the slot's blocks go back to the pool (shared ones on their
                # last reference) and its zeroed table sends stale writes to
                # the dump block
                self._paged.free(s.index)
