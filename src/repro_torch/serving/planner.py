"""Plan half of the serving engine's plan/execute split.

Per admitted request the engine asks a ``ReusePlanner`` one question — given
this request, what the store knows about its context (``StoreLookup``), and
its workload shape, what should happen?  The answer is a declarative
``ReusePlan``: recompute or load (fully/partially) from which tier, how many
bytes move, whether to write the context back after prefill, and the
analytical model's TTFT/$ estimates for the chosen option.  Planning is pure
(no store/compute side effects), so planner variants — the paper's
cost-model gating, unconditional reuse, or future CacheBlend/KVShare-style
schemes — are drop-in and unit-testable against golden plans.

Two planners ship in the port:

  * ``CostAwarePlanner``   — the paper's policy: recompute/load/partial by
    analytical cost under the TTFT SLO (``core.policy.decide``), write-back
    iff expected reuses clear break-even (``core.policy.should_store``).
  * ``AlwaysReusePlanner`` — store & reuse unconditionally (correctness
    tests, and the paper's own Fig-2 experiment which always reuses).

The reference's ``BlendPlanner`` (CacheBlend-style fused reuse) comes with
the fused prefill path, ROADMAP queue A item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, runtime_checkable

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cost_model
from repro_torch.core import policy as policy_mod
from repro_torch.core.cost_model import Workload
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.pricing import Pricing
from repro_torch.kvcache.chunks import PrefixMatch
from repro_torch.kvcache.fusion import CompositeMatch
from repro_torch.kvcache.store import StoredEntry
from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class StoreLookup:
    """What the store knows about a request's context at plan time."""

    match: Optional[PrefixMatch]
    entry: Optional[StoredEntry]
    # usable fraction of the request's context covered by the stored prefix
    # (0 when nothing is stored, or when a partial prefix exists but the
    # architecture cannot consume it — SSM state is all-or-nothing).
    fraction: float
    partial_ok: bool
    # tier -> predicted queueing delay on that tier's (concurrency-limited)
    # link right now; empty for uncontended links.  Tier-aware planners fold
    # this into per-tier TTFT estimates.
    queue_wait_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Chunk-content index view of the context (kvcache/fusion.py): non-prefix
    # chunk matches for CacheBlend-style fusion.  None when fusion is off or
    # the architecture cannot consume assembled KV (SSM/enc-dec/embeds).
    composite: Optional[CompositeMatch] = None
    # tier -> bytes the composite's matched chunks would fetch from it (at
    # economics scale) — the fused option's load/fee pricing surface.
    fused_bytes_by_tier: Dict[str, float] = dataclasses.field(default_factory=dict)
    # tiers browned out at lookup time (kvcache.faults.Brownout windows):
    # the planner must not plan a load from them — a fetch would fail fast.
    unavailable_tiers: frozenset = frozenset()

    @property
    def hit(self) -> bool:
        return (
            self.entry is not None
            and self.fraction > 0
            and self.entry.tier not in self.unavailable_tiers
        )

    def available(self) -> Dict[str, float]:
        """tier name -> matched fraction, the policy's option set (tiers in
        a brownout window are excluded — loads from them cannot succeed)."""
        return {self.entry.tier: self.fraction} if self.hit else {}

    @property
    def prefix_tokens(self) -> int:
        """Context tokens the architecture-usable prefix match covers."""
        if self.match is None or self.fraction <= 0:
            return 0
        return self.match.matched_tokens

    @staticmethod
    def miss() -> "StoreLookup":
        return StoreLookup(match=None, entry=None, fraction=0.0, partial_ok=False)


@dataclasses.dataclass(frozen=True)
class ReusePlan:
    """Declarative outcome of planning one request (execute interprets it)."""

    action: str  # "recompute" | "load" | "partial" | "fused"
    tier: Optional[str]  # source tier when loading (fused: the dominant one)
    matched_tokens: int  # context tokens served from stored state
    reused_fraction: float
    fetch_bytes: float  # stored bytes that will move (0 for recompute)
    store_after: bool  # write the context state back after prefill
    est_ttft_s: float  # analytical-model estimates for the chosen option
    est_cost: float
    # CacheBlend-style fused admissions: the execution schedule (reuse spans
    # + selected recompute spans, kvcache.fusion.FusedSchedule); None for
    # the classic actions.
    fused: Optional[object] = None
    # Marketplace purchases (repro_torch.market): the accepted peer Quote when the
    # plan's KV bytes are bought from another tenant's store rather than
    # fetched from this engine's own; None for all local plans.
    market: Optional[object] = None

    @property
    def loads_kv(self) -> bool:
        """Single-entry prefix load (the classic execute path)."""
        return self.action in ("load", "partial")

    @property
    def reuses_kv(self) -> bool:
        """Any stored-KV reuse, prefix or chunk-composite."""
        return self.action in ("load", "partial", "fused")


@runtime_checkable
class ReusePlanner(Protocol):
    """Pure request-level reuse policy: (request, lookup, workload) -> plan."""

    def configure(
        self,
        *,
        cost_cfg: ArchConfig,
        pricing: Pricing,
        perf: PerfModel,
        write_back: bool,
        min_store_tokens: int,
    ) -> None:
        """Bind the engine's economics environment (called once at engine
        construction; planners are created bare by callers)."""
        ...

    def plan(self, request: Request, lookup: StoreLookup, workload: Workload) -> ReusePlan:
        ...


class _PlannerBase:
    """Environment binding + the decision->plan translation shared by the
    shipped planners."""

    def __init__(self) -> None:
        self.cost_cfg: Optional[ArchConfig] = None
        self.pricing: Optional[Pricing] = None
        self.perf: Optional[PerfModel] = None
        self.write_back: bool = True
        self.min_store_tokens: int = 1

    def configure(
        self,
        *,
        cost_cfg: ArchConfig,
        pricing: Pricing,
        perf: PerfModel,
        write_back: bool,
        min_store_tokens: int,
    ) -> None:
        self.cost_cfg = cost_cfg
        self.pricing = pricing
        self.perf = perf
        self.write_back = write_back
        self.min_store_tokens = min_store_tokens

    # -- helpers -------------------------------------------------------- #
    def _storable(self, request: Request, lookup: StoreLookup) -> bool:
        """Write-back is even on the table only when enabled, the context is
        not already stored, and it spans at least one chunk."""
        return (
            self.write_back
            and lookup.entry is None
            and len(request.context_tokens) >= self.min_store_tokens
        )

    def _to_plan(
        self,
        decision: policy_mod.Decision,
        request: Request,
        lookup: StoreLookup,
        *,
        store_after: bool,
    ) -> ReusePlan:
        matched = 0
        fetch_bytes = 0.0
        if decision.loads_kv and lookup.entry is not None:
            matched = (
                len(request.context_tokens)
                if decision.action == "load"
                else lookup.match.matched_tokens
            )
            e = lookup.entry
            fetch_bytes = e.nbytes * max(0.0, min(1.0, matched / max(e.n_tokens, 1)))
        return ReusePlan(
            action=decision.action,
            tier=decision.tier,
            matched_tokens=matched,
            reused_fraction=decision.reused_fraction,
            fetch_bytes=fetch_bytes,
            store_after=store_after and not decision.loads_kv,
            est_ttft_s=decision.est_ttft_s,
            est_cost=decision.est_cost,
        )


class CostAwarePlanner(_PlannerBase):
    """The paper's policy: cheapest SLO-satisfying option, break-even-gated
    write-back.  Tier-aware: each candidate tier's TTFT estimate includes the
    predicted queueing delay on that tier's contended link, so a burst on a
    limit-k backend can tip the decision back to recompute under a TTFT SLO."""

    def plan(self, request: Request, lookup: StoreLookup, workload: Workload) -> ReusePlan:
        decision = policy_mod.decide(
            self.cost_cfg, workload, self.pricing, self.perf,
            available=lookup.available(),
            queue_wait_s=lookup.queue_wait_s,
        )
        store_after = self._storable(request, lookup) and policy_mod.should_store(
            self.cost_cfg, workload, self.pricing, self.perf,
            expected_reuses=request.expected_reuses,
        )
        return self._to_plan(decision, request, lookup, store_after=store_after)


class AlwaysReusePlanner(_PlannerBase):
    """Unconditional store & reuse (the paper's Fig-2 pipeline): any stored
    prefix is loaded, every new context is written back."""

    def plan(self, request: Request, lookup: StoreLookup, workload: Workload) -> ReusePlan:
        available = lookup.available()
        if available:
            tier, frac = next(iter(available.items()))
            decision = policy_mod.Decision(
                action="load" if frac >= 1.0 else "partial",
                tier=tier, reused_fraction=frac, est_ttft_s=0.0, est_cost=0.0,
            )
        else:
            decision = policy_mod.decide(
                self.cost_cfg, workload, self.pricing, self.perf, available={}
            )
        return self._to_plan(
            decision, request, lookup, store_after=self._storable(request, lookup)
        )
