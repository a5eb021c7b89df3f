"""Reuse decision policy: recompute vs load-from-tier, per request.

The paper's pipelines are the two extremes (always recompute / always load).
In the serving engine we generalise: for each admitted request the policy
evaluates, via the analytical model, every option available for its context —

  * RECOMPUTE        — full prefill (no stored state / not worth loading),
  * LOAD(tier)       — fetch stored context state, prefill only the prompt,
  * PARTIAL(tier, f) — longest-prefix match covers a fraction f of the
                       context; load that and suffix-prefill the tail,

and picks the cheapest that satisfies the TTFT SLO.  Write-back is decided by
the break-even rule (store iff expected reuses make C_KV < C_text).

This module is the *analytical* layer: pure functions of (arch, workload,
pricing, perf).  The serving-side wrapper that turns a Decision into an
executable per-request ``ReusePlan`` lives in ``repro_torch.serving.planner``
(``CostAwarePlanner`` binds ``decide`` + ``should_store``; planner variants
swap this policy without touching the engine).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cost_model
from repro_torch.core.cost_model import Workload
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.pricing import GB, Pricing, StorageTier


@dataclasses.dataclass(frozen=True)
class Decision:
    action: str  # "recompute" | "load" | "partial"
    tier: Optional[str]
    reused_fraction: float
    est_ttft_s: float
    est_cost: float  # marginal $ for this request

    @property
    def loads_kv(self) -> bool:
        return self.action in ("load", "partial")


def _marginal_request_cost(
    cfg: ArchConfig,
    w: Workload,
    pricing: Pricing,
    perf: PerfModel,
    *,
    tier: Optional[StorageTier],
    reused_fraction: float,
) -> float:
    c_gpu = pricing.compute.cost_per_hour / 3600.0
    L_tail = w.L_context - int(w.L_context * reused_fraction)
    compute_s = perf.t_prefill(cfg, w.L_prompt + L_tail) + perf.t_decode(
        cfg, w.L_output, w.L_context + w.L_prompt, batch=w.decode_batch
    )
    cost = c_gpu * compute_s
    if tier is not None and reused_fraction > 0:
        s_bytes = cost_model.s_storage_bytes(cfg, w.L_context) * reused_fraction
        cost += tier.per_gb_transfer_fee * s_bytes / GB
    return cost


def decide(
    cfg: ArchConfig,
    w: Workload,
    pricing: Pricing,
    perf: PerfModel,
    *,
    available: Dict[str, float],  # tier name -> matched prefix fraction [0,1]
    compression: float = 1.0,
    # tier name -> predicted queueing delay on that tier's contended link;
    # folded into the tier's TTFT estimate (empty/absent = uncontended).
    queue_wait_s: Optional[Dict[str, float]] = None,
) -> Decision:
    """Choose the cheapest SLO-satisfying plan for one request."""
    options: List[Decision] = []

    d = cost_model.delay_text(cfg, w, perf)
    options.append(
        Decision(
            action="recompute",
            tier=None,
            reused_fraction=0.0,
            est_ttft_s=d.ttft_s,
            est_cost=_marginal_request_cost(
                cfg, w, pricing, perf, tier=None, reused_fraction=0.0
            )
            + pricing.compute.cost_per_hour / 3600.0 * perf.t_prefill(cfg, w.L_context),
        )
    )
    for tier_name, frac in available.items():
        if frac <= 0:
            continue
        tier = pricing.tier(tier_name)
        dk = cost_model.delay_kv(
            cfg, w, perf, tier=tier, compression=compression, reused_fraction=frac
        )
        wait = (queue_wait_s or {}).get(tier_name, 0.0)
        options.append(
            Decision(
                action="load" if frac >= 1.0 else "partial",
                tier=tier_name,
                reused_fraction=frac,
                est_ttft_s=dk.ttft_s + wait,
                est_cost=_marginal_request_cost(
                    cfg, w, pricing, perf, tier=tier, reused_fraction=frac
                ),
            )
        )

    feasible = [
        o for o in options if w.slo_ttft_s is None or o.est_ttft_s <= w.slo_ttft_s
    ]
    pool = feasible or options  # SLO-infeasible workload: degrade to cheapest
    return min(pool, key=lambda o: (o.est_cost, o.est_ttft_s))


def should_store(
    cfg: ArchConfig,
    w: Workload,
    pricing: Pricing,
    perf: PerfModel,
    *,
    expected_reuses: float,
    tier: Optional[StorageTier] = None,
    compression: float = 1.0,
) -> bool:
    """Write-back policy: store the context KV iff the expected reuse count
    clears the analytical break-even."""
    n_star = cost_model.break_even_reuses(
        cfg, w, pricing, perf, tier=tier, compression=compression
    )
    return n_star is not None and expected_reuses >= n_star
