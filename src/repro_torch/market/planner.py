"""Buy-vs-recompute planning: the marketplace's entry into the planner chain.

``MarketPlanner`` wraps any existing planner (CostAware by default, or a
BlendPlanner for fusion-enabled engines) and adds ONE more option to the
auction the base already runs: buy the matched prefix KV from a peer.  The
buy option is priced honestly —

    est_ttft = quote.est_load_s (seller link + queue + RPC) + tail prefill
    est_cost = marginal compute for the unmatched tail and decode
               + the quote price (seller ask x risk multiplier + flat fee)

— and competes under the same SLO guard the fused option uses.  A winning
buy becomes a ``load``/``partial`` plan carrying the ``Quote`` in
``ReusePlan.market``; the engine's ``_market_fetch`` executes it (delivery,
verification, settlement) instead of a local store fetch.  The buyer's own
store always wins ties: a quote matching no more than the local prefix is
discarded before pricing, and so is, on a sliding-window arch, a quote of a
stored context longer than the window (a wrapped ring, ROADMAP C11).

``always=True`` is the always-buy baseline for benchmarks: buy whenever a
peer has anything and the local store can't serve a full load — the bench
gate requires the cost-aware mode to beat it (and never-buy) on total $.

This is the port of the reference's ``market/planner.py`` over the port's
planners and ``core/policy.py``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import policy as policy_mod
from repro_torch.core.cost_model import Workload
from repro_torch.serving.planner import (
    CostAwarePlanner,
    ReusePlan,
    StoreLookup,
    _PlannerBase,
)
from repro_torch.serving.request import Request


class MarketPlanner(_PlannerBase):
    def __init__(
        self, base: Optional[_PlannerBase] = None, *, session=None,
        always: bool = False,
    ) -> None:
        super().__init__()
        self.base: _PlannerBase = base or CostAwarePlanner()
        self.session = session
        self.always = always

    def configure(self, **kw) -> None:
        super().configure(**kw)
        self.base.configure(**kw)

    def _buy_plan(
        self, request: Request, lookup: StoreLookup, workload: Workload
    ) -> Optional[ReusePlan]:
        if self.session is None:
            return None
        quote = self.session.quote(tuple(request.context_tokens))
        if quote is None:
            return None
        n_ctx = len(request.context_tokens)
        matched = min(quote.matched_tokens, n_ctx)
        if matched <= lookup.prefix_tokens:
            return None  # own store covers at least as much, fee-free
        if matched < n_ctx and not lookup.partial_ok:
            return None  # architecture can't consume a partial prefix
        if not self._ring_unwrapped(quote):
            return None
        frac = matched / max(n_ctx, 1)
        tail = n_ctx - matched
        ttft = quote.est_load_s + self.perf.t_prefill(
            self.cost_cfg, workload.L_prompt + tail
        )
        # marginal compute for the tail + decode (tier=None: the transfer
        # economics live in the quote price, not in a storage-fee term)
        cost = policy_mod._marginal_request_cost(
            self.cost_cfg, workload, self.pricing, self.perf,
            tier=None, reused_fraction=frac,
        ) + quote.price
        return ReusePlan(
            action="load" if matched >= n_ctx else "partial",
            tier=f"market:{quote.seller}",
            matched_tokens=matched,
            reused_fraction=frac,
            fetch_bytes=quote.nbytes,
            store_after=False,
            est_ttft_s=ttft,
            est_cost=cost,
            market=quote,
        )

    def _ring_unwrapped(self, quote) -> bool:
        """Whether a quote's artifact holds its rows as positions (ROADMAP
        C11).  On a sliding-window arch the artifact of a context longer
        than the window is a wrapped ring: a partial buy would insert rows
        of the wrong positions, and a whole buy fails the spot check, which
        compares rows ``[:n]`` with a fresh prefill of the first ``n``
        tokens, and blacklists an honest seller.  So the buyer declines
        every such quote and the request keeps its local plan.  The stored
        length is the artifact's own ``pos``, as the engine's
        ``_ring_rows_usable`` reads it."""
        engine = self.session.engine
        window = engine.cfg.sliding_window if engine is not None else None
        if not window:
            return True
        stored = self.session.marketplace.tenants[quote.seller].stored_length(quote.entry_id)
        return stored is not None and stored <= window

    def plan(self, request: Request, lookup: StoreLookup, workload: Workload) -> ReusePlan:
        base_plan = self.base.plan(request, lookup, workload)
        buy = self._buy_plan(request, lookup, workload)
        if buy is None:
            return base_plan
        if self.always:
            # always-buy baseline: a full local load still wins (no bytes
            # to buy); anything less and the market gets the trade
            return base_plan if base_plan.action == "load" else buy
        slo = workload.slo_ttft_s
        if slo is not None and buy.est_ttft_s > slo >= base_plan.est_ttft_s:
            return base_plan
        return buy if buy.est_cost < base_plan.est_cost else base_plan
