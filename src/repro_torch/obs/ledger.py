"""Cost-attribution ledger: every dollar lands on a request or an activity.

The engine's bill has three categories (``ServingSummary``):

  * compute  — GPU-seconds, accrued per request (prefill share + decode
    share; ``serving/engine.py``);
  * storage  — GB-hour accrual per resident tier
    (``kvcache/hierarchy.TieredStore``);
  * transfer — per-GB fees on every charged byte movement
    (``kvcache/transfer.TransferModel``).

The ledger records the same dollars as typed ``LedgerEntry`` rows tagged
with WHO caused them: a request (``req_id``) or an infrastructure activity
(migration, rebalance, dedup'd write-back, gossip).  Attribution is exact
by construction — compute entries copy each finished record's accrued
cost, transfer entries are written by the ``TransferModel`` fee hook at
charge time (the engine brackets fetches/write-backs with an attribution
context), storage entries settle from the store's own per-tier GB-hour
meters — so the conservation law

    ledger.totals() == summary.{compute,storage,transfer}_cost  (atol 1e-9)

holds for any run, including cluster runs per replica.  ``check_conservation``
asserts it; ``chip_smoke.py`` gates the card's serves on it.

Uncharged movements (migrations move bytes with ``charge=False``, gossip
is host-side, dedup'd write-backs skip the upload) still get zero-dollar
entries carrying their byte counts, so "where did the money go" and
"where did the bytes go" are both answerable without breaking conservation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.pricing import GB

CATEGORIES = ("compute", "storage", "transfer")


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    category: str  # "compute" | "storage" | "transfer"
    # what caused the spend: "request" (compute), "fetch"/"write_back"
    # (request-attributed transfers), "fetch_retry" (re-issued attempts
    # under the retry policy — retry dollars separable by activity),
    # "fetch_failed" (zero-$ marker per failed attempt; its wasted dollars
    # were charged when the bytes moved, so conservation already holds),
    # "hold" (storage residency, per tier),
    # "migration" | "rebalance" | "gossip" | "write_back_dedup" (infra),
    # "other" (a charge outside any attribution context — still conserved)
    activity: str
    dollars: float
    replica: int = 0
    req_id: Optional[int] = None  # None = infrastructure
    tier: Optional[str] = None
    nbytes: float = 0.0
    kind: Optional[str] = None  # transfers: "load" | "store"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CostLedger:
    """Append-mostly entry log + the aggregations consumers ask of it."""

    # subclasses may extend (e.g. the marketplace SettlementLedger adds
    # a "market" category for peer-to-peer purchase flows)
    CATEGORIES = CATEGORIES

    def __init__(self) -> None:
        self.entries: List[LedgerEntry] = []
        # storage "hold" entries are a settlement, not a log: recomputed
        # from the store's meters on demand, replaced per (replica, tier)
        self._holds: Dict[tuple, LedgerEntry] = {}

    # -- writes ---------------------------------------------------------- #
    def add(
        self,
        category: str,
        activity: str,
        dollars: float,
        *,
        replica: int = 0,
        req_id: Optional[int] = None,
        tier: Optional[str] = None,
        nbytes: float = 0.0,
        kind: Optional[str] = None,
    ) -> None:
        assert category in self.CATEGORIES, category
        self.entries.append(
            LedgerEntry(
                category=category, activity=activity, dollars=float(dollars),
                replica=replica, req_id=req_id, tier=tier,
                nbytes=float(nbytes), kind=kind,
            )
        )

    def record_transfer(
        self, tier: str, kind: str, nbytes: float, dollars: float, *,
        activity: str = "other", replica: int = 0,
        req_id: Optional[int] = None,
    ) -> None:
        """The ``TransferModel`` fee hook: one entry per charged movement,
        called at charge time with whatever attribution context the engine
        has bracketed the operation with."""
        self.add(
            "transfer", activity, dollars, replica=replica, req_id=req_id,
            tier=tier, nbytes=nbytes, kind=kind,
        )

    def settle_storage(
        self, costs_by_tier: Dict[str, float], *, replica: int = 0,
        bytes_by_tier: Optional[Dict[str, float]] = None,
    ) -> None:
        """Replace this replica's storage "hold" entries with the store's
        current per-tier accrued dollars.  Idempotent: call at every
        summary; the latest settlement wins."""
        for tier, dollars in costs_by_tier.items():
            nb = (bytes_by_tier or {}).get(tier, 0.0)
            self._holds[(replica, tier)] = LedgerEntry(
                category="storage", activity="hold", dollars=float(dollars),
                replica=replica, tier=tier, nbytes=float(nb),
            )

    # -- reads ----------------------------------------------------------- #
    def all_entries(self) -> List[LedgerEntry]:
        return self.entries + [self._holds[k] for k in sorted(self._holds)]

    def totals(self, *, replica: Optional[int] = None) -> Dict[str, float]:
        """category -> dollars (optionally one replica's share)."""
        out = {c: 0.0 for c in self.CATEGORIES}
        for e in self.all_entries():
            if replica is not None and e.replica != replica:
                continue
            out[e.category] += e.dollars
        return out

    def total(self) -> float:
        return sum(self.totals().values())

    def by_request(self, *, replica: Optional[int] = None) -> Dict[int, float]:
        """req_id -> attributed dollars (compute + its transfers)."""
        out: Dict[int, float] = {}
        for e in self.all_entries():
            if e.req_id is None:
                continue
            if replica is not None and e.replica != replica:
                continue
            out[e.req_id] = out.get(e.req_id, 0.0) + e.dollars
        return out

    def by_activity(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.all_entries():
            out[e.activity] = out.get(e.activity, 0.0) + e.dollars
        return out

    def by_tier(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.all_entries():
            if e.tier is not None:
                out[e.tier] = out.get(e.tier, 0.0) + e.dollars
        return out

    def infrastructure_total(self) -> float:
        """Dollars not attributable to any single request (holds included)."""
        return sum(e.dollars for e in self.all_entries() if e.req_id is None)

    def as_dict(self) -> dict:
        return {
            "totals": self.totals(),
            "by_activity": self.by_activity(),
            "by_tier": self.by_tier(),
            "infrastructure": self.infrastructure_total(),
            "n_entries": len(self.all_entries()),
        }


def check_conservation(
    ledger: CostLedger,
    summary,
    *,
    replica: Optional[int] = None,
    atol: float = 1e-9,
) -> Dict[str, float]:
    """Assert the conservation law against a ``ServingSummary`` (or any
    object with compute/storage/transfer_cost); returns the per-category
    absolute residuals on success."""
    t = ledger.totals(replica=replica)
    residuals = {
        "compute": abs(t["compute"] - summary.compute_cost),
        "storage": abs(t["storage"] - summary.storage_cost),
        "transfer": abs(t["transfer"] - summary.transfer_cost),
    }
    bad = {k: v for k, v in residuals.items() if not v <= atol}
    if bad:
        raise AssertionError(
            f"cost conservation violated (atol={atol}): residuals {bad}; "
            f"ledger={t}, summary=({summary.compute_cost}, "
            f"{summary.storage_cost}, {summary.transfer_cost})"
        )
    return residuals


def ledger_from_simulation(result, pricing, tier) -> CostLedger:
    """Exact ledger for an analytic ``core.simulator.SimResult``: one
    compute entry per request (prefill + decode seconds at the GPU rate),
    one storage hold, one transfer entry — the same three terms
    ``SimResult.cost`` sums, so conservation holds by construction (the
    property test checks the float identity actually survives
    re-association)."""
    ledger = CostLedger()
    c_gpu_s = pricing.compute.cost_per_hour / 3600.0
    for i, r in enumerate(result.results):
        ledger.add(
            "compute", "request", c_gpu_s * (r.prefill_s + r.decode_s),
            req_id=i,
        )
    ledger.settle_storage(
        {tier.name: tier.cost_per_gb_hour * result.storage_gb_hours}
    )
    ledger.add(
        "transfer", "other",
        tier.per_gb_transfer_fee * result.transferred_bytes / GB,
        tier=tier.name, nbytes=result.transferred_bytes,
    )
    return ledger
