"""KV marketplace: a multi-tenant peer economy for stored caches.

"Can I Buy Your KV Cache?" (PAPERS.md) asks the natural sequel to the
source paper's break-even math: if stored KV beats recompute on $, it is a
*tradeable asset*.  This package layers a peer economy on the existing
storage/serving stack:

  * ``TenantStore`` / ``Catalog``  — a tenant's sellable, ACL-filtered view
    over its ``TieredStore``, each entry priced from the seller's Pricing
    plus an amortized write premium (catalog.py);
  * ``MarketPlanner``              — wraps the CostAware/Blend planner chain
    and shops quotes across peers at plan time, buy-vs-recompute by marginal
    cost with RPC latency and seller link contention folded into TTFT
    (planner.py);
  * ``SettlementLedger``           — extends ``obs.ledger.CostLedger`` with
    a "market" category: every purchase debits the buyer and credits the
    seller minus the market fee, conservation asserted at 1e-9
    (settlement.py);
  * ``ReputationBook``             — trust: purchased payloads are checksum-
    verified always and spot-checked against a recompute sample, within
    the model dtype's tolerance (``ServingEngine.market_spot_check``);
    sellers caught serving corrupt payloads are priced up and blacklisted
    (reputation.py, market.py);
  * ``Marketplace`` / ``MarketSession`` — the exchange itself: quoting,
    delivery, verification, settlement, and the adversary hook that reuses
    the ``kvcache.faults`` corruption machinery as a dishonest seller
    (market.py).

KVShare-style multi-tenant dedup rides ``SharedBackendCore``: identical
content uploaded by two tenants stores once; the second upload settles as a
zero-byte dedup credit (``MarketSession.note_dedup``).

The marketplace is opt-in: engines built without a session behave exactly
as before (the golden seed trace is untouched).  A purchased payload is the
seller's stored KV, which the buyer reads like its own store's, so on the
same launches generated tokens match recompute.

This is the port of the reference's ``market`` package: the same modules
and public names, with PyTorch and plain Python inside.
"""
from repro_torch.market.catalog import Catalog, CatalogEntry, TenantStore
from repro_torch.market.market import Marketplace, MarketResult, MarketSession, Quote
from repro_torch.market.planner import MarketPlanner
from repro_torch.market.reputation import ReputationBook
from repro_torch.market.settlement import SettlementLedger

__all__ = [
    "Catalog",
    "CatalogEntry",
    "TenantStore",
    "Marketplace",
    "MarketResult",
    "MarketSession",
    "Quote",
    "MarketPlanner",
    "ReputationBook",
    "SettlementLedger",
]
