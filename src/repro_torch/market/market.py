"""The exchange: quoting, delivery, verification, settlement.

``Marketplace`` holds the tenant registry, the ``SettlementLedger``, the
``ReputationBook``, and the adversary hooks.  One purchase runs:

    quote   — walk every non-blacklisted peer's trie for the buyer's
              context (ACL-filtered), price the best match (seller ask
              pro-rated by matched fraction, times the seller's risk
              multiplier, plus the flat transaction fee), and fold seller
              link contention + RPC latency into the load estimate;
    deliver — fetch from the SELLER's store (fees attributed to its
              transfer model as a ``market_sale``), then give any armed
              adversary its chance to tamper with the bytes in flight —
              the dishonest-seller model: the seller's stored copy stays
              intact, the DELIVERY lies;
    verify  — checksum against the publication-time stamp ALWAYS, plus a
              probabilistic deep spot-check: the buyer's engine recomputes
              a prefix sample and compares the purchased KV within its model
              dtype's tolerance (``ServingEngine.market_spot_check``).  A
              failed verification
              means the payload is NEVER served: the seller is priced down
              or blacklisted and the request degrades to exact recompute;
    settle  — debit buyer, credit seller minus fee, conservation at 1e-9.

Determinism: the deep-verify draw hashes (seed, buyer, seller, entry,
purchase ordinal) — same run, same checks — and the first purchase from any
seller is always deep-checked, so a corrupt seller cannot survive even a
checksum collision fantasy.

This is the port of the reference's ``market/market.py``: the same quotes,
verification draws, settlement and events.  A delivery is whatever the
seller's store fetch returns (host arrays, or for an int8 entry rows
dequantised on the store's device); the buyer reads it and never writes
into it, and a dishonest delivery is a tampered copy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kvcache import compression
from repro_torch.kvcache.faults import FaultInjector, StorageError, payload_checksum
from repro_torch.market.catalog import TenantStore
from repro_torch.market.reputation import ReputationBook
from repro_torch.market.settlement import SettlementLedger
from repro_torch.serving.events import KVPurchased, SellerBlacklisted, SellerVerified


@dataclasses.dataclass(frozen=True)
class Quote:
    """One seller's priced offer for a buyer's context prefix."""

    buyer: str
    seller: str
    entry_id: str
    tier: str  # seller-side tier the bytes would come from
    matched_tokens: int  # buyer-context tokens the entry's prefix covers
    n_tokens: int  # tokens the full entry covers
    nbytes: float  # bytes billed (pro-rated by matched fraction)
    price: float  # buyer spend: ask x fraction x risk multiplier + flat fee
    est_load_s: float  # seller link delay + queue wait + RPC round trip
    checksum: str  # publication-time stamp of the deliverable payload


@dataclasses.dataclass
class MarketResult:
    """Outcome of executing a quote."""

    ok: bool
    artifact: Any = None
    delay_s: float = 0.0  # delivery delay charged to the buyer's request
    nbytes: float = 0.0
    matched_tokens: int = 0
    price: float = 0.0
    verify_s: float = 0.0  # spot-check GPU seconds (buyer-side)
    verify_cost: float = 0.0  # spot-check GPU dollars (buyer-side)
    wasted_s: float = 0.0  # burned delay when the purchase failed
    reason: str = ""
    events: List[Any] = dataclasses.field(default_factory=list)


def _flippable(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() > 0
    return hasattr(leaf, "dtype") and getattr(leaf, "size", 0) > 0


def _flipped(leaf: Any) -> Any:
    """A copy of ``leaf`` with its first byte inverted, on the leaf's own
    device (a bf16 tensor through a ``uint8`` view of the copy)."""
    if isinstance(leaf, torch.Tensor):
        out = leaf.detach().clone().contiguous()
        raw = out.reshape(-1).view(torch.uint8)
        raw[0] = raw[0] ^ 0xFF
        return out
    out = np.array(leaf, copy=True, order="C")
    raw = out.reshape(-1).view(np.uint8)
    raw[0] ^= 0xFF
    return out


def _tamper(payload: Any) -> Any:
    """Flip one byte of the first array leaf — a dishonest delivery.  The
    seller's stored artifact is untouched (copies, never mutation), and the
    damage is guaranteed visible to the checksum, whatever the dtype.  The
    leaves are taken in ``jax.tree_util``'s order
    (``compression.tree_leaves``), as the reference takes them."""
    target = next((x for x in compression.tree_leaves(payload) if _flippable(x)), None)
    return compression.tree_map(lambda x: _flipped(x) if x is target else x, payload)


class MarketSession:
    """One tenant's handle on the marketplace.  ``bind_engine`` (called by
    the engine when constructed with ``market=``) publishes the engine's
    store as this tenant's ``TenantStore`` and keeps the engine for the
    deep-verify oracle."""

    def __init__(self, marketplace: "Marketplace", tenant: str) -> None:
        self.marketplace = marketplace
        self.tenant = tenant
        self.engine = None
        self.tenant_store: Optional[TenantStore] = None

    def bind_engine(self, engine) -> None:
        self.engine = engine
        self.tenant_store = TenantStore(
            self.tenant, engine.store, pricing=engine.pricing,
            transfer=engine.transfer,
        )
        self.marketplace.register(self.tenant, self.tenant_store, session=self)

    def quote(self, tokens: Sequence[int]) -> Optional[Quote]:
        return self.marketplace.quote(self.tenant, tokens)

    def execute(
        self, quote: Quote, *, req_id: int, now: float,
        context_tokens: Sequence[int] = (), replica: int = 0,
    ) -> MarketResult:
        return self.marketplace.execute(
            quote, req_id=req_id, now=now, context_tokens=context_tokens,
            replica=replica,
        )

    def note_dedup(self, nbytes: float, *, req_id: Optional[int] = None,
                   replica: int = 0) -> None:
        self.marketplace.settlement.record_dedup_credit(
            self.tenant, nbytes, req_id=req_id, replica=replica,
        )


class Marketplace:
    def __init__(
        self,
        *,
        fee_rate: float = 0.05,
        flat_fee: float = 0.0,
        rtt_s: float = 2e-4,
        verify_rate: float = 0.25,
        verify_sample_tokens: int = 16,
        seed: int = 0,
        blacklist_after: int = 1,
    ) -> None:
        self.rtt_s = rtt_s
        self.verify_rate = verify_rate
        self.verify_sample_tokens = verify_sample_tokens
        self.seed = seed
        self.tenants: Dict[str, TenantStore] = {}
        self.sessions: Dict[str, MarketSession] = {}
        self.settlement = SettlementLedger(fee_rate=fee_rate, flat_fee=flat_fee)
        self.reputation = ReputationBook(blacklist_after=blacklist_after)
        self._adversaries: Dict[str, FaultInjector] = {}
        self._pair_purchases: Dict[Tuple[str, str], int] = {}
        self.quotes_served = 0
        self.purchases = 0
        self.corrupt_blocked = 0  # tampered payloads caught by verification
        self.corrupt_served = 0  # must stay 0: the acceptance invariant
        self.failed_purchases = 0

    # -- membership -------------------------------------------------------- #
    def join(self, tenant: str) -> MarketSession:
        s = self.sessions.get(tenant)
        if s is None:
            s = self.sessions[tenant] = MarketSession(self, tenant)
        return s

    def register(
        self, tenant: str, store: TenantStore,
        *, session: Optional[MarketSession] = None,
    ) -> None:
        self.tenants[tenant] = store
        if session is not None:
            self.sessions[tenant] = session

    def arm_adversary(self, tenant: str, injector: FaultInjector) -> None:
        """Make ``tenant`` a dishonest seller: its deliveries pass through
        the injector's corruption draw (``faults.FaultInjector``) from now
        on.  Its stored bytes stay intact — only what it SHIPS lies."""
        self._adversaries[tenant] = injector

    # -- quoting ----------------------------------------------------------- #
    def quote(self, buyer: str, tokens: Sequence[int]) -> Optional[Quote]:
        """Best offer across peers for the buyer's context: longest match
        first, then cheapest."""
        best: Optional[Quote] = None
        for name, ts in self.tenants.items():
            if name == buyer or self.reputation.is_blacklisted(name):
                continue
            m, e = ts.match(tokens)
            if e is None:
                continue
            matched = min(m.matched_tokens, len(tokens))
            if matched <= 0:
                continue
            frac = min(1.0, matched / max(e.n_tokens, 1))
            nbytes = e.nbytes * frac
            cs = ts.checksum(e.entry_id)
            if cs is None:
                continue
            price = self.settlement.buyer_price(
                ts.ask_dollars(e) * frac * self.reputation.price_multiplier(name)
            )
            est = (
                ts.store.estimate_load_delay(e.tier, nbytes)
                + ts.store.estimated_queue_wait(e.tier, nbytes)
                + self.rtt_s
            )
            q = Quote(
                buyer=buyer, seller=name, entry_id=e.entry_id, tier=e.tier,
                matched_tokens=matched, n_tokens=e.n_tokens, nbytes=nbytes,
                price=price, est_load_s=est, checksum=cs,
            )
            if (
                best is None
                or q.matched_tokens > best.matched_tokens
                or (q.matched_tokens == best.matched_tokens and q.price < best.price)
            ):
                best = q
        if best is not None:
            self.quotes_served += 1
        return best

    # -- execution --------------------------------------------------------- #
    def _deep_verify_due(self, quote: Quote) -> bool:
        n = self._pair_purchases.get((quote.buyer, quote.seller), 0)
        if n == 0:
            return True  # first trade with this seller: always spot-check
        h = hashlib.blake2b(
            f"{self.seed}|{quote.buyer}|{quote.seller}|{quote.entry_id}|{n}".encode(),
            digest_size=8,
        ).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64 < self.verify_rate

    def execute(
        self,
        quote: Quote,
        *,
        req_id: int,
        now: float,
        context_tokens: Sequence[int] = (),
        replica: int = 0,
    ) -> MarketResult:
        seller = self.tenants.get(quote.seller)
        if seller is None or self.reputation.is_blacklisted(quote.seller):
            self.failed_purchases += 1
            return MarketResult(ok=False, reason="seller_gone")
        if quote.entry_id not in seller.store.entries:
            self.failed_purchases += 1
            return MarketResult(ok=False, reason="evicted")

        frac = min(1.0, quote.matched_tokens / max(quote.n_tokens, 1))
        attr = (
            seller.transfer.attributed(activity="market_sale")
            if seller.transfer is not None
            else contextlib.nullcontext()
        )
        try:
            with attr:
                payload, delay_s = seller.store.fetch(quote.entry_id, fraction=frac)
        except StorageError as err:
            self.failed_purchases += 1
            return MarketResult(
                ok=False, reason=f"seller_fetch:{err.reason}",
                wasted_s=getattr(err, "delay_s", 0.0),
            )

        inj = self._adversaries.get(quote.seller)
        if inj is not None and inj.should_corrupt("market", quote.entry_id):
            payload = _tamper(payload)

        # -- verification: checksum always, deep spot-check probabilistically
        ok = payload_checksum(payload) == quote.checksum
        deep = False
        verify_s = verify_cost = 0.0
        buyer_session = self.sessions.get(quote.buyer)
        engine = buyer_session.engine if buyer_session is not None else None
        if ok and engine is not None and self._deep_verify_due(quote):
            deep = True
            sample = min(self.verify_sample_tokens, quote.matched_tokens)
            ok, verify_s, verify_cost = engine.market_spot_check(
                tuple(context_tokens)[:quote.matched_tokens], payload, sample,
            )
        self._pair_purchases[(quote.buyer, quote.seller)] = (
            self._pair_purchases.get((quote.buyer, quote.seller), 0) + 1
        )

        events: List[Any] = [
            SellerVerified(
                t_s=now, req_id=req_id, seller=quote.seller,
                entry_id=quote.entry_id, ok=ok, deep=deep,
            )
        ]
        if not ok:
            # corrupt delivery caught BEFORE serving: no settlement, the
            # seller pays in reputation, the buyer degrades to recompute
            self.corrupt_blocked += 1
            self.failed_purchases += 1
            if self.reputation.record_verification(quote.seller, ok=False):
                events.append(
                    SellerBlacklisted(
                        t_s=now, req_id=req_id, seller=quote.seller,
                        corrupt_count=self.reputation.corrupt[quote.seller],
                    )
                )
            return MarketResult(
                ok=False, reason="verify_failed", wasted_s=delay_s + verify_s,
                verify_s=verify_s, verify_cost=verify_cost, events=events,
            )

        self.reputation.record_verification(quote.seller, ok=True)
        self.reputation.record_sale(quote.seller)
        credit = self.settlement.settle_purchase(
            buyer=quote.buyer, seller=quote.seller, price=quote.price,
            nbytes=quote.nbytes, entry_id=quote.entry_id, tier=quote.tier,
            replica=replica, req_id=req_id,
        )
        seller.revenue += credit
        seller.sales += 1
        self.purchases += 1
        events.insert(
            0,
            KVPurchased(
                t_s=now, req_id=req_id, seller=quote.seller, buyer=quote.buyer,
                entry_id=quote.entry_id, tier=quote.tier, nbytes=quote.nbytes,
                price=quote.price, matched_tokens=quote.matched_tokens,
            ),
        )
        return MarketResult(
            ok=True, artifact=payload, delay_s=delay_s + self.rtt_s,
            nbytes=quote.nbytes, matched_tokens=quote.matched_tokens,
            price=quote.price, verify_s=verify_s, verify_cost=verify_cost,
            events=events,
        )

    # -- reporting --------------------------------------------------------- #
    def stats(self) -> dict:
        return {
            "tenants": sorted(self.tenants),
            "quotes_served": self.quotes_served,
            "purchases": self.purchases,
            "corrupt_blocked": self.corrupt_blocked,
            "corrupt_served": self.corrupt_served,
            "failed_purchases": self.failed_purchases,
            "settlement": self.settlement.as_dict(),
            "reputation": self.reputation.as_dict(),
        }
