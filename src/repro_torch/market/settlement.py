"""Double-entry settlement for marketplace purchases.

``SettlementLedger`` extends the repo's exact cost ledger with a "market"
category and per-tenant accounts.  Every purchase writes BOTH sides:

    buyer account  -= price                      (debit, the quote price)
    seller account += price - fee                (credit, net of market fee)
    fees_collected += fee                        (the exchange's cut)

so the conservation law is structural:

    sum(accounts) + fees_collected == 0          (atol 1e-9)
    debits == credits + fees_collected

Ledger rows mirror the accounts: a "purchase" entry for the buyer's spend
and a negative "sale" entry for the seller's revenue, netting the category
to exactly the fees — the system-wide cost of running the market.  Dedup
credits (KVShare-style: a second tenant uploading identical content moved
zero bytes through ``SharedBackendCore``) are zero-dollar rows carrying the
saved byte counts, so "where did the bytes NOT go" stays answerable without
touching conservation.

Purchase dollars deliberately live here, NOT in any engine's own
``CostLedger``: engine conservation (compute/storage/transfer vs its
summary) must stay exact with the market on, so peer-to-peer flows settle
in their own book and the two books are reconciled by the bench gate.

This is the port of the reference's ``market/settlement.py`` over the
port's ``obs/ledger.py``: the same accounts, rows and conservation law.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs.ledger import CATEGORIES, CostLedger


class SettlementLedger(CostLedger):
    """Cost ledger + per-tenant market accounts with exact conservation."""

    CATEGORIES = CATEGORIES + ("market",)

    def __init__(self, *, fee_rate: float = 0.05, flat_fee: float = 0.0) -> None:
        super().__init__()
        self.fee_rate = fee_rate
        self.flat_fee = flat_fee
        self.accounts: Dict[str, float] = {}
        self.fees_collected = 0.0
        self.debits = 0.0
        self.credits = 0.0
        self.volume_bytes = 0.0
        self.dedup_bytes = 0.0
        self.n_purchases = 0
        self.n_dedup_credits = 0

    # -- quoting helper --------------------------------------------------- #
    def buyer_price(self, ask: float) -> float:
        """Buyer-facing price for a seller ask: the flat transaction fee is
        added on top, which is what makes tiny purchases uneconomical."""
        return ask + self.flat_fee

    def fee_for(self, price: float) -> float:
        """The exchange's cut of a buyer price: the flat fee plus a rate
        share of the remainder (the seller's ask portion)."""
        return self.flat_fee + self.fee_rate * max(0.0, price - self.flat_fee)

    # -- settlement -------------------------------------------------------- #
    def settle_purchase(
        self,
        *,
        buyer: str,
        seller: str,
        price: float,
        nbytes: float,
        entry_id: str,
        tier: Optional[str] = None,
        replica: int = 0,
        req_id: Optional[int] = None,
    ) -> float:
        """Debit the buyer, credit the seller net of fee.  Returns the
        seller's credit."""
        fee = self.fee_for(price)
        credit = price - fee
        self.accounts[buyer] = self.accounts.get(buyer, 0.0) - price
        self.accounts[seller] = self.accounts.get(seller, 0.0) + credit
        self.fees_collected += fee
        self.debits += price
        self.credits += credit
        self.volume_bytes += nbytes
        self.n_purchases += 1
        self.add(
            "market", "purchase", price, replica=replica, req_id=req_id,
            tier=tier, nbytes=nbytes, kind="buy",
        )
        self.add(
            "market", "sale", -credit, replica=replica, req_id=req_id,
            tier=tier, nbytes=nbytes, kind="sell",
        )
        return credit

    def record_dedup_credit(
        self, tenant: str, nbytes: float, *, replica: int = 0,
        req_id: Optional[int] = None,
    ) -> None:
        """KVShare dedup: the tenant's upload stored zero new bytes because
        an identical artifact already lives in the shared core.  Zero
        dollars move; the saved bytes are recorded."""
        self.dedup_bytes += nbytes
        self.n_dedup_credits += 1
        self.add(
            "market", "dedup_credit", 0.0, replica=replica, req_id=req_id,
            nbytes=nbytes,
        )

    # -- conservation ------------------------------------------------------ #
    def conservation_residual(self) -> float:
        return max(
            abs(sum(self.accounts.values()) + self.fees_collected),
            abs(self.debits - self.credits - self.fees_collected),
        )

    def assert_conserved(self, atol: float = 1e-9) -> float:
        r = self.conservation_residual()
        if not r <= atol:
            raise AssertionError(
                f"market settlement conservation violated (atol={atol}): "
                f"residual {r}; accounts={self.accounts}, "
                f"fees={self.fees_collected}"
            )
        return r

    def as_dict(self) -> dict:
        out = super().as_dict()
        out.update(
            accounts=dict(self.accounts),
            fees_collected=self.fees_collected,
            n_purchases=self.n_purchases,
            n_dedup_credits=self.n_dedup_credits,
            volume_bytes=self.volume_bytes,
            dedup_bytes=self.dedup_bytes,
            conservation_residual=self.conservation_residual(),
        )
        return out
