"""Seller reputation: price risk in, eject the corrupt.

Every verification outcome (checksum and/or deep spot-check,
``market.Marketplace``) updates the seller's score in [floor, 1.0].  The
score feeds quoting as a **risk multiplier** — ``1/score`` — so a seller
with a blemished record must be proportionally cheaper to win a quote, and
a seller caught serving corrupt payloads ``blacklist_after`` times is
ejected outright: ``Marketplace.quote`` skips blacklisted sellers entirely,
which is the "never matched again" invariant the hypothesis suite drives.

This is the port of the reference's ``market/reputation.py``: plain Python,
the same scores, blacklists and arithmetic.
"""
from __future__ import annotations

from typing import Dict, Set


class ReputationBook:
    def __init__(
        self,
        *,
        decay: float = 0.5,
        recover: float = 0.10,
        floor: float = 0.25,
        blacklist_after: int = 1,
    ) -> None:
        self.decay = decay
        self.recover = recover
        self.floor = floor
        self.blacklist_after = max(1, blacklist_after)
        self.scores: Dict[str, float] = {}
        self.corrupt: Dict[str, int] = {}
        self.sales: Dict[str, int] = {}
        self.blacklisted: Set[str] = set()

    def score(self, seller: str) -> float:
        return self.scores.get(seller, 1.0)

    def is_blacklisted(self, seller: str) -> bool:
        return seller in self.blacklisted

    def price_multiplier(self, seller: str) -> float:
        """Risk-adjusted quote multiplier: a seller at half trust must be
        half price to compete."""
        return 1.0 / max(self.score(seller), self.floor)

    def record_sale(self, seller: str) -> None:
        self.sales[seller] = self.sales.get(seller, 0) + 1

    def record_verification(self, seller: str, ok: bool) -> bool:
        """Update the book with one verification outcome.  Returns True iff
        this outcome NEWLY blacklisted the seller (the caller emits the
        ``SellerBlacklisted`` event exactly once)."""
        s = self.score(seller)
        if ok:
            self.scores[seller] = s + self.recover * (1.0 - s)
            return False
        self.corrupt[seller] = self.corrupt.get(seller, 0) + 1
        self.scores[seller] = max(self.floor, s * self.decay)
        if (
            self.corrupt[seller] >= self.blacklist_after
            and seller not in self.blacklisted
        ):
            self.blacklisted.add(seller)
            return True
        return False

    def as_dict(self) -> dict:
        return {
            "scores": dict(self.scores),
            "corrupt": dict(self.corrupt),
            "sales": dict(self.sales),
            "blacklisted": sorted(self.blacklisted),
        }
