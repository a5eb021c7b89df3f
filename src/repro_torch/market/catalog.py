"""Per-tenant sellable views over a ``TieredStore``.

A ``TenantStore`` wraps one tenant's store with the two things a market
needs that the store itself does not have: an **ask price** per entry and an
**access-control list**.  The priced ``Catalog`` it publishes is the
marketplace's quoting surface; the prefix trie already inside the store is
the match index (chain hashes ARE the catalog keys), so quoting a context is
one trie walk per seller — no separate index to keep fresh.

Pricing follows the production prompt-cache rule (SNIPPETS.md): the seller
paid a write premium (~1.25x a read) to create the entry, and amortizes it
over the sales it expects, plus its tier's per-GB egress fee with a margin.
``saved_per_use`` — the GPU dollars one reuse of this entry saves, stamped
at write-back time — is exactly the right base: the ask lands at
``write_premium / expected_sales`` of the buyer's recompute cost, so a full
match is always a good deal for the buyer while still repaying the seller's
storage investment.

ACL: entries default **public** (the marketplace premise); ``set_private``
removes one from the catalog entirely — a private entry can never be
matched, quoted, or fetched by another tenant (the invariant the hypothesis
suite drives).

This is the port of the reference's ``market/catalog.py`` over the port's
``TieredStore``.  An int8 entry's deliverable is dequantised where the
store's fetch would put it (the store's device), and its checksum is the
host form's, so a payload on the card and its host copy stamp the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Set, Tuple

from repro_torch.core.pricing import GB, Pricing
from repro_torch.kvcache import compression
from repro_torch.kvcache.faults import StorageError, payload_checksum
from repro_torch.kvcache.paged import artifact_length
from repro_torch.kvcache.store import StoredEntry


@dataclasses.dataclass(frozen=True)
class CatalogEntry:
    """One sellable entry: identity, size, and the seller's full-entry ask
    (pro-rated by matched fraction at quote time).  ``checksum`` is the
    payload checksum of the *decompressed* artifact — the form a buyer
    receives — stamped from the seller's own bytes at publication, so any
    in-flight tampering by a dishonest seller is detectable."""

    seller: str
    entry_id: str
    n_tokens: int
    nbytes: float
    tier: str
    ask_dollars: float
    checksum: str
    public: bool = True


@dataclasses.dataclass(frozen=True)
class Catalog:
    """A tenant's published price list (public, live entries only)."""

    seller: str
    entries: Tuple[CatalogEntry, ...]

    def __len__(self) -> int:
        return len(self.entries)

    def total_bytes(self) -> float:
        return sum(e.nbytes for e in self.entries)


class TenantStore:
    """One tenant's market-facing wrapper: ACL + pricing over its store.

    ``transfer`` (the tenant engine's ``TransferModel``, when bound through
    a ``MarketSession``) lets the marketplace attribute seller-side fetch
    fees to a ``market_sale`` activity, keeping the seller's own cost
    conservation exact.
    """

    def __init__(
        self,
        tenant: str,
        store,
        *,
        pricing: Optional[Pricing] = None,
        transfer=None,
        write_premium: float = 0.25,
        expected_sales: float = 4.0,
        margin: float = 0.10,
    ) -> None:
        self.tenant = tenant
        self.store = store
        self.pricing = pricing
        self.transfer = transfer
        # the premium share of the write the seller recovers per expected
        # sale (production caches price a cache write ~1.25x a read; the
        # 0.25x premium is what the ask must amortize)
        self.write_premium = write_premium
        self.expected_sales = max(expected_sales, 1.0)
        self.margin = margin
        self._private: Set[str] = set()
        # checksum of the decompressed artifact, cached per stored identity
        self._checksums: Dict[Tuple[str, bool], str] = {}
        self.revenue = 0.0  # settled credits (mirror of the ledger account)
        self.sales = 0

    # -- ACL ------------------------------------------------------------- #
    def set_private(self, entry_id: str) -> None:
        self._private.add(entry_id)

    def set_public(self, entry_id: str) -> None:
        self._private.discard(entry_id)

    def is_public(self, entry_id: str) -> bool:
        return entry_id not in self._private

    # -- pricing --------------------------------------------------------- #
    def ask_dollars(self, e: StoredEntry) -> float:
        """Full-entry ask: amortized write premium + egress fee with margin."""
        fee = 0.0
        if self.pricing is not None and e.tier in self.pricing.tiers:
            fee = self.pricing.tier(e.tier).per_gb_transfer_fee * e.nbytes / GB
        premium = self.write_premium * e.saved_per_use / self.expected_sales
        return (1.0 + self.margin) * fee + premium

    def checksum(self, entry_id: str) -> Optional[str]:
        """Publication-time checksum of the entry's deliverable (decompressed)
        payload, read without charging (``peek``)."""
        e = self.store.entries.get(entry_id)
        if e is None:
            return None
        key = (entry_id, e.compressed)
        got = self._checksums.get(key)
        if got is None:
            payload = self.store.backends[e.tier].peek(entry_id)
            if payload is None:
                return None
            if e.compressed:
                payload = compression.decompress_tree(payload, self.store.device)
            got = payload_checksum(payload)
            self._checksums[key] = got
        return got

    def stored_length(self, entry_id: str) -> Optional[int]:
        """Token count of the context the entry's artifact holds (its own
        ``pos``; ``n_tokens`` rounds it down to whole chunks), read without
        charging (``peek``); None when the entry or its payload is gone."""
        e = self.store.entries.get(entry_id)
        if e is None:
            return None
        try:
            payload = self.store.backends[e.tier].peek(entry_id)
        except StorageError:
            return None
        return None if payload is None else artifact_length(payload)

    # -- market surface -------------------------------------------------- #
    def catalog(self) -> Catalog:
        entries = []
        for e in self.store.entries.values():
            if not self.is_public(e.entry_id):
                continue
            cs = self.checksum(e.entry_id)
            if cs is None:
                continue
            entries.append(
                CatalogEntry(
                    seller=self.tenant,
                    entry_id=e.entry_id,
                    n_tokens=e.n_tokens,
                    nbytes=e.nbytes,
                    tier=e.tier,
                    ask_dollars=self.ask_dollars(e),
                    checksum=cs,
                )
            )
        return Catalog(seller=self.tenant, entries=tuple(entries))

    def match(self, tokens: Sequence[int]) -> Tuple[Any, Optional[StoredEntry]]:
        """ACL-filtered prefix match: a private entry is a miss to outsiders."""
        m, e = self.store.lookup(tokens)
        if e is not None and not self.is_public(e.entry_id):
            return m, None
        return m, e
