"""Simulated-time transfer accounting over real data movement.

The serving engine moves *real tensors* (host numpy <-> device) between the
store and the model while charging *modeled time* from the analytical
PerfModel, so its times and dollars do not depend on the machine it runs
on.  All
delay/cost numbers the serving engine reports flow through this module, so
the modeling surface is one screen of code.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.pricing import GB, Pricing


@dataclasses.dataclass(frozen=True)
class TransferHandle:
    """One modeled byte movement against a storage tier.

    ``issued_at_s``/``completes_at_s`` are SimClock times; the transfer is
    logically in flight during that window (the data itself moves eagerly —
    this container has no storage fabric, so only time is simulated).
    """

    key: str
    tier: str
    kind: str  # "load" | "store"
    nbytes: float
    delay_s: float
    issued_at_s: float
    # time spent waiting for a free slot on a concurrency-limited link
    # (``hierarchy.ConcurrencyLimitedBackend``); included in ``delay_s``.
    queue_s: float = 0.0
    # True when a content-addressed shared tier already held identical bytes
    # (``hierarchy.SharedTierBackend``): no upload happened, so nbytes/delay
    # are zero and no fee accrues.
    dedup: bool = False

    @property
    def completes_at_s(self) -> float:
        return self.issued_at_s + self.delay_s


class SimClock:
    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance(self, dt: float) -> float:
        assert dt >= 0, dt
        self.now += dt
        return self.now

    def at_least(self, t: float) -> float:
        self.now = max(self.now, t)
        return self.now


@dataclasses.dataclass
class TransferStats:
    loaded_bytes: float = 0.0
    stored_bytes: float = 0.0
    load_events: int = 0
    store_events: int = 0
    load_time_s: float = 0.0
    store_time_s: float = 0.0


class TransferModel:
    """Load/store delay + $ accounting for each storage tier.

    With a cost ledger bound (``bind_ledger``; telemetry only — None by
    default and zero-overhead then), every CHARGED movement also writes one
    attributed fee entry: per-event fees sum to ``transfer_fees()`` within
    float re-association, which is the transfer leg of the ledger's
    conservation law (``obs/ledger.py``).  Attribution context (activity /
    req_id) is a dynamic scope the engine brackets operations with::

        with transfer.attributed(activity="fetch", req_id=7):
            store.fetch(...)   # any charge inside lands on request 7
    """

    def __init__(self, perf: PerfModel, pricing: Pricing):
        self.perf = perf
        self.pricing = pricing
        self.stats: Dict[str, TransferStats] = {}
        self.ledger = None  # obs.CostLedger when telemetry is on
        self._replica = 0
        self._ctx: Dict[str, object] = {}

    def bind_ledger(self, ledger, *, replica: int = 0) -> None:
        self.ledger = ledger
        self._replica = replica

    @contextlib.contextmanager
    def attributed(self, *, activity: str, req_id: Optional[int] = None):
        old = self._ctx
        self._ctx = {"activity": activity, "req_id": req_id}
        try:
            yield
        finally:
            self._ctx = old

    def _charge(self, tier_name: str, kind: str, nbytes: float) -> None:
        fee = self.pricing.tier(tier_name).per_gb_transfer_fee * nbytes / GB
        self.ledger.record_transfer(
            tier_name, kind, nbytes, fee,
            activity=str(self._ctx.get("activity", "other")),
            replica=self._replica,
            req_id=self._ctx.get("req_id"),
        )

    def _tier_stats(self, tier: str) -> TransferStats:
        return self.stats.setdefault(tier, TransferStats())

    def load_delay(self, nbytes: float, tier_name: str) -> float:
        t = self.perf.kv_load_time(nbytes, self.pricing.tier(tier_name))
        s = self._tier_stats(tier_name)
        s.loaded_bytes += nbytes
        s.load_events += 1
        s.load_time_s += t
        if self.ledger is not None:
            self._charge(tier_name, "load", nbytes)
        return t

    def store_delay(self, nbytes: float, tier_name: str) -> float:
        t = self.perf.kv_store_time(nbytes, self.pricing.tier(tier_name))
        s = self._tier_stats(tier_name)
        s.stored_bytes += nbytes
        s.store_events += 1
        s.store_time_s += t
        if self.ledger is not None:
            self._charge(tier_name, "store", nbytes)
        return t

    def estimate_load_delay(self, nbytes: float, tier_name: str) -> float:
        """Pure delay estimate — no bytes charged to the link stats (used by
        prefetch planning and economics-at-scale overrides)."""
        return self.perf.kv_load_time(nbytes, self.pricing.tier(tier_name))

    def transfer_fees(self) -> float:
        total = 0.0
        for name, s in self.stats.items():
            tier = self.pricing.tier(name)
            total += tier.per_gb_transfer_fee * (s.loaded_bytes + s.stored_bytes) / GB
        return total
