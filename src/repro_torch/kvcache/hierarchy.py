"""Tiered KV storage hierarchy: capacity-bounded tiers, contended links, and
economics-driven migration.

The paper's central claim is that reuse economics hinge on *where* a KV cache
sits — compute vs. storage vs. network pricing across device/host/disk/object
tiers.  This module turns the flat two-backend store into an ordered
hierarchy:

    host_dram  ->  local_nvme  ->  io2 / gp3  ->  s3 / peer_dram
    (fastest, most expensive $/GB-hour)    (slowest, cheapest)

Pieces:

  * ``TierSpec``                  — declarative tier: capacity, link
    concurrency limit, backend kind.
  * ``DiskSpillBackend``          — local-NVMe tier whose payloads actually
    leave process memory (pickled to files); delays via the TransferModel.
  * ``RpcBackend``                — modeled remote peer (the "Can I Buy Your
    KV Cache?" setting): peer-DRAM pricing plus per-call RPC round trips.
  * ``ConcurrencyLimitedBackend`` — wraps any backend with a k-server link:
    bursty loads accrue queueing delay on their ``TransferHandle``s
    (``queue_s``) instead of fetching for free in parallel.
  * ``TieredStore``               — the store itself: content-addressed trie,
    per-tier byte/GB-hour accounting, cost-aware eviction, **pinning** (an
    in-flight prefetch cannot be evicted or demoted), spill-on-pressure, and
    a clock-driven migration pass.
  * ``BreakEvenMigrator``         — promotion/demotion policy from the
    paper's break-even math: an entry belongs in the tier minimizing
    ``hold $/h + reuse_freq x (GPU-idle $ per fetch + per-GB fees)``.
  * ``TierMigration``             — typed record of one migration, consumed
    by the serving engine's ``TierMigrated`` event.

``kvcache.store.ContextStore`` is a thin backward-compatible wrapper over
``TieredStore``; with a single-tier hierarchy, no concurrency limits, and no
migration policy the two are behaviorally identical (golden-parity tested).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import math
import os
import pathlib
import pickle
import shutil
import tempfile
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pricing import GB, Pricing
from repro_torch.kvcache import compression
from repro_torch.kvcache.backend import (
    HostMemoryBackend,
    ObjectStoreBackend,
    StorageBackend,
    _MemoryBackend,
)
from repro_torch.kvcache.faults import (
    CorruptPayload,
    FaultInjector,
    KeyNotFound,
    StorageError,
    payload_checksum,
)
from repro_torch.kvcache.chunks import ChunkTrie, PrefixMatch
from repro_torch.kvcache.fusion import ChunkIndex, CompositeMatch
from repro_torch.kvcache.transfer import SimClock, TransferHandle, TransferModel

# Storage rate assumed by eviction/migration scoring when no Pricing is
# plumbed in (io2's ~$0.125/GB-month); callers with real catalogs pass
# ``pricing=``.
_FALLBACK_GB_HOUR_RATE = 1.7e-4


# --------------------------------------------------------------------------- #
# Tier declaration
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One level of the hierarchy, fastest-first in the store's tier list."""

    name: str
    capacity_gb: float
    # Max simultaneous transfers on this tier's link; None = uncontended.
    concurrency: Optional[int] = None
    # Backend kind override: "host" | "disk" | "rpc" | "object".
    # Default is inferred from the tier name.
    backend: Optional[str] = None


def _default_kind(name: str) -> str:
    if name == "host_dram":
        return "host"
    if name == "local_nvme":
        return "disk"
    if name.startswith(("peer", "rpc")):
        return "rpc"
    return "object"


# --------------------------------------------------------------------------- #
# New backends
# --------------------------------------------------------------------------- #
class DiskSpillBackend(_MemoryBackend):
    """Local-NVMe spill tier: payloads genuinely leave process memory
    (pickled to files under ``root``); transfer delays are modeled from the
    ``local_nvme`` pricing tier like any other backend."""

    hedgeable = False  # local device: no straggler tail to hedge

    def __init__(self, name: str = "local_nvme", *, root=None, **kw):
        super().__init__(name, **kw)
        if root is not None:
            self.root = pathlib.Path(root)
            self.root.mkdir(parents=True, exist_ok=True)
        else:
            # we own the default spill dir: reclaim it when the backend dies
            self.root = pathlib.Path(tempfile.mkdtemp(prefix=f"kvspill-{name}-"))
            weakref.finalize(self, shutil.rmtree, str(self.root), True)
        self._nbytes: Dict[str, float] = {}

    def _path(self, key: str) -> pathlib.Path:
        return self.root / (hashlib.sha1(key.encode()).hexdigest() + ".pkl")

    # -- storage primitives --------------------------------------------- #
    def _write(self, key: str, payload: Any, nbytes: float) -> None:
        # atomic spill (same temp-file + rename discipline as
        # training/checkpoint.py): a crash mid-write can leave a stray temp
        # file but never a torn payload under the final name.  The record
        # embeds the content checksum put() stamped so a later process (or a
        # corrupted-at-rest file) is caught on load, not served.
        path = self._path(key)
        record = {"payload": payload, "checksum": self._checksums.get(key)}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(record, f)
            os.replace(tmp, path)
        except BaseException:
            pathlib.Path(tmp).unlink(missing_ok=True)
            raise
        self._nbytes[key] = nbytes

    def _read(self, key: str) -> Tuple[Any, float]:
        if key not in self._nbytes:
            raise KeyNotFound(
                f"{type(self).__name__} tier {self.name!r} has no payload "
                f"under key {key!r}",
                tier=self.name, key=key, reason="not_found",
            )
        try:
            with open(self._path(key), "rb") as f:
                record = pickle.load(f)
        except FileNotFoundError:
            raise KeyNotFound(
                f"{type(self).__name__} tier {self.name!r} lost the spill "
                f"file for key {key!r}",
                tier=self.name, key=key, reason="not_found",
            ) from None
        except (pickle.UnpicklingError, EOFError, OSError) as e:
            raise CorruptPayload(
                f"tier {self.name!r} spill file for {key!r} is unreadable "
                f"({e}): torn or corrupted at rest",
                tier=self.name, key=key, reason="corrupt_at_rest",
                at_rest=True,
            ) from None
        payload, want = record["payload"], record.get("checksum")
        if want is not None and payload_checksum(payload) != want:
            raise CorruptPayload(
                f"tier {self.name!r} spill file for {key!r} fails its "
                f"embedded checksum: corrupted at rest",
                tier=self.name, key=key, reason="corrupt_at_rest",
                at_rest=True,
            )
        return payload, self._nbytes[key]

    def _drop(self, key: str) -> bool:
        if self._nbytes.pop(key, None) is None:
            return False
        self._path(key).unlink(missing_ok=True)
        return True

    def _has(self, key: str) -> bool:
        return key in self._nbytes

    def clear(self) -> None:
        for key in list(self._nbytes):
            self._drop(key)


class RpcBackend(_MemoryBackend):
    """Modeled remote-peer tier (a sibling serving instance selling its KV
    cache): bytes priced/timed as ``peer_dram`` through the shared
    TransferModel, plus a fixed RPC round trip per call.  Remote reads have a
    straggler tail, so hedging applies."""

    hedgeable = True

    def __init__(self, name: str = "peer_dram", *, rtt_s: float = 2e-4, **kw):
        super().__init__(name, **kw)
        self.rtt_s = rtt_s
        self.link_overhead_s = rtt_s


class ConcurrencyLimitedBackend:
    """k-server link in front of any backend: at most ``limit`` transfers are
    in flight at once; excess transfers wait for the earliest free slot, and
    the wait is carried on the handle (``queue_s``, included in ``delay_s``).

    Reservations are keyed to the shared SimClock, so a burst of fetches
    issued at the same instant queue behind each other — the "fetching for
    free in parallel" failure mode of the uncontended model."""

    def __init__(self, inner: StorageBackend, limit: int, *, clock: Optional[SimClock] = None):
        assert limit >= 1, limit
        self.inner = inner
        self.limit = int(limit)
        self.clock = clock or inner.clock
        self._busy_until: List[float] = []  # min-heap of in-flight completions

    # -- queueing ------------------------------------------------------- #
    def _prune(self, now: float) -> None:
        while self._busy_until and self._busy_until[0] <= now:
            heapq.heappop(self._busy_until)

    def _wait(self, now: float, heap: Optional[List[float]] = None) -> float:
        """Wait until a server frees (0 if one is free now).  ``heap`` — an
        alternative busy-until heap to evaluate against (a simulated copy for
        planning); defaults to, and prunes, the live link state."""
        if heap is None:
            self._prune(now)
            heap = self._busy_until
        if len(heap) < self.limit:
            return 0.0
        k = len(heap) - self.limit + 1
        return max(0.0, heapq.nsmallest(k, heap)[-1] - now)

    def _reserve(self, service_s: float) -> float:
        now = self.clock.now
        wait = self._wait(now)
        heapq.heappush(self._busy_until, now + wait + service_s)
        return wait

    def estimated_wait(self, nbytes: float, pending: Sequence[float] = ()) -> float:
        """Predicted queueing delay for a fetch issued now (no reservation) —
        the planning/economics surface.  ``pending`` lists byte sizes of
        fetches that will hit this link at the same instant AHEAD of this one
        (earlier members of an admission batch): their reservations are
        simulated on a copy of the link state so batch-mates see each other's
        queueing at plan time, not just transfers already in flight."""
        now = self.clock.now
        if not pending:
            return self._wait(now)
        self._prune(now)
        heap = list(self._busy_until)  # already heap-ordered; real state untouched
        for nb in pending:
            w = self._wait(now, heap)
            heapq.heappush(heap, now + w + self.inner.estimate_load_delay(nb))
        return self._wait(now, heap)

    def in_flight(self) -> int:
        self._prune(self.clock.now)
        return len(self._busy_until)

    # -- StorageBackend protocol (delegate + queue) ---------------------- #
    @property
    def name(self) -> str:
        return self.inner.name

    def put(self, key, payload, nbytes, *, charge: bool = True, **kw):
        h = self.inner.put(key, payload, nbytes, charge=charge, **kw)
        wait = self._reserve(h.delay_s)
        if wait == 0.0:
            return h
        return dataclasses.replace(h, delay_s=h.delay_s + wait, queue_s=wait)

    def get(self, key, *, nbytes=None, charge: bool = True):
        payload, h = self.inner.get(key, nbytes=nbytes, charge=charge)
        wait = self._reserve(h.delay_s)
        if wait == 0.0:
            return payload, h
        return payload, dataclasses.replace(h, delay_s=h.delay_s + wait, queue_s=wait)

    def delete(self, key) -> bool:
        return self.inner.delete(key)

    def contains(self, key) -> bool:
        return self.inner.contains(key)

    def peek(self, key):
        return self.inner.peek(key)

    def estimate_load_delay(self, nbytes: float) -> float:
        return self.inner.estimate_load_delay(nbytes)

    def __getattr__(self, attr):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(attr)
        return getattr(inner, attr)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ConcurrencyLimited({self.inner!r}, limit={self.limit})"


class SharedBackendCore:
    """Content-addressed payload pool behind a tier SHARED by several stores
    (the cluster's cold tier: every replica's s3 backend is a view onto one
    of these).  Ownership is refcounted per content id: each namespaced key
    (one replica's entry) holds one reference, and the payload bytes die only
    when the last reference drops — so one replica evicting (or crashing out
    of the cluster) can never orphan an entry another replica still holds.

    Identical content written by two replicas is stored ONCE: the second
    write is a dedup hit (no bytes move, no fee).  Capacity/GB-hour
    accounting stays per-store (each owner is billed for its logical bytes);
    the cluster-level dedup saving is surfaced via ``stats()`` rather than
    silently altering any store's bill."""

    def __init__(self):
        # content id -> (payload, nbytes); one copy per distinct content
        self._contents: Dict[str, Tuple[Any, float]] = {}
        self._refs: Dict[str, int] = {}
        # namespaced key (one store's entry) -> content id it references
        self._keys: Dict[str, str] = {}
        self.dedup_hits = 0

    def write(self, key: str, cid: str, payload: Any, nbytes: float) -> bool:
        """Bind ``key`` to content ``cid``.  Returns True when the bytes were
        already resident (dedup: the caller's upload is a no-op)."""
        old = self._keys.get(key)
        if old is not None:
            self._release(old)
        dedup = cid in self._contents
        if dedup:
            self.dedup_hits += 1
        else:
            self._contents[cid] = (payload, nbytes)
        self._keys[key] = cid
        self._refs[cid] = self._refs.get(cid, 0) + 1
        return dedup

    def read(self, key: str) -> Tuple[Any, float]:
        return self._contents[self._keys[key]]

    def has(self, key: str) -> bool:
        return key in self._keys

    def drop(self, key: str) -> bool:
        cid = self._keys.pop(key, None)
        if cid is None:
            return False
        self._release(cid)
        return True

    def _release(self, cid: str) -> None:
        n = self._refs.get(cid, 0) - 1
        if n <= 0:
            self._refs.pop(cid, None)
            self._contents.pop(cid, None)
        else:
            self._refs[cid] = n

    def drop_namespace(self, prefix: str) -> int:
        """Release every key under ``prefix`` (a replica leaving the
        cluster); shared payloads survive while other replicas hold them."""
        victims = [k for k in self._keys if k.startswith(prefix)]
        for k in victims:
            self.drop(k)
        return len(victims)

    def stats(self) -> Dict[str, float]:
        resident = sum(nb for _, nb in self._contents.values())
        logical = sum(self._contents[c][1] for c in self._keys.values())
        return {
            "n_contents": len(self._contents),
            "n_keys": len(self._keys),
            "resident_bytes": resident,
            "logical_bytes": logical,
            "dedup_saved_bytes": logical - resident,
            "dedup_hits": self.dedup_hits,
        }


class SharedTierBackend(ObjectStoreBackend):
    """One store's view onto a :class:`SharedBackendCore`: keys are
    namespaced per owner (``r0:ctx3``), transfer delays/fees bill through the
    OWNER's TransferModel/clock, and writes whose content already sits in the
    core complete instantly with a ``dedup`` handle (the bytes never move).
    ``TieredStore`` passes each entry's token-content id via ``put``'s
    ``content=`` kwarg when the backend advertises ``content_addressed``."""

    content_addressed = True

    def __init__(self, name: str = "s3", *, core: SharedBackendCore,
                 namespace: str = "", **kw):
        super().__init__(name, **kw)
        self.core = core
        self.namespace = namespace

    def _key(self, key: str) -> str:
        return f"{self.namespace}:{key}" if self.namespace else key

    def put(self, key, payload, nbytes, *, charge: bool = True,
            content: Optional[str] = None):
        if nbytes < 0:
            raise ValueError(
                f"nbytes must be >= 0, got {nbytes!r} "
                f"(tier {self.name!r}, key {key!r})"
            )
        self._check_brownout(key)
        # same stamp-before-write contract as _MemoryBackend.put (this
        # override bypasses it); identical content hashes identically, so
        # dedup'd writes agree on the stamp
        self._checksums[key] = payload_checksum(payload)
        cid = content if content is not None else self._key(key)
        if self.core.write(self._key(key), cid, payload, nbytes):
            # identical bytes already resident service-wide: free write
            return TransferHandle(
                key=key, tier=self.name, kind="store", nbytes=0.0,
                delay_s=0.0, issued_at_s=self.clock.now, dedup=True,
            )
        delay = 0.0
        if self.transfer is not None and charge:
            delay = self.transfer.store_delay(nbytes, self.name) + self.link_overhead_s
        return TransferHandle(
            key=key, tier=self.name, kind="store", nbytes=nbytes,
            delay_s=delay, issued_at_s=self.clock.now,
        )

    # -- storage primitives route through the shared core ---------------- #
    def _write(self, key: str, payload: Any, nbytes: float) -> None:
        self.core.write(self._key(key), self._key(key), payload, nbytes)

    def _read(self, key: str) -> Tuple[Any, float]:
        try:
            return self.core.read(self._key(key))
        except KeyError:
            raise KeyNotFound(
                f"{type(self).__name__} tier {self.name!r} has no payload "
                f"under key {key!r}",
                tier=self.name, key=key, reason="not_found",
            ) from None

    def _drop(self, key: str) -> bool:
        return self.core.drop(self._key(key))

    def _has(self, key: str) -> bool:
        return self.core.has(self._key(key))

    def release_namespace(self) -> int:
        """Drop every key this view owns (the owning replica leaves)."""
        return self.core.drop_namespace(
            f"{self.namespace}:" if self.namespace else ""
        )


_BACKEND_KINDS = {
    "host": HostMemoryBackend,
    "disk": DiskSpillBackend,
    "rpc": RpcBackend,
    "object": ObjectStoreBackend,
}


def build_backends(
    specs: Sequence[TierSpec],
    *,
    transfer: Optional[TransferModel] = None,
    clock: Optional[SimClock] = None,
    hedge=None,
    faults: Optional[FaultInjector] = None,
) -> Dict[str, StorageBackend]:
    """One backend per TierSpec: kind by name (host_dram -> host memory,
    local_nvme -> disk spill, peer*/rpc* -> RPC peer, else object store),
    hedging only where a straggler tail exists, concurrency-limit wrapped
    when the spec bounds the link."""
    out: Dict[str, StorageBackend] = {}
    for spec in specs:
        cls = _BACKEND_KINDS[spec.backend or _default_kind(spec.name)]
        b = cls(
            spec.name, transfer=transfer, clock=clock,
            hedge=hedge if cls.hedgeable else None, faults=faults,
        )
        if spec.concurrency is not None:
            b = ConcurrencyLimitedBackend(b, spec.concurrency, clock=b.clock)
        out[spec.name] = b
    return out


# --------------------------------------------------------------------------- #
# Store records
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class StoredEntry:
    entry_id: str
    chain: List[str]
    n_tokens: int
    nbytes: int
    compressed: bool
    tier: str
    created_s: float
    last_used_s: float
    uses: int = 0
    # $ saved per reuse (prefill skipped) — set by the caller for cost-aware
    # eviction scoring.
    saved_per_use: float = 0.0
    # pin count: >0 means an in-flight prefetch or planned fetch depends on
    # this entry — it must not be evicted, demoted, or promoted.
    pins: int = 0
    # monotone store-assigned sequence number (deterministic tie-break for
    # the migration pass's move ordering).
    seq: int = 0
    # position-independent content hashes of the entry's complete chunks —
    # its footprint in the fusion ChunkIndex, removed on eviction.
    content_chunks: List[str] = dataclasses.field(default_factory=list)
    # whole-context content hash (exact token sequence): the cross-store
    # dedup identity on a content-addressed shared tier, and the traffic key
    # for cluster rebalancing.  None when the store has no shared backend.
    content_key: Optional[str] = None


@dataclasses.dataclass
class TierState:
    name: str
    capacity_bytes: float
    used_bytes: float = 0.0
    gb_hours: float = 0.0
    _last_accrual_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class TierMigration:
    """One completed tier movement, emitted by the migration/spill machinery
    (the engine wraps these into ``TierMigrated`` events)."""

    t_s: float
    entry_id: str
    from_tier: str
    to_tier: str
    nbytes: float
    reason: str  # "promote" | "demote" | "spill"


# --------------------------------------------------------------------------- #
# Migration policy: the paper's break-even math per tier
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class BreakEvenMigrator:
    """Place each entry in the tier that minimizes its total $/hour:

        rate(tier) = hold + reuse_freq * fetch
        hold       = $/GB-hour(tier) * entry_GB
        fetch      = c_GPU * load_delay(tier, nbytes)  +  per-GB fees

    i.e. the storage-tier delta must be justified by reuse frequency times
    fetch savings — the paper's break-even inequality generalized from
    "store vs recompute" to "which tier".  Hot entries (high freq) promote
    toward DRAM; cold ones demote toward object storage, strictly lowering
    the storage $/hour they accrue."""

    # GPU-second price used to convert fetch delay into $; resolved from the
    # store's Pricing when None.
    compute_cost_per_s: Optional[float] = None
    # Hysteresis: move only if it saves at least this many $/hour.
    min_savings_per_hour: float = 0.0
    # Entries younger than this never migrate (their reuse frequency is not
    # yet informative).
    min_residency_s: float = 0.0

    def rate_parts(self, store: "TieredStore", e: StoredEntry, tier: str) -> Tuple[float, float]:
        """(hold $/h, fetch $/use) for ``e`` in ``tier`` — the two lines of
        the affine rate(freq) = hold + freq * fetch."""
        hold = store._gb_hour_rate(tier) * e.nbytes / GB
        c_gpu = self.compute_cost_per_s
        if c_gpu is None:
            c_gpu = (
                store.pricing.compute.cost_per_hour / 3600.0
                if store.pricing is not None
                else 0.0
            )
        fetch = c_gpu * store.backends[tier].estimate_load_delay(e.nbytes)
        if store.pricing is not None and tier in store.pricing.tiers:
            fetch += store.pricing.tiers[tier].per_gb_transfer_fee * e.nbytes / GB
        return hold, fetch

    def tier_rate(self, store: "TieredStore", e: StoredEntry, tier: str, freq_per_h: float) -> float:
        hold, fetch = self.rate_parts(store, e, tier)
        return hold + freq_per_h * fetch

    def crossing_freq(self, store: "TieredStore", e: StoredEntry) -> float:
        """Largest reuse frequency (per hour) at which some slower-fetch tier
        starts beating the current one by ``min_savings_per_hour``.  Between
        touches freq decays monotonically, so an entry that just evaluated to
        "stay put" next flips exactly when its freq falls below this — the
        break-even crossing in closed form.  Each candidate tier's rate is
        affine in freq (``hold + freq * fetch``); a slower-fetch (cheaper-
        hold) tier overtakes below

            f_t = (hold_cur - hold_t - min_savings) / (fetch_t - fetch_cur)

        and the first crossing reached from above is max over tiers.  Tiers
        with fetch <= fetch_cur only lose ground as freq decays: no crossing.
        Returns 0.0 when no decay can ever flip the decision."""
        hold_cur, fetch_cur = self.rate_parts(store, e, e.tier)
        f_star = 0.0
        for t in store.tier_order:
            if t == e.tier:
                continue
            hold_t, fetch_t = self.rate_parts(store, e, t)
            if fetch_t <= fetch_cur:
                continue
            f = (hold_cur - hold_t - self.min_savings_per_hour) / (fetch_t - fetch_cur)
            f_star = max(f_star, f)
        return f_star

    def target(self, store: "TieredStore", e: StoredEntry) -> Optional[str]:
        """Best tier for ``e`` (None = stay put)."""
        now = store.clock.now
        if now - e.created_s < self.min_residency_s:
            return None
        age_h = max((now - e.created_s) / 3600.0, 1e-9)
        freq = e.uses / age_h
        current = self.tier_rate(store, e, e.tier, freq)
        best_tier, best = e.tier, current
        for t in store.tier_order:
            if t == e.tier:
                continue
            r = self.tier_rate(store, e, t, freq)
            if r < best:
                best_tier, best = t, r
        if best_tier != e.tier and current - best > self.min_savings_per_hour:
            return best_tier
        return None


# --------------------------------------------------------------------------- #
# The tiered store
# --------------------------------------------------------------------------- #
class TieredStore:
    """Multi-tier, content-addressed store for per-context model state.

    Owns *what* is stored — tier metadata, the chain-hash trie
    (``chunks.ChunkTrie``), capacity/GB-hour accounting, pinning, and the
    cost-aware eviction/migration economics — while the bytes live in
    pluggable ``StorageBackend``s, one per tier, ordered fastest-first."""

    def __init__(
        self,
        *,
        tiers: Optional[Sequence[TierSpec]] = None,
        tier_capacities_gb: Optional[Dict[str, float]] = None,
        transfer: Optional[TransferModel] = None,
        clock: Optional[SimClock] = None,
        chunk_tokens: int = 256,
        compress_tier: Optional[str] = None,  # entries entering this tier are int8
        eviction: str = "cost",  # "cost" | "lru"
        backends: Optional[Dict[str, StorageBackend]] = None,
        pricing: Optional[Pricing] = None,
        migration: Optional[BreakEvenMigrator] = None,
        spill_on_pressure: bool = False,
        hedge=None,
        faults: Optional[FaultInjector] = None,
        device=None,  # where int8 entries dequantise (None: the card)
    ):
        if tiers is None:
            assert tier_capacities_gb is not None, (
                "TieredStore needs tiers=[TierSpec...] or tier_capacities_gb={...}"
            )
            tiers = [TierSpec(n, gb) for n, gb in tier_capacities_gb.items()]
        self.specs: Dict[str, TierSpec] = {s.name: s for s in tiers}
        self.tiers: Dict[str, TierState] = {
            s.name: TierState(s.name, s.capacity_gb * GB) for s in tiers
        }
        self.tier_order = [s.name for s in tiers]  # fastest first
        self.transfer = transfer
        self.clock = clock or SimClock()
        self.backends: Dict[str, StorageBackend] = backends or build_backends(
            tiers, transfer=transfer, clock=self.clock, hedge=hedge,
            faults=faults,
        )
        missing = set(self.tier_order) - set(self.backends)
        assert not missing, f"tiers without a backend: {sorted(missing)}"
        # any content-addressed backend (a shared tier) makes the store
        # compute whole-context content keys at put time for cross-store dedup
        self._content_addressed = any(
            getattr(b, "content_addressed", False) for b in self.backends.values()
        )
        self.pricing = pricing
        self.trie = ChunkTrie(chunk_tokens)
        # position-independent per-chunk content index maintained alongside
        # the chain-hash trie — the fusion subsystem's non-prefix match
        # surface (kvcache/fusion.py; consulted via lookup_composite).
        self.chunk_index = ChunkIndex(chunk_tokens)
        self.entries: Dict[str, StoredEntry] = {}
        self.compress_tier = compress_tier
        self.device = device
        self.eviction = eviction
        self.migration = migration
        self.spill_on_pressure = spill_on_pressure
        self.migration_log: List[TierMigration] = []
        self._ids = itertools.count()
        self.evictions = 0
        self.rejected_puts = 0
        # failure-handling counters: puts rolled back because the backend
        # raised a typed StorageError, entries discarded after the backend
        # lost/corrupted their bytes
        self.failed_puts = 0
        self.discards = 0
        self.last_put_handle = None
        # bumped on every trie mutation (put/evict): consumers holding a
        # lookup result (e.g. the engine's prefetch pass) revalidate with it
        # instead of re-walking the trie at admission.
        self.trie_version = 0
        # Delta-gossip surface (serving/cluster.py): an append-only log of
        # digest hashes in insertion order.  Puts append; removals
        # (evict/discard) bump ``digest_epoch`` and snapshot the log back to
        # the live set — bloom bits cannot be cleared, so a removal forces
        # the consumer's next gossip tick to rebuild from scratch, while
        # put-only windows ship just the add-set since the last cursor.
        self.digest_epoch = 0
        self._digest_log: List[str] = []
        # Migration priority queue: (due_s, seq, entry_id) min-heap keyed by
        # each entry's predicted band-crossing time — reuse frequency
        # uses/age decays monotonically between touches, so the instant its
        # log2 band drops an edge is closed-form.  run_migrations pops only
        # the DUE entries (plus the event-dirtied ones: fetched, moved,
        # unpinned, repriced) instead of walking O(entries) per tick.
        # Lazy deletion: an entry's ARMED wake-up is the due time in
        # _mig_next; heap items that disagree (superseded by a re-arm) or
        # whose entry died are skipped at pop, so each entry holds at most
        # one live wake-up no matter how often it re-evaluates.
        self._mig_heap: List[Tuple[float, int, str]] = []
        self._mig_next: Dict[str, float] = {}
        self._mig_dirty: set = set()
        self._mig_seq = itertools.count()
        self._mig_env: Optional[tuple] = None
        self.migration_evals = 0
        self.migration_skips = 0

    # ------------------------------------------------------------------ #
    # Accounting
    # ------------------------------------------------------------------ #
    def _accrue(self) -> None:
        now = self.clock.now
        for t in self.tiers.values():
            dt_h = max(0.0, now - t._last_accrual_s) / 3600.0
            t.gb_hours += (t.used_bytes / GB) * dt_h
            t._last_accrual_s = now

    def storage_cost_by_tier(self, pricing: Pricing) -> Dict[str, float]:
        """Per-tier accrued GB-hour dollars.  ``storage_cost`` is exactly
        the sum of these, which is what lets the cost ledger settle storage
        per tier while still satisfying its conservation law."""
        self._accrue()
        return {
            t.name: pricing.tier(t.name).cost_per_gb_hour * t.gb_hours
            for t in self.tiers.values()
            if t.name in pricing.tiers
        }

    def storage_cost(self, pricing: Pricing) -> float:
        return sum(self.storage_cost_by_tier(pricing).values())

    def storage_rate_per_hour(self) -> float:
        """Instantaneous $/hour the currently resident bytes accrue."""
        return sum(
            self._gb_hour_rate(t.name) * t.used_bytes / GB
            for t in self.tiers.values()
        )

    # ------------------------------------------------------------------ #
    # Pinning
    # ------------------------------------------------------------------ #
    def pin(self, entry_id: str) -> None:
        """Protect an entry from eviction/demotion until ``unpin`` (in-flight
        prefetches and planned fetches)."""
        try:
            self.entries[entry_id].pins += 1
        except KeyError:
            raise KeyError(f"cannot pin unknown entry {entry_id!r}") from None

    def unpin(self, entry_id: str) -> bool:
        e = self.entries.get(entry_id)
        if e is None:
            return False
        e.pins = max(0, e.pins - 1)
        if e.pins == 0 and self.migration is not None:
            # the pin suppressed migration: force a fresh look next pass
            self._mig_dirty.add(entry_id)
        return True

    def pinned(self, entry_id: str) -> bool:
        e = self.entries.get(entry_id)
        return e is not None and e.pins > 0

    # ------------------------------------------------------------------ #
    # Write path
    # ------------------------------------------------------------------ #
    def put(
        self,
        tokens: Sequence[int],
        artifact: Any,
        *,
        tier: str,
        saved_per_use: float = 0.0,
        sync: bool = False,
    ) -> Tuple[Optional[str], float]:
        """Store a context artifact.  Returns (entry_id | None, write_delay_s).
        Async writes (default) overlap serving: delay is charged to the link
        stats but not to the caller.  Under capacity pressure, space is made
        by spilling the least valuable entries one tier down
        (``spill_on_pressure``) or evicting them."""
        self._accrue()
        ts = self.tiers[tier]
        compressed = tier == self.compress_tier
        if compressed:
            artifact = compression.compress_tree(artifact)
        nbytes = compression.tree_nbytes(artifact)

        if nbytes > ts.capacity_bytes or not self._ensure_room(tier, nbytes):
            self.rejected_puts += 1
            return None, 0.0

        n = next(self._ids)
        entry_id = f"ctx{n}"
        chain = self.trie.insert(tokens, entry_id)
        if not chain:  # context shorter than one chunk: not storable
            self.rejected_puts += 1
            return None, 0.0
        content = self.chunk_index.insert(tokens, entry_id)
        e = StoredEntry(
            entry_id=entry_id,
            chain=chain,
            n_tokens=len(chain) * self.trie.chunk_tokens,
            nbytes=nbytes,
            compressed=compressed,
            tier=tier,
            created_s=self.clock.now,
            last_used_s=self.clock.now,
            saved_per_use=saved_per_use,
            seq=n,
            content_chunks=content,
            content_key=(
                self.content_key(tokens) if self._content_addressed else None
            ),
        )
        self.entries[entry_id] = e
        ts.used_bytes += nbytes
        self.trie_version += 1
        if self.migration is not None:
            self._mig_dirty.add(entry_id)
        try:
            handle = self._backend_put(e, artifact, tier, nbytes)
        except StorageError:
            # the tier refused the bytes (brownout/injected write failure):
            # roll every piece of bookkeeping back so the store never
            # advertises an entry whose payload was never accepted
            self.trie.remove(chain, entry_id)
            self.chunk_index.remove(content, entry_id)
            ts.used_bytes -= nbytes
            del self.entries[entry_id]
            self._mig_dirty.discard(entry_id)
            self.trie_version += 1
            self.failed_puts += 1
            self.last_put_handle = None
            return None, 0.0
        # surfaced for telemetry: a dedup'd shared-tier put moved zero bytes,
        # and the ledger records that saving as an explicit zero-$ entry
        self.last_put_handle = handle
        self._digest_log.extend(e.chain)
        self._digest_log.extend(e.content_chunks)
        if e.content_key is not None:
            self._digest_log.append(e.content_key)
        return entry_id, (handle.delay_s if sync else 0.0)

    @staticmethod
    def content_key(tokens: Sequence[int]) -> str:
        """Whole-context content id: the exact token sequence hashed — safe
        as a cross-store dedup identity (chain hashes truncate to chunk
        multiples, so two different tails could collide there)."""
        return hashlib.sha256("|".join(map(str, tokens)).encode()).hexdigest()

    def _backend_put(self, e: StoredEntry, payload: Any, tier: str,
                     nbytes: float, *, charge: bool = True):
        """Write an entry's bytes to ``tier``, passing the content identity
        to content-addressed (shared) backends so identical contexts stored
        by sibling stores dedup service-wide.  The compression flag joins the
        id: an int8 artifact is NOT the same bytes as its fp16 twin."""
        b = self.backends[tier]
        if e.content_key is not None and getattr(b, "content_addressed", False):
            return b.put(
                e.entry_id, payload, nbytes, charge=charge,
                content=f"{e.content_key}:c{int(e.compressed)}",
            )
        return b.put(e.entry_id, payload, nbytes, charge=charge)

    # ------------------------------------------------------------------ #
    # Read path
    # ------------------------------------------------------------------ #
    def lookup(self, tokens: Sequence[int]) -> Tuple[PrefixMatch, Optional[StoredEntry]]:
        m = self.trie.longest_prefix(tokens)
        return m, (self.entries.get(m.entry_id) if m.entry_id else None)

    def lookup_composite(self, tokens: Sequence[int]) -> CompositeMatch:
        """Position-independent chunk-content matches for ``tokens`` — the
        fusion planner's non-prefix reuse surface (reused spans name their
        source entries; rows are fetched per entry at execute time)."""
        return self.chunk_index.match(tokens)

    def fetch(
        self, entry_id: str, *, fraction: float = 1.0, nbytes: Optional[float] = None
    ) -> Tuple[Any, float]:
        """Load an artifact (optionally a prefix fraction of its bytes for
        partial attention-KV reuse).  ``nbytes`` overrides the billed byte
        count (economics-at-scale: charge the full arch's KV bytes and occupy
        the link accordingly).  Returns (decompressed artifact, delay_s) —
        the delay includes any queueing on a concurrency-limited link."""
        self._accrue()
        e = self.entries[entry_id]
        e.uses += 1
        e.last_used_s = self.clock.now
        if self.migration is not None:
            # reuse frequency just jumped: the entry's band may have crossed
            # upward, which no time-based schedule can predict
            self._mig_dirty.add(entry_id)
        if nbytes is None:
            nbytes = e.nbytes * max(0.0, min(1.0, fraction))
        try:
            payload, handle = self.backends[e.tier].get(entry_id, nbytes=nbytes)
        except KeyNotFound:
            # the backend lost the bytes: the metadata is a lie — drop it so
            # the next lookup plans an honest recompute instead of retrying
            self.discard(entry_id)
            raise
        except CorruptPayload as exc:
            if exc.at_rest:
                # the stored copy itself is bad; no retry can help
                self.discard(entry_id)
            raise
        if e.compressed:
            # the int8 rows and scales cross to the device and dequantise there
            payload = compression.decompress_tree(payload, self.device)
        return payload, handle.delay_s

    def estimate_load_delay(self, tier: str, nbytes: float) -> float:
        """Backend-modeled (hedged) read delay for ``nbytes`` from ``tier``,
        charging nothing — the prefetch/economics planning surface."""
        return self.backends[tier].estimate_load_delay(nbytes)

    def estimated_queue_wait(
        self, tier: str, nbytes: float, pending: Sequence[float] = ()
    ) -> float:
        """Predicted queueing delay on ``tier``'s link right now (0 for
        uncontended links).  ``pending`` — byte sizes of same-instant fetches
        ahead of this one (see ``ConcurrencyLimitedBackend.estimated_wait``)."""
        fn = getattr(self.backends[tier], "estimated_wait", None)
        if fn is None:
            return 0.0
        return fn(nbytes, pending) if pending else fn(nbytes)

    # ------------------------------------------------------------------ #
    # Tier movement / eviction / migration
    # ------------------------------------------------------------------ #
    def _tier_index(self, tier: str) -> int:
        return self.tier_order.index(tier)

    def _next_tier_down(self, tier: str) -> Optional[str]:
        i = self._tier_index(tier)
        return self.tier_order[i + 1] if i + 1 < len(self.tier_order) else None

    def _transformed(self, e: StoredEntry, to_tier: str) -> Tuple[Any, float, bool]:
        """(payload, nbytes, compressed) as they would be after moving ``e``
        to ``to_tier``: compressed entering the int8 tier, decompressed
        leaving it — the size the destination must actually absorb."""
        payload = self.backends[e.tier].peek(e.entry_id)
        if to_tier == self.compress_tier and not e.compressed:
            p = compression.compress_tree(payload)
            return p, compression.tree_nbytes(p), True
        if e.compressed and to_tier != self.compress_tier:
            # dequantised on the store's device, kept on the host below
            p = compression.to_host_tree(compression.decompress_tree(payload, self.device))
            return p, compression.tree_nbytes(p), False
        return payload, e.nbytes, e.compressed

    def _move(self, entry_id: str, to_tier: str, *, reason: str) -> Optional[TierMigration]:
        """Move an entry between tiers (uncharged link bytes: migration, not a
        serving write).  Compresses entering the int8 tier, decompresses
        leaving it.  Refuses pinned entries and full destinations."""
        e = self.entries.get(entry_id)
        if e is None or e.tier == to_tier or e.pins > 0:
            return None
        new_payload, new_nbytes, new_compressed = self._transformed(e, to_tier)
        dst = self.tiers[to_tier]
        if dst.used_bytes + new_nbytes > dst.capacity_bytes:
            return None
        self._accrue()
        from_tier = e.tier
        # copy-then-delete: if the destination tier refuses the bytes the
        # entry stays intact at its source instead of vanishing mid-move
        old_nbytes, old_compressed = e.nbytes, e.compressed
        e.tier, e.nbytes, e.compressed = to_tier, new_nbytes, new_compressed
        try:
            self._backend_put(e, new_payload, to_tier, new_nbytes, charge=False)
        except StorageError:
            e.tier, e.nbytes, e.compressed = from_tier, old_nbytes, old_compressed
            return None
        self.backends[from_tier].delete(entry_id)
        self.tiers[from_tier].used_bytes -= old_nbytes
        dst.used_bytes += new_nbytes
        self._mig_dirty.add(entry_id)  # tier changed: re-evaluate fresh
        mig = TierMigration(
            t_s=self.clock.now, entry_id=entry_id, from_tier=from_tier,
            to_tier=to_tier, nbytes=new_nbytes, reason=reason,
        )
        self.migration_log.append(mig)
        return mig

    def demote(self, entry_id: str, to_tier: str) -> bool:
        return self._move(entry_id, to_tier, reason="demote") is not None

    def promote(self, entry_id: str, to_tier: str) -> bool:
        return self._move(entry_id, to_tier, reason="promote") is not None

    def _mig_schedule(self, e: StoredEntry) -> None:
        """Re-arm an entry's next migration wake-up after it evaluated to
        "stay put".  Between touches reuse frequency uses/age decays
        monotonically, so the break-even decision next flips at the EXACT
        closed-form crossing: the instant freq falls to the largest frequency
        at which a slower-fetch tier starts winning
        (``BreakEvenMigrator.crossing_freq``) —

            uses / age_h == f*   =>   t = created + 3600 * uses / f*

        — and that (or the min-residency gate expiring, if sooner) is the
        next time the decision can change without an event.  (Earlier
        revisions woke at the entry's log2 *band* edge instead, which within
        a band could lag the true crossing by up to 2x freq drift — the
        drift-fix regression in tests/test_hierarchy.py pins the exact
        time.)  Event-driven flips (fetch, tier move, unpin, repricing) mark
        the entry dirty instead.  Entries never fetched have frequency zero
        already: if staying won at freq 0, no decay can flip it — no
        wake-up.  Likewise when no crossing exists below the current freq
        (f* <= 0)."""
        due = math.inf
        now = self.clock.now
        if e.uses > 0:
            f_star = self.migration.crossing_freq(self, e)
            if f_star > 0.0:
                due = max(now, e.created_s + 3600.0 * e.uses / f_star)
                due = due * (1 + 1e-12) + 1e-9  # strictly past the crossing
        mig = self.migration
        if mig.min_residency_s > 0 and now - e.created_s < mig.min_residency_s:
            due = min(due, e.created_s + mig.min_residency_s)
        if math.isfinite(due):
            self._mig_next[e.entry_id] = due
            heapq.heappush(self._mig_heap, (due, next(self._mig_seq), e.entry_id))

    def run_migrations(self, full_scan: bool = False) -> List[TierMigration]:
        """Clock-driven migration pass, driven by the band-crossing priority
        queue: pop every entry whose predicted band-crossing time is due,
        union the event-dirtied ones (fetched / moved / unpinned / repriced
        since the last pass), and apply the bound policy to just those — a
        steady store pays O(due) instead of even an O(entries) walk per tick
        (``migration_evals`` / ``migration_skips`` expose the split;
        ``full_scan=True`` forces the exhaustive evaluation).  Evaluating to
        "stay put" re-arms the entry's next crossing (``_mig_schedule``);
        a blocked move (pinned race, full destination) retries next pass.
        Demotions apply first (freeing hot-tier capacity for promotions),
        deepest first, ties in store insertion order — deterministically
        identical to the exhaustive scan (regression-tested)."""
        if self.migration is None:
            return []
        self._accrue()
        now = self.clock.now
        env = (
            tuple(self.tier_order),
            tuple(self._gb_hour_rate(t) for t in self.tier_order),
        )
        if env != self._mig_env:  # tier pricing/topology changed: all stale
            self._mig_env = env
            self._mig_dirty.update(self.entries)
        if full_scan:
            self._mig_heap.clear()
            self._mig_next.clear()
            self._mig_dirty.clear()
            due = set(self.entries)
        else:
            due = set(self._mig_dirty)
            self._mig_dirty.clear()
            while self._mig_heap and self._mig_heap[0][0] <= now:
                due_t, _, eid = heapq.heappop(self._mig_heap)
                if self._mig_next.get(eid) == due_t:
                    due.add(eid)
                # else: superseded by a later re-arm, or the entry died
        moves: List[Tuple[StoredEntry, str]] = []
        repush: List[str] = []
        evaluated = 0
        for eid in sorted(due, key=lambda i: self.entries[i].seq if i in self.entries else -1):
            self._mig_next.pop(eid, None)  # consumed / about to re-arm
            e = self.entries.get(eid)
            if e is None:
                continue  # evicted since it was scheduled (lazy deletion)
            if e.pins > 0:
                repush.append(eid)  # retry once the pin drops
                continue
            tgt = self.migration.target(self, e)
            evaluated += 1
            if tgt is None:
                self._mig_schedule(e)
            else:
                moves.append((e, tgt))
        self.migration_evals += evaluated
        if not full_scan:
            self.migration_skips += max(
                0, len(self.entries) - evaluated - len(repush)
            )
        for eid in repush:
            self._mig_next[eid] = now
            heapq.heappush(self._mig_heap, (now, next(self._mig_seq), eid))
        done: List[TierMigration] = []
        # deepest demotions first, promotions last, ties by insertion order
        moves.sort(
            key=lambda m: (
                self._tier_index(m[0].tier) - self._tier_index(m[1]), m[0].seq
            )
        )
        for e, tgt in moves:
            reason = (
                "demote" if self._tier_index(tgt) > self._tier_index(e.tier)
                else "promote"
            )
            mig = self._move(e.entry_id, tgt, reason=reason)
            if mig is not None:
                done.append(mig)
            elif e.entry_id in self.entries:
                # blocked (pinned race / full destination): retry next pass
                self._mig_next[e.entry_id] = now
                heapq.heappush(
                    self._mig_heap, (now, next(self._mig_seq), e.entry_id)
                )
        return done

    def drain_migrations(self) -> List[TierMigration]:
        """Pop-and-return every migration (policy passes AND pressure spills)
        since the last drain — the engine's event source."""
        out, self.migration_log = self.migration_log, []
        return out

    def _gb_hour_rate(self, tier: str) -> float:
        if self.pricing is not None and tier in self.pricing.tiers:
            return self.pricing.tier(tier).cost_per_gb_hour
        return _FALLBACK_GB_HOUR_RATE

    def _score(self, e: StoredEntry, pricing_rate: float) -> float:
        """Cost-aware eviction score (higher = keep): $ saved per hour by this
        entry minus its $ storage rate; LRU mode uses recency only."""
        if self.eviction == "lru":
            return e.last_used_s
        age_h = max((self.clock.now - e.created_s) / 3600.0, 1e-6)
        save_rate = e.saved_per_use * e.uses / age_h
        hold_rate = pricing_rate * e.nbytes / GB
        return save_rate - hold_rate

    def _victim(self, tier: str) -> Optional[StoredEntry]:
        cands = [
            e for e in self.entries.values() if e.tier == tier and e.pins == 0
        ]
        if not cands:
            return None
        rate = self._gb_hour_rate(tier)
        return min(cands, key=lambda e: self._score(e, pricing_rate=rate))

    def _ensure_room(self, tier: str, nbytes: float) -> bool:
        ts = self.tiers[tier]
        if nbytes > ts.capacity_bytes:
            return False  # can never fit: don't evict anything chasing it
        while ts.used_bytes + nbytes > ts.capacity_bytes:
            if not self._spill_or_evict_one(tier):
                return False
        return True

    def _spill_or_evict_one(self, tier: str) -> bool:
        """Free space in ``tier``: preferably by demoting its least valuable
        unpinned entry one level down (``spill_on_pressure``), else by
        evicting it."""
        if self.spill_on_pressure:
            nxt = self._next_tier_down(tier)
            victim = self._victim(tier)
            if nxt is not None and victim is not None:
                # size the destination for the POST-move bytes: leaving the
                # int8 tier decompresses the entry to several times its
                # current footprint
                _, need, _ = self._transformed(victim, nxt)
                if self._ensure_room(nxt, need):
                    if self._move(victim.entry_id, nxt, reason="spill") is not None:
                        return True
        return self._evict_one(tier)

    def _evict_one(self, tier: str) -> bool:
        victim = self._victim(tier)
        if victim is None:
            return False
        self.trie.remove(victim.chain, victim.entry_id)
        self.chunk_index.remove(victim.content_chunks, victim.entry_id)
        self.tiers[tier].used_bytes -= victim.nbytes
        self.backends[tier].delete(victim.entry_id)
        del self.entries[victim.entry_id]
        self._mig_dirty.discard(victim.entry_id)  # heap ids die lazily at pop
        self._mig_next.pop(victim.entry_id, None)
        self.trie_version += 1
        self.evictions += 1
        self.digest_epoch += 1
        self._digest_log = self.digest_hashes()
        return True

    def discard(self, entry_id: str) -> bool:
        """Unconditionally drop an entry whose stored bytes turned out to be
        lost or corrupt.  Unlike eviction this is failure handling, not
        economics: it ignores pins and value scores — metadata pointing at
        bytes that cannot be served is worse than a miss."""
        e = self.entries.get(entry_id)
        if e is None:
            return False
        self.trie.remove(e.chain, e.entry_id)
        self.chunk_index.remove(e.content_chunks, e.entry_id)
        self.tiers[e.tier].used_bytes -= e.nbytes
        self.backends[e.tier].delete(e.entry_id)
        del self.entries[e.entry_id]
        self._mig_dirty.discard(entry_id)
        self._mig_next.pop(entry_id, None)
        self.trie_version += 1
        self.discards += 1
        self.digest_epoch += 1
        self._digest_log = self.digest_hashes()
        return True

    def digest_hashes(self) -> List[str]:
        """Every hash an affinity router could match against this store: the
        chain hashes (prefix reuse), chunk-content hashes (fused reuse), and
        whole-context content keys of all live entries — the bloom-digest
        gossip surface (``serving/router.py``)."""
        out: List[str] = []
        for e in self.entries.values():
            out.extend(e.chain)
            out.extend(e.content_chunks)
            if e.content_key is not None:
                out.append(e.content_key)
        return out

    def digest_view(self) -> Tuple[int, List[str]]:
        """(epoch, hash log) for delta gossip.  Within one epoch the log only
        grows, so a consumer holding (epoch, cursor) applies ``log[cursor:]``
        as an add-set; an epoch change means a removal happened and the
        consumer must rebuild its digest from the full log (which removals
        re-snapshot to exactly the live ``digest_hashes()`` set)."""
        return self.digest_epoch, self._digest_log

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        self._accrue()
        shared = {
            n: b.core.stats()
            for n, b in self.backends.items()
            if isinstance(getattr(b, "core", None), SharedBackendCore)
        }
        return {
            **({"shared": shared} if shared else {}),
            "entries": len(self.entries),
            "evictions": self.evictions,
            "rejected_puts": self.rejected_puts,
            "failed_puts": self.failed_puts,
            "discards": self.discards,
            "migrations": len(self.migration_log),
            "migration_evals": self.migration_evals,
            "migration_skips": self.migration_skips,
            "migration_queue": len(self._mig_next),  # armed wake-ups
            "content_chunks": len(self.chunk_index),
            "tiers": {
                n: {"used_gb": t.used_bytes / GB, "gb_hours": t.gb_hours}
                for n, t in self.tiers.items()
            },
        }
