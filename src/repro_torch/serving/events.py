"""Typed events emitted by the step-driven serving engine.

Every observable state change in a request's lifecycle is an event carrying
the SimClock time at which it happened.  ``ServingEngine.step()`` returns the
events of one scheduling step; traces, streaming callers, benchmarks, and
tests all consume the same stream instead of poking engine internals.

Lifecycle of one request:

    RequestAdmitted -> PlanChosen -> ([KVLoaded] | [StoreWriteBack])
        -> PrefillDone -> TokenEmitted* -> RequestFinished

(StoreWriteBack precedes PrefillDone: a packed batch writes recomputed
contexts back before it reports the batch's prefill.)

Under the unified step (``EngineConfig.unified_step``) a request's prefill
lands over several ``UnifiedStep`` launches between ``KVLoaded`` and
``PrefillDone``.  A fused (CacheBlend-style) admission emits one
``KVLoaded`` per source entry, then ``FusedAdmitted``, then ``PrefillDone``.
A cluster (``serving/cluster.py``) adds ``RequestRouted`` before the landing
replica's ``RequestAdmitted``, and the cluster-level ``ReplicaRebalanced``
and ``ReplicaCrashed``.  A plan bought from a marketplace peer
(``repro_torch.market``) emits ``KVPurchased`` and ``SellerVerified`` when
the purchase settles; a failed purchase emits ``SellerVerified(ok=False)``
(and ``SellerBlacklisted`` if that ejected the seller) where verification
failed, then ``DegradedToRecompute``.

``ClockAdvanced`` appears between requests when the engine is idle and jumps
simulated time to the next arrival.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

from repro_torch.serving.planner import ReusePlan
from repro_torch.serving.request import RequestRecord


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: SimClock time + the request it concerns (-1 = engine)."""

    t_s: float
    req_id: int


@dataclasses.dataclass(frozen=True)
class RequestAdmitted(Event):
    slot: int
    queue_s: float  # time spent waiting for a slot


@dataclasses.dataclass(frozen=True)
class PlanChosen(Event):
    plan: ReusePlan


@dataclasses.dataclass(frozen=True)
class BatchAdmitted(Event):
    """One packed admission batch (req_id is -1: the batch is an engine-level
    act; each member request still gets its own RequestAdmitted/PlanChosen).
    ``q_tokens``/``q_len`` expose packing occupancy, ``jit_hit`` whether the
    (q_len, kv_len) bucket reused an already-compiled kernel."""

    req_ids: tuple
    q_tokens: int  # useful new tokens across all segments
    q_len: int  # bucketed (padded) packed q length
    kv_len: int  # bucketed packed kv length
    jit_hit: bool


@dataclasses.dataclass(frozen=True)
class UnifiedStep(Event):
    """One unified continuous-batching launch (req_id is -1): decode rows
    co-scheduled with prefill-chunk rows in one kernel over the shared block
    pool.  ``chunk_tokens`` is the prefill quota granted this step;
    ``jit_hit`` whether the launch shape was seen before (the port runs
    eagerly, but keeps the reference's bucket key: steady unified serving
    has one shape)."""

    req_ids: tuple  # decode participants first, then chunk participants
    n_decode: int  # decode rows in the launch
    chunk_tokens: int  # prefill-chunk tokens granted this step
    step_s: float  # modelled duration (PerfModel.t_step_unified)
    jit_hit: bool


@dataclasses.dataclass(frozen=True)
class KVLoaded(Event):
    tier: str
    nbytes: float
    load_s: float  # delay charged to this request (post-hedge/prefetch/overlap)
    matched_tokens: int


@dataclasses.dataclass(frozen=True)
class FusedAdmitted(Event):
    """One fused selective-recompute admission (CacheBlend-style non-prefix
    reuse): the request's context was assembled from stored chunk spans
    (one KVLoaded per source entry precedes this event) and only the
    recompute spans + prompt ran through the fused prefill launch."""

    slot: int
    reused_tokens: int  # context tokens served from stored chunk KV
    recompute_tokens: int  # context tokens recomputed (selected + unmatched)
    n_spans: int  # execution spans in the schedule
    n_sources: int  # distinct source entries fetched
    q_len: int  # bucketed fused launch length (query side)
    kv_len: int  # bucketed assembled-buffer length
    jit_hit: bool


@dataclasses.dataclass(frozen=True)
class PrefillDone(Event):
    n_tokens: int  # tokens actually prefilled (context tail + prompt)
    prefill_s: float


@dataclasses.dataclass(frozen=True)
class StoreWriteBack(Event):
    entry_id: str
    tier: str
    nbytes: float


@dataclasses.dataclass(frozen=True)
class TokenEmitted(Event):
    token: int
    index: int  # 0-based position in the generation


@dataclasses.dataclass(frozen=True)
class RequestFinished(Event):
    record: RequestRecord


@dataclasses.dataclass(frozen=True)
class ClockAdvanced(Event):
    to_s: float


@dataclasses.dataclass(frozen=True)
class TierMigrated(Event):
    """An entry moved between storage tiers (req_id is -1: the clock-driven
    economics pass or a capacity-pressure spill, not a request)."""

    entry_id: str
    from_tier: str
    to_tier: str
    nbytes: float
    reason: str  # "promote" | "demote" | "spill"


@dataclasses.dataclass(frozen=True)
class RequestRouted(Event):
    """A cluster router chose a replica for this request (emitted by
    ``ServingCluster`` before the replica's own RequestAdmitted).
    ``matched_tokens`` is the DIGEST-predicted overlap at routing time — a
    stale/false-positive prediction shows up here larger than the landing
    replica's realized KVLoaded, which is exactly the staleness cost."""

    replica: int
    matched_tokens: int  # digest-predicted overlap (not the realized one)
    score: float  # marginal routing cost of the chosen replica ($)
    ring_owner: int  # consistent-hash baseline placement (-1: oblivious)


@dataclasses.dataclass(frozen=True)
class ReplicaRebalanced(Event):
    """Cluster rebalancing copied a hot entry toward its traffic: the target
    replica now holds its own hot-tier copy (replicated residency — the
    donor keeps serving until then, so there is no unreachable window).
    req_id is -1: an economics pass, not a request."""

    content_key: str
    from_replica: int
    to_replica: int
    nbytes: float
    hits: int  # routed hits at the target that justified the copy


@dataclasses.dataclass(frozen=True)
class FetchFailed(Event):
    """One planned KV fetch attempt failed (transient drop, brownout,
    corruption, or a vanished key).  ``wasted_s``/``wasted_bytes`` are what
    the failed attempt burned — already charged to the transfer model when
    bytes actually moved (brownouts fail fast and free)."""

    tier: str
    entry_id: str
    attempt: int  # 1-based attempt number that failed
    reason: str  # "unavailable" | "brownout" | "corrupt" | "corrupt_at_rest" | "not_found"
    wasted_s: float
    wasted_bytes: float


@dataclasses.dataclass(frozen=True)
class FetchRetried(Event):
    """The cost-aware retry policy decided another attempt still beats
    recomputing: attempt ``attempt`` will run after ``backoff_s``."""

    tier: str
    entry_id: str
    attempt: int  # the attempt about to run (>= 2)
    backoff_s: float


@dataclasses.dataclass(frozen=True)
class DegradedToRecompute(Event):
    """All fetch attempts failed (or retrying stopped beating recompute):
    the request falls back to exact recompute mid-admission.  Tokens are
    bit-identical to the fault-free run; the price is ``wasted_s`` of burned
    fetch time plus the full prefill."""

    tier: Optional[str]
    entry_id: Optional[str]
    attempts: int  # fetch attempts made before degrading
    wasted_s: float
    reason: str


@dataclasses.dataclass(frozen=True)
class KVPurchased(Event):
    """The request's stored-KV fetch was bought from a marketplace peer
    instead of served from the engine's own store (``repro_torch.market``).
    The purchase settled (buyer debited, seller credited) through the
    ``SettlementLedger``; ``price`` is the buyer's total spend including the
    market's transaction fee."""

    seller: str  # tenant id of the selling peer
    buyer: str
    entry_id: str  # entry in the SELLER's store
    tier: str  # seller-side tier the bytes came from
    nbytes: float
    price: float  # buyer spend in $ (ask x risk multiplier + flat fee)
    matched_tokens: int


@dataclasses.dataclass(frozen=True)
class SellerVerified(Event):
    """A purchased payload was verified before being served: checksum
    against the catalog stamp always, plus (``deep=True``) a spot recompute
    of a prefix sample compared against the delivered KV within the model
    dtype's tolerance (``ServingEngine.market_spot_check``).  ``ok=False``
    means the payload was corrupt or not this model's KV for these tokens:
    it was never served, and the request degrades to exact recompute."""

    seller: str
    entry_id: str
    ok: bool
    deep: bool  # the spot recompute-sample check ran (vs checksum-only)


@dataclasses.dataclass(frozen=True)
class SellerBlacklisted(Event):
    """The reputation book ejected a seller caught serving corrupt or wrong
    payloads: no future quote will name it again."""

    seller: str
    corrupt_count: int  # failed verifications that earned the ejection


@dataclasses.dataclass(frozen=True)
class ReplicaCrashed(Event):
    """A replica died mid-run (req_id is -1: a cluster-level act).  Its
    in-flight and queued requests were harvested and resubmitted to the
    surviving replicas through the router; its shared-tier namespace was
    released and its digest invalidated."""

    replica: int
    inflight: int  # active-slot requests resubmitted
    queued: int  # admission-queue requests resubmitted
    released_keys: int  # shared-tier keys released by the crash


AnyEvent = Union[
    RequestAdmitted, PlanChosen, BatchAdmitted, UnifiedStep, KVLoaded, FusedAdmitted,
    PrefillDone,
    StoreWriteBack, TokenEmitted, RequestFinished, ClockAdvanced, TierMigrated,
    RequestRouted, ReplicaRebalanced, FetchFailed, FetchRetried, DegradedToRecompute,
    KVPurchased, SellerVerified, SellerBlacklisted, ReplicaCrashed,
]


def actions_from_events(events: List[Event]) -> dict:
    """req_id -> executed action, reconstructed from the plan stream (the
    event-trace view of what RequestRecord.action records)."""
    out = {}
    for ev in events:
        if isinstance(ev, PlanChosen):
            out[ev.req_id] = ev.plan.action
    return out


def tokens_from_events(events: List[Event]) -> dict:
    """req_id -> generated tokens, reconstructed from TokenEmitted events."""
    out: dict = {}
    for ev in events:
        if isinstance(ev, TokenEmitted):
            out.setdefault(ev.req_id, []).append(ev.token)
    return out
