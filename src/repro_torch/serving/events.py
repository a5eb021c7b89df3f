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

The port emits the events of its serving path; the reference's unified-step,
fused, cluster and market events come with those features.

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
class KVLoaded(Event):
    tier: str
    nbytes: float
    load_s: float  # delay charged to this request (post-hedge/prefetch/overlap)
    matched_tokens: int


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


AnyEvent = Union[
    RequestAdmitted, PlanChosen, BatchAdmitted, KVLoaded, PrefillDone,
    StoreWriteBack, TokenEmitted, RequestFinished, ClockAdvanced, TierMigrated,
    FetchFailed, FetchRetried, DegradedToRecompute,
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
