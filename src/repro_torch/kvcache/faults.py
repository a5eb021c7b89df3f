"""Deterministic fault injection and failure taxonomy for the KV store.

The paper's break-even math assumes every stored-KV fetch succeeds, but the
cloud tiers it prices (gp3/io2/S3/peer RPC) fail, time out, and serve corrupt
bytes in practice — and in this system's own terms failure handling is an
*economics* decision: every retry spends transfer dollars and wall-clock,
every degradation spends compute dollars.  This module supplies the three
pieces the serving stack needs to reason about that:

  * a typed error taxonomy (``KeyNotFound`` / ``TierUnavailable`` /
    ``CorruptPayload``, all under ``StorageError``) so planner and engine can
    branch on *what* failed instead of catching bare ``KeyError``;
  * ``payload_checksum`` — a content checksum every backend ``put`` stamps
    and every ``get`` verifies, so corruption is detected, never served
    (integrity groundwork the KV-marketplace direction needs);
  * ``FaultInjector`` — a seeded, schedule-driven injector that backends
    consult.  Fault draws are *hash-based* (seed × tier × key × op-count),
    not a shared RNG stream, so outcomes are independent of call
    interleaving: the same workload under the same schedule fails at the
    same operations no matter how replicas' steps interleave.
  * ``RetryPolicy`` — per-tier exponential backoff with a cost-aware gate:
    retry only while the expected retry cost (backoff + estimated reload,
    priced at GPU-seconds plus per-GB fees) still beats the marginal cost of
    just recomputing the matched prefix.

Everything here is host-side and optional: with no injector configured the
only behavioral change anywhere is the checksum stamp/verify on put/get.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

_GB = 1024.0 ** 3


# --------------------------------------------------------------------------- #
# Typed storage errors
# --------------------------------------------------------------------------- #
class StorageError(Exception):
    """Base for all typed storage failures.

    Carries enough context to account for the failure honestly: which tier
    and key failed, how much simulated delay the failed attempt consumed
    (already charged to the transfer model where applicable), and how many
    bytes of transfer were wasted.
    """

    def __init__(self, msg: str, *, tier: Optional[str] = None,
                 key: Optional[str] = None, delay_s: float = 0.0,
                 wasted_bytes: float = 0.0, reason: str = ""):
        super().__init__(msg)
        self.tier = tier
        self.key = key
        self.delay_s = float(delay_s)
        self.wasted_bytes = float(wasted_bytes)
        self.reason = reason or type(self).__name__


class KeyNotFound(StorageError, KeyError):
    """The tier has no payload under the key — permanent, not retryable.

    Subclasses ``KeyError`` so pre-existing ``except KeyError`` call sites
    keep working; new code should catch the typed error.
    """


class TierUnavailable(StorageError):
    """Transient tier failure: dropped fetch, RPC timeout, or a brownout
    window.  Retryable — the payload is still intact at the tier."""


class CorruptPayload(StorageError):
    """Checksum mismatch between stored and served bytes.

    ``at_rest=False`` means the corruption happened in flight (a reread can
    succeed → retryable); ``at_rest=True`` means the stored copy itself is
    bad (torn write) — not retryable, the entry must be discarded.
    """

    def __init__(self, msg: str, *, at_rest: bool = False, **kw):
        super().__init__(msg, **kw)
        self.at_rest = at_rest


def retryable(exc: BaseException) -> bool:
    """Whether a retry of the same operation can possibly succeed."""
    if isinstance(exc, KeyNotFound):
        return False
    if isinstance(exc, CorruptPayload) and exc.at_rest:
        return False
    return isinstance(exc, StorageError)


# --------------------------------------------------------------------------- #
# Content checksum
# --------------------------------------------------------------------------- #
def payload_checksum(payload: Any) -> str:
    """Stable content checksum over an arbitrary KV payload pytree.

    Walks tuples/lists/dicts (namedtuples included) and hashes each leaf's
    dtype, shape, and raw bytes.  A tensor, on any device, hashes as its host
    copy (bf16 as its ``uint16`` pattern, the form the store keeps), so a
    payload on the card and its host copy stamp the same.  Two payloads with
    identical contents hash identically regardless of container identity, so
    dedup'd shared-tier writes agree on the stamp.
    """
    import numpy as np
    import torch

    h = hashlib.blake2b(digest_size=16)

    def _walk(x: Any) -> None:
        if x is None:
            h.update(b"\x00N")
        elif isinstance(x, dict):
            h.update(b"\x00D%d" % len(x))
            for k in sorted(x, key=repr):
                h.update(repr(k).encode())
                _walk(x[k])
        elif isinstance(x, (tuple, list)):
            h.update(b"\x00T%d" % len(x))
            for v in x:
                _walk(v)
        elif isinstance(x, (bytes, bytearray)):
            h.update(b"\x00B")
            h.update(bytes(x))
        elif isinstance(x, str):
            h.update(b"\x00S")
            h.update(x.encode())
        elif isinstance(x, torch.Tensor):
            t = x.detach()
            if t.dtype == torch.bfloat16:
                _walk(t.view(torch.int16).cpu().numpy().view(np.uint16))
            else:
                _walk(t.cpu().numpy())
        else:
            a = np.asarray(x)
            if a.dtype == object:
                # opaque leaf: tobytes() would hash memory addresses, which
                # don't survive a pickle round-trip — hash the type instead
                # (content changes inside such leaves are not detectable)
                h.update(b"\x00O")
                h.update(type(x).__qualname__.encode())
            else:
                h.update(b"\x00A")
                h.update(str(a.dtype).encode())
                h.update(repr(a.shape).encode())
                h.update(a.tobytes())

    _walk(payload)
    return h.hexdigest()


# --------------------------------------------------------------------------- #
# Fault schedule pieces
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Brownout:
    """A window during which every operation against ``tier`` fails fast
    with ``TierUnavailable`` (no bytes move, nothing is charged)."""

    tier: str
    start_s: float
    end_s: float

    def active(self, now: float) -> bool:
        return self.start_s <= now < self.end_s


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """Kill ``replica`` at simulated time ``at_s`` (cluster-level)."""

    replica: int
    at_s: float


class FaultInjector:
    """Seeded, deterministic fault schedule that storage backends consult.

    Rates are probabilities per *operation* (a retry is a fresh draw).  The
    draw for the n-th operation of a given (tier, key, kind) is a pure hash
    of ``(seed, tier, key, kind, n)`` — no shared RNG stream — so whether an
    operation fails does not depend on what other tiers or replicas did in
    between.  Rates can be global floats or per-tier dicts.
    """

    def __init__(self, seed: int = 0, *,
                 fail_rate: Any = 0.0,
                 corrupt_rate: Any = 0.0,
                 brownouts: Sequence[Brownout] = (),
                 crashes: Sequence[CrashPlan] = ()):
        self.seed = int(seed)
        self._fail_rate = fail_rate
        self._corrupt_rate = corrupt_rate
        self.brownouts: List[Brownout] = list(brownouts)
        self._crashes: List[CrashPlan] = sorted(crashes, key=lambda c: c.at_s)
        self._counts: Dict[Tuple[str, str, str], int] = {}
        # observability: what was actually injected
        self.injected_failures = 0
        self.injected_corruptions = 0
        self.brownout_rejections = 0
        self.crashes_fired = 0

    # -- schedule construction -------------------------------------------- #
    def add_brownout(self, tier: str, start_s: float, end_s: float) -> None:
        self.brownouts.append(Brownout(tier, start_s, end_s))

    def schedule_crash(self, replica: int, at_s: float) -> None:
        self._crashes.append(CrashPlan(replica, at_s))
        self._crashes.sort(key=lambda c: c.at_s)

    def arm(self, *, fail_rate: Any = None, corrupt_rate: Any = None) -> None:
        """Swap rates mid-run — e.g. zero through a jit warm wave, then armed
        for the measured wave (the chaos bench's pattern).  Draw counters are
        untouched: each (tier, key, kind) schedule stays deterministic."""
        if fail_rate is not None:
            self._fail_rate = fail_rate
        if corrupt_rate is not None:
            self._corrupt_rate = corrupt_rate

    # -- draws ------------------------------------------------------------- #
    def _rate(self, table: Any, tier: str) -> float:
        if isinstance(table, dict):
            return float(table.get(tier, table.get("*", 0.0)))
        return float(table)

    def _draw(self, tier: str, key: str, kind: str) -> float:
        """Uniform [0, 1) draw for this operation, advancing the per-(tier,
        key, kind) op counter so repeated attempts redraw independently."""
        k = (tier, key, kind)
        n = self._counts.get(k, 0)
        self._counts[k] = n + 1
        msg = f"{self.seed}|{tier}|{key}|{kind}|{n}".encode()
        h = hashlib.blake2b(msg, digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    # -- queries backends make -------------------------------------------- #
    def browned_out(self, tier: str, now: float) -> bool:
        hit = any(b.tier == tier and b.active(now) for b in self.brownouts)
        if hit:
            self.brownout_rejections += 1
        return hit

    def should_fail(self, tier: str, key: str) -> bool:
        p = self._rate(self._fail_rate, tier)
        if p > 0.0 and self._draw(tier, key, "fail") < p:
            self.injected_failures += 1
            return True
        return False

    def should_corrupt(self, tier: str, key: str) -> bool:
        p = self._rate(self._corrupt_rate, tier)
        if p > 0.0 and self._draw(tier, key, "corrupt") < p:
            self.injected_corruptions += 1
            return True
        return False

    # -- crash schedule (cluster polls this each step) --------------------- #
    def due_crashes(self, now: float) -> List[CrashPlan]:
        """Pop and return every scheduled crash with ``at_s <= now``."""
        due = [c for c in self._crashes if c.at_s <= now]
        if due:
            self._crashes = [c for c in self._crashes if c.at_s > now]
            self.crashes_fired += len(due)
        return due

    def stats(self) -> Dict[str, int]:
        return {
            "injected_failures": self.injected_failures,
            "injected_corruptions": self.injected_corruptions,
            "brownout_rejections": self.brownout_rejections,
            "crashes_fired": self.crashes_fired,
        }


# --------------------------------------------------------------------------- #
# Cost-aware retry policy
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-tier exponential backoff with a cost-aware stop rule.

    ``max_attempts`` bounds total tries (first attempt included).  Before
    attempt ``n+1`` the engine waits ``backoff(n)`` and — when ``cost_aware``
    — retries only while the expected retry cost (backoff + estimated
    reload delay at GPU-second pricing, plus the per-GB refetch fee) still
    beats the marginal cost of recomputing the matched prefix.  Permanent
    failures (``KeyNotFound``, at-rest ``CorruptPayload``) never retry.
    """

    max_attempts: int = 3
    backoff_s: float = 0.005
    backoff_factor: float = 2.0
    cost_aware: bool = True
    tier_max_attempts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def attempts_for(self, tier: Optional[str]) -> int:
        if tier is not None and tier in self.tier_max_attempts:
            return self.tier_max_attempts[tier]
        return self.max_attempts

    def backoff(self, attempt: int) -> float:
        """Wait before attempt ``attempt + 1`` (attempt is 1-based)."""
        return self.backoff_s * self.backoff_factor ** max(0, attempt - 1)

    def retry_cost(self, *, backoff_s: float, est_load_s: float,
                   nbytes: float, gpu_cost_per_s: float,
                   per_gb_fee: float) -> float:
        """Expected dollars spent if we try again: the time the accelerator
        sits idle through backoff + reload, plus the refetch's transfer fee."""
        return gpu_cost_per_s * (backoff_s + est_load_s) \
            + per_gb_fee * nbytes / _GB

    def should_retry(self, exc: BaseException, attempt: int, *,
                     tier: Optional[str] = None,
                     retry_cost: float = 0.0,
                     recompute_cost: float = float("inf")) -> bool:
        if not retryable(exc):
            return False
        if attempt >= self.attempts_for(tier if tier is not None
                                        else getattr(exc, "tier", None)):
            return False
        if self.cost_aware and retry_cost >= recompute_cost:
            return False
        return True
