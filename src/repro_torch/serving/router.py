"""Cache-affinity routing across serving-engine replicas.

At cluster scale the paper's reuse economics hinge on *which* replica a
request lands on: reuse frequency — the dominant workload parameter — is a
per-replica quantity, so a router that scatters identical contexts across N
replicas divides every entry's frequency by N and can push stored KV below
its break-even point.  This module is the cluster's placement brain:

  * ``ConsistentHashRing``  — baseline placement: the content space is
    consistent-hashed over replicas, so identical contexts gravitate to one
    owner even before anything is stored (and stay put as replicas join or
    leave).
  * ``BloomDigest``         — compact per-replica summary of stored chain /
    chunk-content hashes, exchanged on a gossip tick.  Digests are
    STALENESS-TOLERANT by construction: a false positive or stale bit only
    mis-prices a route (the landing replica recomputes on a miss — tokens
    are unaffected), never corrupts an answer.
  * ``AffinityRouter``      — scores each replica by the marginal cost of
    sending the request there (``cost_model.cost_routed_request``: expected
    queue + fetch + suffix-prefill + decode, GPU-idle $ and per-GB fees
    included) plus a TTFT term, and routes to the argmin — NOT argmax
    overlap: a loaded replica with a perfect digest hit loses to an idle
    one when the queue outweighs the fetch savings.
  * ``RoundRobinRouter``    — the cache-oblivious baseline the benchmark
    compares against.

Both routers enforce the capacity invariant: a request is never sent to a
replica without free capacity while another qualifying replica has some.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import itertools
from typing import List, Optional, Sequence

from repro_torch.core.cost_model import Workload, cost_routed_request, delay_routed
from repro_torch.kvcache.chunks import chunk_hash_chain


# --------------------------------------------------------------------------- #
# Gossip digest
# --------------------------------------------------------------------------- #
class BloomDigest:
    """Bloom filter over a replica's stored hashes (chain hashes, chunk
    content hashes, whole-context content keys — ``TieredStore.digest_hashes``).
    ``m_bits / 8`` bytes travel per gossip tick regardless of store size."""

    __slots__ = ("m", "k", "_bits", "n_added")

    def __init__(self, m_bits: int = 1 << 14, k: int = 4):
        assert m_bits > 0 and k > 0, (m_bits, k)
        self.m = int(m_bits)
        self.k = int(k)
        self._bits = 0
        self.n_added = 0

    def _points(self, h: str):
        for i in range(self.k):
            yield int(
                hashlib.sha256(f"{i}|{h}".encode()).hexdigest()[:16], 16
            ) % self.m

    def add(self, h: str) -> None:
        for p in self._points(h):
            self._bits |= 1 << p
        self.n_added += 1

    def update(self, hashes: Sequence[str]) -> None:
        for h in hashes:
            self.add(h)

    def __contains__(self, h: str) -> bool:
        return all((self._bits >> p) & 1 for p in self._points(h))

    @property
    def fill(self) -> float:
        return bin(self._bits).count("1") / self.m

    @property
    def nbytes(self) -> int:
        """Gossip payload size."""
        return self.m // 8


# --------------------------------------------------------------------------- #
# Consistent-hash baseline placement
# --------------------------------------------------------------------------- #
class ConsistentHashRing:
    """Content space -> replica, stable under membership changes: each
    replica owns ``vnodes`` points on a 2^64 ring; a key belongs to the
    first point clockwise of its hash."""

    def __init__(self, replica_ids: Sequence[int], vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._ids: List[int] = []
        self._points: List[tuple] = []
        for rid in replica_ids:
            self.add(rid)

    @staticmethod
    def _hash(s: str) -> int:
        return int(hashlib.sha256(s.encode()).hexdigest()[:16], 16)

    def add(self, rid: int) -> None:
        if rid in self._ids:
            return
        self._ids.append(rid)
        for v in range(self.vnodes):
            self._points.append((self._hash(f"replica{rid}#{v}"), rid))
        self._points.sort()

    def remove(self, rid: int) -> None:
        self._ids = [r for r in self._ids if r != rid]
        self._points = [(p, r) for p, r in self._points if r != rid]

    def owner(self, key: str) -> int:
        assert self._points, "empty ring"
        h = self._hash(key)
        i = bisect.bisect_right(self._points, (h, float("inf")))
        if i == len(self._points):
            i = 0
        return self._points[i][1]


# --------------------------------------------------------------------------- #
# Router surface
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """Router-visible snapshot of one replica at routing time: load and
    capacity are live (the cluster owns both), the digest is the last
    GOSSIPED one — possibly stale, by design."""

    replica: int
    load: int  # queued + active requests
    free_slots: int  # slots not yet spoken for
    queue_s: float = 0.0  # expected wait before this replica admits
    digest: Optional[BloomDigest] = None
    hit_tier: Optional[str] = None  # tier assumed to serve a digest hit


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    replica: int
    matched_tokens: int  # digest-predicted overlap at the chosen replica
    score: float  # the chosen replica's marginal routing cost ($)
    ring_owner: int  # consistent-hash baseline placement


def _qualifying(views: Sequence[ReplicaView]) -> List[ReplicaView]:
    """Capacity filter shared by every router: never pick a replica without
    free capacity while another qualifying one has some."""
    with_room = [v for v in views if v.free_slots > 0]
    return with_room or list(views)


class RoundRobinRouter:
    """Cache-oblivious baseline: cycle through replicas (capacity-filtered)."""

    def __init__(self):
        self._count = itertools.count()
        self.decisions = 0

    def configure(self, **_) -> None:
        pass

    def decide(self, req, views: Sequence[ReplicaView]) -> RouteDecision:
        cands = _qualifying(views)
        v = cands[next(self._count) % len(cands)]
        self.decisions += 1
        return RouteDecision(
            replica=v.replica, matched_tokens=0, score=0.0, ring_owner=-1
        )

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        return self.decide(req, views).replica

    def stats(self) -> dict:
        return {"decisions": self.decisions}


@dataclasses.dataclass
class AffinityRouter:
    """Route to argmin(expected TTFT + $) over the qualifying replicas.

    Per replica the expected overlap is read off its gossiped digest (the
    longest chain-hash prefix of the request's context present in the
    filter), then priced with the cost model's routed-request terms: the
    replica's queue wait, the matched bytes' fetch from its assumed hit
    tier, the suffix prefill of the rest, decode, GPU-idle $ and per-GB
    fees.  The consistent-hash owner breaks score ties, so a cold cluster
    (no digests yet) still converges: identical contexts co-locate on their
    ring owner, which then starts winning on real overlap."""

    vnodes: int = 64
    # $/s weight on expected TTFT added on top of the marginal cost (which
    # already carries the GPU-idle $ of that same delay): None = the compute
    # rate, i.e. latency is deliberately double-weighted toward fast routes.
    ttft_dollars_per_s: Optional[float] = None

    def __post_init__(self):
        self.ring: Optional[ConsistentHashRing] = None
        self.cost_cfg = None
        self.pricing = None
        self.perf = None
        self.chunk_tokens = 256
        self.compression = 1.0
        # decision audit (telemetry absorbs these): how often the digest
        # predicted overlap, and how often the pick was just the ring owner
        self.decisions = 0
        self.predicted_hits = 0
        self.ring_agreements = 0

    def configure(
        self, *, cost_cfg, pricing, perf, chunk_tokens: int,
        replica_ids: Sequence[int], compression: float = 1.0,
    ) -> None:
        self.cost_cfg = cost_cfg
        self.pricing = pricing
        self.perf = perf
        self.chunk_tokens = int(chunk_tokens)
        self.compression = compression
        self.ring = ConsistentHashRing(replica_ids, vnodes=self.vnodes)
        if self.ttft_dollars_per_s is None:
            self.ttft_dollars_per_s = pricing.compute.cost_per_hour / 3600.0

    # -- digest probe ---------------------------------------------------- #
    def expected_match(self, context_tokens, digest: Optional[BloomDigest]) -> int:
        """Digest-predicted prefix overlap, in tokens: the longest chain-hash
        prefix present in the filter (mirrors the trie's longest_prefix, but
        against a stale, probabilistic summary)."""
        if digest is None or digest.n_added == 0:
            return 0
        matched = 0
        for h in chunk_hash_chain(context_tokens, self.chunk_tokens):
            if h not in digest:
                break
            matched += 1
        return matched * self.chunk_tokens

    def _score(self, req, w: Workload, v: ReplicaView) -> tuple:
        matched = self.expected_match(req.context_tokens, v.digest)
        tier = v.hit_tier if matched > 0 else None
        dollars = cost_routed_request(
            self.cost_cfg, w, self.pricing, self.perf,
            matched_tokens=matched, tier=tier, queue_s=v.queue_s,
            compression=self.compression,
        )
        d = delay_routed(
            self.cost_cfg, w, self.perf, self.pricing,
            matched_tokens=matched, tier=tier, queue_s=v.queue_s,
            compression=self.compression,
        )
        return dollars + self.ttft_dollars_per_s * d.ttft_s, matched

    def decide(self, req, views: Sequence[ReplicaView]) -> RouteDecision:
        assert self.ring is not None, "AffinityRouter.configure() first"
        cands = _qualifying(views)
        w = Workload(
            L_context=len(req.context_tokens),
            L_prompt=len(req.prompt_tokens),
            L_output=req.max_new_tokens,
            N=max(int(req.expected_reuses), 1),
            slo_ttft_s=req.slo_ttft_s,
        )
        owner = self.ring.owner(
            hashlib.sha256(
                "|".join(map(str, req.context_tokens)).encode()
            ).hexdigest()
        )
        best = min(
            cands,
            key=lambda v: (
                self._score(req, w, v)[0],
                0 if v.replica == owner else 1,
                v.replica,
            ),
        )
        score, matched = self._score(req, w, best)
        self.decisions += 1
        self.predicted_hits += 1 if matched > 0 else 0
        self.ring_agreements += 1 if best.replica == owner else 0
        return RouteDecision(
            replica=best.replica, matched_tokens=matched,
            score=score, ring_owner=owner,
        )

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        return self.decide(req, views).replica

    def stats(self) -> dict:
        return {
            "decisions": self.decisions,
            "predicted_hits": self.predicted_hits,
            "ring_agreements": self.ring_agreements,
        }
