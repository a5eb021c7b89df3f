"""Serving metrics: delay distributions + the paper's cost breakdown,
summarized over the engine's records (``summarize``) or over a typed event
stream (``summarize_events``), and a cluster's aggregate over its replicas'
summaries (``ClusterSummary``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

import numpy as np

from repro_torch.serving.request import RequestRecord


@dataclasses.dataclass
class ServingSummary:
    n_requests: int
    reuse_hits: int
    mean_ttft_s: float
    p50_ttft_s: float
    p99_ttft_s: float
    mean_e2e_s: float
    p99_e2e_s: float
    compute_cost: float
    storage_cost: float
    transfer_cost: float
    horizon_s: float

    @property
    def total_cost(self) -> float:
        return self.compute_cost + self.storage_cost + self.transfer_cost

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["total_cost"] = self.total_cost
        return d


def summarize(
    records: List[RequestRecord],
    *,
    storage_cost: float,
    transfer_cost: float,
) -> ServingSummary:
    # empty runs report NaN latency stats, never a fake 0.0: a consumer
    # averaging summaries must not mistake "no requests" for "instant TTFT"
    ttft = np.array([r.ttft_s for r in records]) if records else np.full(1, np.nan)
    e2e = np.array([r.e2e_s for r in records]) if records else np.full(1, np.nan)
    return ServingSummary(
        n_requests=len(records),
        reuse_hits=sum(
            1 for r in records if r.action in ("load", "partial", "fused")
        ),
        mean_ttft_s=float(ttft.mean()),
        p50_ttft_s=float(np.percentile(ttft, 50)),
        p99_ttft_s=float(np.percentile(ttft, 99)),
        mean_e2e_s=float(e2e.mean()),
        p99_e2e_s=float(np.percentile(e2e, 99)),
        compute_cost=float(sum(r.compute_cost for r in records)),
        storage_cost=storage_cost,
        transfer_cost=transfer_cost,
        horizon_s=float(max((r.finish_s for r in records), default=0.0)),
    )


@dataclasses.dataclass
class ClusterSummary:
    """Aggregate view over N replicas' serving summaries.  Latency stats are
    request-weighted means of the per-replica stats; costs add; the horizon
    is the latest replica's (replicas run on private clocks)."""

    replicas: List[ServingSummary]
    tokens_generated: int = 0

    @property
    def n_requests(self) -> int:
        return sum(s.n_requests for s in self.replicas)

    @property
    def reuse_hits(self) -> int:
        return sum(s.reuse_hits for s in self.replicas)

    @property
    def hit_rate(self) -> float:
        return self.reuse_hits / max(self.n_requests, 1)

    @property
    def total_cost(self) -> float:
        return sum(s.total_cost for s in self.replicas)

    @property
    def horizon_s(self) -> float:
        return max((s.horizon_s for s in self.replicas), default=0.0)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.horizon_s, 1e-9)

    @property
    def mean_ttft_s(self) -> float:
        # idle replicas (0 requests) report NaN stats; they carry no weight
        # here and must not poison the cluster mean
        n = max(self.n_requests, 1)
        return sum(
            s.mean_ttft_s * s.n_requests for s in self.replicas
            if s.n_requests > 0
        ) / n

    def as_dict(self) -> Dict[str, float]:
        return {
            "n_replicas": len(self.replicas),
            "n_requests": self.n_requests,
            "reuse_hits": self.reuse_hits,
            "hit_rate": self.hit_rate,
            "mean_ttft_s": self.mean_ttft_s,
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": self.tokens_per_s,
            "horizon_s": self.horizon_s,
            "total_cost": self.total_cost,
            "per_replica": [s.as_dict() for s in self.replicas],
        }


def summarize_events(
    events: Iterable,
    *,
    storage_cost: float,
    transfer_cost: float,
) -> ServingSummary:
    """Summary from a typed event stream: every finished request's record
    rides on its RequestFinished event, so the stream is self-sufficient."""
    from repro_torch.serving.events import RequestFinished

    records = [e.record for e in events if isinstance(e, RequestFinished)]
    return summarize(
        records, storage_cost=storage_cost, transfer_cost=transfer_cost
    )
