"""Serving metrics: delay distributions + the paper's cost breakdown,
summarized over the engine's records (``summarize``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

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


