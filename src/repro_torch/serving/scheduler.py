"""Admission scheduling + straggler mitigation for the serving engine.

Admission: FIFO by arrival with an SLO-aware twist — among admissible
requests, those whose TTFT SLO would be violated by further queueing are
served first (earliest-deadline-first within the arrived set).

Straggler mitigation: storage loads are *hedged* — if a fetch's modeled delay
exceeds ``threshold_s``, a duplicate fetch is issued against a replica and
the tail is served at ``parallelism``-way speed (classic tail-at-scale
request hedging, applied to the paper's KV-load path).  Decode-side straggler
handling (per-chip) lives in training/fault.py notes and DESIGN.md §7.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    threshold_s: float = 0.5
    parallelism: int = 2
    # duplicate fetches cost extra transfer bytes; accounted by the caller
    extra_bytes_factor: float = 0.2

    def effective_delay(self, delay_s: float) -> float:
        if delay_s <= self.threshold_s:
            return delay_s
        return self.threshold_s + (delay_s - self.threshold_s) / self.parallelism


class AdmissionQueue:
    """Requests ordered by (deadline slack, arrival), as a two-heap scheme.

    ``_pending`` holds not-yet-arrived requests keyed by arrival time;
    ``_promote`` migrates everything whose arrival has passed into ``_ready``,
    an EDF heap keyed by (deadline, arrival, seq).  Pops and pushes are
    O(log n) — the previous implementation linearly scanned and re-heapified
    the whole queue on every pop."""

    def __init__(self):
        self._pending: List = []  # (arrival, seq, deadline, req)
        self._ready: List = []  # (deadline, arrival, seq, req)
        self._seq = 0

    def push(self, req: Request) -> None:
        deadline = (
            req.arrival_s + req.slo_ttft_s if req.slo_ttft_s is not None else float("inf")
        )
        heapq.heappush(self._pending, (req.arrival_s, self._seq, deadline, req))
        self._seq += 1

    def _promote(self, now: float) -> None:
        while self._pending and self._pending[0][0] <= now:
            arrival, seq, deadline, req = heapq.heappop(self._pending)
            heapq.heappush(self._ready, (deadline, arrival, seq, req))

    def pop_admissible(self, now: float) -> Optional[Request]:
        """Earliest-deadline-first among requests that have arrived."""
        self._promote(now)
        if not self._ready:
            return None
        return heapq.heappop(self._ready)[3]

    def next_arrival(self) -> Optional[float]:
        cands = [e[1] for e in self._ready]  # arrived but unadmitted
        if self._pending:
            cands.append(self._pending[0][0])
        return min(cands, default=None)

    def peek_next(self, now: float) -> Optional[Request]:
        """The request ``pop_admissible(now)`` would return, without removing
        it — O(1) (heap root), unlike ``peek_arrived`` which sorts."""
        self._promote(now)
        return self._ready[0][3] if self._ready else None

    def peek_arrived(self, now: float, limit: int = 4) -> List[Request]:
        """Arrived-but-unadmitted requests in admission order (no removal) —
        the prefetch lookahead window."""
        self._promote(now)
        return [e[3] for e in heapq.nsmallest(limit, self._ready)]

    def drain(self) -> List[Request]:
        """Remove and return EVERY queued request (arrived or not) in a
        deterministic order — crash harvesting: a dead replica's queue is
        resubmitted to the survivors through the router."""
        out = [e[3] for e in sorted(self._pending)] + [
            e[3] for e in sorted(self._ready)
        ]
        self._pending.clear()
        self._ready.clear()
        return out

    def __len__(self) -> int:
        return len(self._pending) + len(self._ready)
