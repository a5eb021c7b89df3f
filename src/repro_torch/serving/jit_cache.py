"""Bucketed jit-compile cache accounting for the packed prefill path.

jax.jit retraces/recompiles whenever an argument *shape* is new, and a packed
ragged prefill has a different total length for almost every admission batch.
The engine therefore rounds the packed q/kv lengths up to power-of-two
buckets (``kvcache.paged.pack_bucket``) so steady-state traffic lands on a
small closed set of shapes.  This module is the observability half: it
mirrors jax's per-shape cache keys and counts hits vs misses (compiles), so
benchmarks can assert "zero steady-state recompiles" from the outside
instead of guessing from wall time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass
class JitBucketStats:
    """Hit/miss bookkeeping over (q_len, kv_len) jit buckets."""

    hits: int = 0
    misses: int = 0
    # consecutive hits since the last compile — "zero steady-state
    # recompiles" means this covers the whole steady phase of a run
    calls_since_miss: int = 0
    # bucket key -> number of calls that landed on it
    calls: Dict[Tuple[int, int], int] = dataclasses.field(default_factory=dict)

    def record(self, key: Tuple[int, int]) -> bool:
        """Account one packed call on ``key``; True iff the compiled kernel
        for this bucket already existed (a jit cache hit)."""
        hit = key in self.calls
        self.calls[key] = self.calls.get(key, 0) + 1
        if hit:
            self.hits += 1
            self.calls_since_miss += 1
        else:
            self.misses += 1
            self.calls_since_miss = 0
        return hit

    @property
    def n_buckets(self) -> int:
        return len(self.calls)

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "n_buckets": self.n_buckets,
            "hit_rate": self.hits / max(self.hits + self.misses, 1),
            "calls_since_miss": self.calls_since_miss,
        }

    def labeled_calls(self) -> Dict[str, int]:
        """``calls`` with metric-label-friendly "QxK" bucket keys — the shape
        the telemetry registry exports (``jit_bucket_calls{bucket="QxK"}``)."""
        return {f"{q}x{k}": n for (q, k), n in self.calls.items()}
