"""Synthetic context-sharing serving workloads (the paper's TriviaQA-like
pattern: many requests share long contexts), drawn from numpy's seeded
generator so the port and the reference get the same requests from the
same seed."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serving.request import Request


@dataclasses.dataclass
class WorkloadSpec:
    """The paper's evaluation workload (§3): n_contexts contexts, each reused
    ~reuses times, with Poisson arrivals."""

    n_contexts: int = 200
    reuses_per_context: int = 5
    context_len: int = 10_000
    prompt_len: int = 32
    output_len: int = 32
    arrival_rate_per_s: float = 1.0
    seed: int = 0


def serving_workload(
    cfg: ArchConfig, spec: WorkloadSpec, *, vocab: Optional[int] = None
) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    v = vocab or cfg.vocab
    contexts = [
        list(map(int, rng.integers(0, v, spec.context_len)))
        for _ in range(spec.n_contexts)
    ]
    order = np.repeat(np.arange(spec.n_contexts), spec.reuses_per_context)
    rng.shuffle(order)
    arrivals = np.cumsum(rng.exponential(1.0 / spec.arrival_rate_per_s, len(order)))
    reqs = []
    for i, (cid, t) in enumerate(zip(order, arrivals)):
        reqs.append(
            Request(
                req_id=i,
                context_tokens=contexts[cid],
                prompt_tokens=list(map(int, rng.integers(0, v, spec.prompt_len))),
                max_new_tokens=spec.output_len,
                arrival_s=float(t),
                expected_reuses=spec.reuses_per_context,
            )
        )
    return reqs
