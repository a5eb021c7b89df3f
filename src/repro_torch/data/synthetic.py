"""Synthetic data: token streams for training and context-sharing serving
workloads (the paper's TriviaQA-like pattern: many requests share long
contexts), drawn from numpy's seeded generator so the port and the
reference get the same batches and requests from the same seed."""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serving.request import Request


def token_batches(
    cfg: ArchConfig, *, batch: int, seq_len: int, seed: int = 0
) -> Iterator[dict]:
    """Infinite stream of LM training batches (numpy) with a learnable
    structure (a noisy modular-bigram language, so loss demonstrably
    falls); the reference's ``token_batches``, draw for draw."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab
    while True:
        start = rng.integers(0, v, size=(batch, 1))
        steps = rng.integers(1, 7, size=(batch, 1))
        pos = np.arange(seq_len + 1)[None, :]
        seq = (start + steps * pos) % v
        noise = rng.random((batch, seq_len + 1)) < 0.05
        seq = np.where(noise, rng.integers(0, v, size=seq.shape), seq)
        yield {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
            "mask": np.ones((batch, seq_len), np.float32),
        }


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
