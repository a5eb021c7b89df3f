"""Request/slot lifecycle types for the serving engine."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence


class Phase(enum.Enum):
    QUEUED = "queued"
    LOADING = "loading"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    req_id: int
    context_tokens: List[int]
    prompt_tokens: List[int]
    max_new_tokens: int
    arrival_s: float = 0.0
    # expected reuses of this context within the serving period (the paper's
    # N) — drives the write-back break-even decision.
    expected_reuses: float = 1.0
    slo_ttft_s: Optional[float] = None
    eos_token: Optional[int] = None
    embeds: Optional[object] = None  # VLM patch embeddings / audio frames


@dataclasses.dataclass
class RequestRecord:
    req_id: int
    arrival_s: float
    context_len: int
    prompt_len: int
    # outcome
    tokens: List[int] = dataclasses.field(default_factory=list)
    action: str = ""  # recompute | load | partial
    matched_tokens: int = 0
    # the declarative ReusePlan this request executed (typed as object to
    # keep request types dependency-free; see serving/planner.py) — realized
    # load_s/prefill_s below can be audited against its est_ttft_s.
    plan: Optional[object] = None
    start_s: float = 0.0
    load_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    finish_s: float = 0.0
    compute_cost: float = 0.0
    # the planned fetch failed and this request fell back to exact recompute
    # mid-admission (tokens unaffected; load_s carries the wasted fetch time)
    degraded: bool = False

    @property
    def queue_s(self) -> float:
        return self.start_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        return self.queue_s + self.load_s + self.prefill_s

    @property
    def e2e_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclasses.dataclass
class Slot:
    index: int
    request: Optional[Request] = None
    record: Optional[RequestRecord] = None
    generated: int = 0
    last_token: int = 0
    active: bool = False
