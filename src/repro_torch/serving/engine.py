"""Continuous-batching serving engine, structured as plan -> execute.

The paper's pipeline, end to end: on admission a request's context is looked
up in the ``TieredStore`` (chain-hash prefix match); a ``ReusePlanner`` turns
(request, lookup, workload) into a declarative ``ReusePlan`` (recompute /
load / partial-load, plus write-back); the engine executes it — storage
fetch through the tier's backend, one packed suffix-prefill of every
admitted request's unmatched context tail and prompt, break-even-gated
write-back — and decode runs batched across slots, one dense step at a time.

The engine is step-driven: ``submit()`` enqueues, ``step()`` performs one
scheduling step (admit a batch of requests, or one batched decode step, or a
clock jump to the next arrival) and returns the typed ``events`` it
produced; ``drain()`` iterates steps to completion; ``run()`` drains and
summarizes.

This is the port of the JAX engine's main path under the default
``EngineConfig``.  Compute runs eagerly in PyTorch (no jit): on CUDA tensors
the attention goes through the hand-written kernels, on CPU tensors through
their plain versions.  Times and dollars are modelled (``PerfModel``), as in
the reference, so the reference's golden records replay on the port.  The
paths behind non-default options (paged decode, the unified step, fused
reuse, the int8 tier, faults, hedging, prefetch, migration, the market) and
the per-request admission path raise ``NotImplementedError`` naming the
ROADMAP item that will carry them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import Workload, s_storage_bytes
from repro_torch.core.perf_model import PerfModel, h100
from repro_torch.core.pricing import Pricing, h100_pricing
from repro_torch.kvcache import paged
from repro_torch.kvcache.backend import StorageBackend
from repro_torch.kvcache.faults import RetryPolicy, StorageError
from repro_torch.kvcache.hierarchy import (
    BreakEvenMigrator,
    TieredStore,
    TierSpec,
    build_backends,
)
from repro_torch.kvcache.transfer import SimClock, TransferModel
from repro_torch.models import registry
from repro_torch.models.common import resolve_device
from repro_torch.serving import events as ev
from repro_torch.serving import metrics as metrics_mod
from repro_torch.serving.jit_cache import JitBucketStats
from repro_torch.serving.planner import (
    CostAwarePlanner,
    ReusePlan,
    ReusePlanner,
    StoreLookup,
)
from repro_torch.serving.request import Request, RequestRecord, Slot
from repro_torch.serving.scheduler import AdmissionQueue, HedgePolicy


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine options; see ``_NOT_PORTED`` for the ones the
    port does not carry yet."""

    max_slots: int = 4
    max_len: int = 512
    chunk_tokens: int = 16
    reuse_enabled: bool = True
    tier_capacities_gb: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"host_dram": 64.0, "io2": 1024.0}
    )
    # Full hierarchy declaration (fastest first); overrides tier_capacities_gb
    # and enables per-tier backend kinds + link concurrency limits.
    tier_specs: Optional[List[TierSpec]] = None
    # Tier write-backs land in (default: the last/cheapest tier).
    store_tier: Optional[str] = None
    migration_interval_s: float = 0.0
    migration_policy: Optional[BreakEvenMigrator] = None
    # Under capacity pressure, demote the least valuable entry one tier down
    # instead of deleting it outright.
    spill_on_pressure: bool = False
    compress_tier: Optional[str] = None
    overlap_load: bool = False
    hedge: Optional[HedgePolicy] = None
    eviction: str = "cost"
    store_write_back: bool = True
    # Economics-at-scale: model times/costs as if serving this FULL arch while
    # the actual compute uses a reduced config.  None = the served config.
    cost_arch: Optional[str] = None
    prefetch_lookahead: int = 0
    # Max requests admitted per step as one packed ragged prefill (None =
    # every admissible request with a free slot).
    admit_batch: Optional[int] = None
    # Each segment's kv span starts at a multiple of this, so a kernel kv
    # tile never mixes two requests.
    pack_align: int = 128
    # Smallest bucket for the packed q length (lengths round up to the next
    # power of two, so steady traffic reuses a small set of launch shapes).
    pack_bucket_min: int = 16
    paged_decode: bool = False
    kv_block: int = 128
    fusion_enabled: bool = False
    unified_step: bool = False
    step_token_budget: int = 160
    faults: Optional[Any] = None
    # Cost-aware retry applied when a planned fetch fails.  None =
    # RetryPolicy() defaults.
    retry_policy: Optional[RetryPolicy] = None
    # Contexts shorter than this many tokens are never written back.
    min_cache_tokens: int = 0


# option -> the ROADMAP item that will carry it (set away from its default,
# each raises NotImplementedError rather than silently taking another path)
_NOT_PORTED = {
    "paged_decode": "queue B item 4 (paged_decode_attention, the next slice)",
    "kv_block": "queue B item 4 (paged_decode_attention, the next slice)",
    "unified_step": "queue A item 6 (unified continuous batching)",
    "step_token_budget": "queue A item 6 (unified continuous batching)",
    "fusion_enabled": "queue A item 7 (fused reuse)",
    "compress_tier": "queue A item 8 (compressed tier)",
    "faults": "queue A item 9 (faults, cluster and router)",
    "hedge": "queue A item 9 (faults, cluster and router)",
    "overlap_load": "queue A item 9 (faults, cluster and router)",
    "prefetch_lookahead": "queue A item 9 (faults, cluster and router)",
    "migration_interval_s": "queue A item 9 (faults, cluster and router)",
    "migration_policy": "queue A item 9 (faults, cluster and router)",
}


def _check_ported(ec: EngineConfig) -> None:
    default = EngineConfig()
    for field, item in _NOT_PORTED.items():
        if getattr(ec, field) != getattr(default, field):
            raise NotImplementedError(
                f"EngineConfig.{field} is not ported yet: ROADMAP {item}"
            )


@dataclasses.dataclass
class _Admission:
    """One request's admission in flight: plan phase fills the first five
    fields, packed execution the rest."""

    req: Request
    rec: RequestRecord
    slot: Slot
    plan: ReusePlan
    lookup: StoreLookup
    artifact: Any = None  # fetched stored state (None = recompute)
    delay: float = 0.0  # storage fetch delay
    load_s: float = 0.0  # delay charged to this request
    nbytes: float = 0.0
    matched: int = 0
    new_tokens: List[int] = dataclasses.field(default_factory=list)


class ServingEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        *,
        engine_cfg: Optional[EngineConfig] = None,
        planner: Optional[ReusePlanner] = None,
        backends: Optional[Dict[str, StorageBackend]] = None,
        pricing: Optional[Pricing] = None,
        perf: Optional[PerfModel] = None,
        clock: Optional[SimClock] = None,
        transfer: Optional[TransferModel] = None,
        on_token=None,
        device=None,
    ):
        """``device`` is where the model runs: the card unless the caller
        asks for another (``device="cpu"``); with no CUDA and no device
        given, this raises.  ``params`` must already live there."""
        self.cfg = cfg
        self.params = params
        self.ec = engine_cfg or EngineConfig()
        _check_ported(self.ec)
        self.device = resolve_device(device)
        self.pricing = pricing or h100_pricing(1)
        self.perf = perf or PerfModel(h100(1))
        self.api = registry.get_model(cfg)
        if not paged.packable_arch(cfg, self.ec.max_len):
            raise NotImplementedError(
                f"{cfg.name} cannot be packed at max_len={self.ec.max_len}: the "
                "per-request admission path is ROADMAP queue B item 3 (flash_attention)"
            )
        if self.ec.cost_arch is not None:
            from repro_torch.configs import get_config

            self.cost_cfg = get_config(self.ec.cost_arch)
        else:
            self.cost_cfg = cfg

        self.clock = clock or SimClock()
        self.transfer = transfer or TransferModel(self.perf, self.pricing)
        # streaming per-token hook: called with every TokenEmitted event
        self.on_token = on_token
        self._c_gpu_s = self.pricing.compute.cost_per_hour / 3600.0
        if self.ec.tier_specs is not None:
            specs = list(self.ec.tier_specs)
        else:
            specs = [TierSpec(n, gb) for n, gb in self.ec.tier_capacities_gb.items()]
        self.backends = backends or build_backends(
            specs, transfer=self.transfer, clock=self.clock
        )
        self.retry_policy = self.ec.retry_policy or RetryPolicy()
        self.store = TieredStore(
            tiers=specs,
            transfer=self.transfer,
            clock=self.clock,
            chunk_tokens=self.ec.chunk_tokens,
            eviction=self.ec.eviction,
            backends=self.backends,
            pricing=self.pricing,
            spill_on_pressure=self.ec.spill_on_pressure,
        )
        self.planner: ReusePlanner = planner or CostAwarePlanner()
        self.planner.configure(
            cost_cfg=self.cost_cfg,
            pricing=self.pricing,
            perf=self.perf,
            write_back=self.ec.reuse_enabled and self.ec.store_write_back,
            min_store_tokens=max(self.ec.chunk_tokens, self.ec.min_cache_tokens),
        )
        self.queue = AdmissionQueue()
        self.slots = [Slot(i) for i in range(self.ec.max_slots)]
        self.records: List[RequestRecord] = []
        self._state = self.api.init_state(
            cfg, self.ec.max_slots, self.ec.max_len, device=self.device
        )
        # packed-admission observability: launch-shape buckets (the same
        # (q_len, kv_len) keys as the reference's jit cache counters)
        self.jit_stats = JitBucketStats()
        self.batches = 0
        self.packed_q_tokens = 0  # useful tokens through the packed kernel
        self.packed_q_len = 0  # padded (bucketed) tokens launched
        self.lookup_walks = 0  # real trie walks
        self.admission_busy_s = 0.0  # modeled time spent in load+prefill
        self.decode_busy_s = 0.0  # modeled time spent in decode steps
        self.decode_tokens = 0  # tokens emitted by decode steps
        self.decode_steps = 0  # batched decode launches

    # ------------------------------------------------------------------ #
    # Public API: submit / step / drain / run
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        if req.embeds is not None:
            raise NotImplementedError(
                "embedding contexts take the per-request admission path: "
                "ROADMAP queue B item 3 (flash_attention)"
            )
        self.queue.push(req)

    @property
    def idle(self) -> bool:
        """Nothing queued and nothing decoding."""
        return len(self.queue) == 0 and not any(s.active for s in self.slots)

    def step(self) -> List[ev.Event]:
        """Advance the engine by one scheduling step and return its events:
        admit every admissible request with a free slot as one packed batch
        (one ragged suffix-prefill launch per layer), else run one batched
        decode step, else jump the clock to the next arrival."""
        events: List[ev.Event] = []
        if self._admit_batch(events):
            return events
        if any(s.active for s in self.slots):
            self._decode_step(events)
            return events
        nxt = self.queue.next_arrival()
        if nxt is not None:
            self.clock.at_least(nxt)
            events.append(ev.ClockAdvanced(t_s=self.clock.now, req_id=-1, to_s=nxt))
        return events

    def drain(self) -> Iterator[ev.Event]:
        """Iterate events until every submitted request has finished."""
        while not self.idle:
            yield from self.step()

    def run(self) -> metrics_mod.ServingSummary:
        """Serve everything submitted; returns the summary."""
        for _ in self.drain():
            pass
        return self.summary()

    def summary(self) -> metrics_mod.ServingSummary:
        return metrics_mod.summarize(
            self.records,
            storage_cost=self.store.storage_cost(self.pricing),
            transfer_cost=self.transfer.transfer_fees(),
        )

    def packed_stats(self) -> Dict[str, Any]:
        """Packed-admission counters: launch-shape bucket hits and misses,
        packing occupancy, trie walks and modeled admission busy time."""
        return {
            "jit": self.jit_stats.as_dict(),
            "batches": self.batches,
            "packed_q_tokens": self.packed_q_tokens,
            "packed_q_len": self.packed_q_len,
            "occupancy": self.packed_q_tokens / max(self.packed_q_len, 1),
            "lookup_walks": self.lookup_walks,
            "admission_busy_s": self.admission_busy_s,
        }

    def decode_stats(self) -> Dict[str, Any]:
        """Decode-side counters: steps, tokens and modeled busy time."""
        return {
            "decode_steps": self.decode_steps,
            "decode_busy_s": self.decode_busy_s,
            "decode_tokens": self.decode_tokens,
        }

    # ------------------------------------------------------------------ #
    # Admission: pop -> plan (per request) -> execute (one packed batch)
    # ------------------------------------------------------------------ #
    def _admit_batch(self, events: List[ev.Event]) -> bool:
        """Admit every admissible request with a free slot (up to
        ``admit_batch``): plan each individually, then execute all their
        suffix-prefills as ONE packed ragged launch."""
        free = [s for s in self.slots if not s.active]
        if not free:
            return False
        limit = min(len(free), self.ec.admit_batch or self.ec.max_slots)
        reqs: List[Request] = []
        while len(reqs) < limit and self.queue.peek_next(self.clock.now) is not None:
            reqs.append(self.queue.pop_admissible(self.clock.now))
        if not reqs:
            return False

        # Plan sequentially, carrying each planned fetch's bytes forward so
        # batch-mate i's predicted queue wait sees mates 0..i-1 on the same
        # contended link.
        pending: Dict[str, List[float]] = {}
        admissions: List[_Admission] = []
        for req, slot in zip(reqs, free):
            a = self._plan_admission(req, slot, events, pending=pending)
            admissions.append(a)
            if a.plan.loads_kv and a.lookup.entry is not None:
                pending.setdefault(a.lookup.entry.tier, []).append(
                    self._entry_fetch_bytes(a.lookup.entry, a.plan.matched_tokens)
                )
        self._execute_packed(admissions, events)
        return True

    def _plan_admission(
        self,
        req: Request,
        slot: Slot,
        events: List[ev.Event],
        pending: Optional[Dict[str, List[float]]] = None,
    ) -> _Admission:
        rec = RequestRecord(
            req_id=req.req_id,
            arrival_s=req.arrival_s,
            context_len=len(req.context_tokens),
            prompt_len=len(req.prompt_tokens),
            start_s=self.clock.now,
        )
        total_len = len(req.context_tokens) + len(req.prompt_tokens) + req.max_new_tokens
        if total_len > self.ec.max_len:
            raise ValueError(
                f"request {req.req_id} needs {total_len} tokens > max_len {self.ec.max_len}"
            )
        events.append(
            ev.RequestAdmitted(
                t_s=self.clock.now, req_id=req.req_id, slot=slot.index,
                queue_s=rec.queue_s,
            )
        )
        lookup = self._lookup(req, pending)
        workload = Workload(
            L_context=len(req.context_tokens),
            L_prompt=len(req.prompt_tokens),
            L_output=req.max_new_tokens,
            N=max(int(req.expected_reuses), 1),
            slo_ttft_s=req.slo_ttft_s,
        )
        plan = self.planner.plan(req, lookup, workload)
        if plan.action not in ("recompute", "load", "partial") or plan.market is not None:
            raise NotImplementedError(
                f"plan action {plan.action!r} is not ported yet (ROADMAP queue A items 7, 11)"
            )
        events.append(ev.PlanChosen(t_s=self.clock.now, req_id=req.req_id, plan=plan))
        return _Admission(req=req, rec=rec, slot=slot, plan=plan, lookup=lookup)

    def _finish_admission(self, a: _Admission, first_tok: int, events: List[ev.Event]) -> None:
        """Admission epilogue (post clock-advance): record the action, emit
        the first token, activate the slot."""
        a.rec.action = (
            a.plan.action if (a.plan.reuses_kv and not a.rec.degraded) else "recompute"
        )
        a.rec.plan = a.plan
        a.rec.tokens.append(first_tok)
        tok_ev = ev.TokenEmitted(
            t_s=self.clock.now, req_id=a.req.req_id, token=first_tok, index=0
        )
        events.append(tok_ev)
        if self.on_token is not None:
            self.on_token(tok_ev)
        a.slot.request = a.req
        a.slot.record = a.rec
        a.slot.generated = 1
        a.slot.last_token = first_tok
        a.slot.active = True
        self._maybe_finish(a.slot, events)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _execute_packed(self, admissions: List[_Admission], events: List[ev.Event]) -> None:
        """Execute an admission batch as one packed ragged suffix-prefill:
        per-request storage fetches (queueing on contended links is modeled
        at the shared admission instant), one launch per layer over the
        concatenated token runs, outputs scattered back into each request's
        batch slot."""
        t0 = self.clock.now
        for a in admissions:
            if a.plan.loads_kv and a.lookup.entry is not None:
                self._fetch_kv_resilient(a, events)
            ctx = list(a.req.context_tokens)
            a.new_tokens = ctx[a.matched:] + list(a.req.prompt_tokens)

        layout = paged.pack_layout(
            [a.slot.index for a in admissions],
            [a.matched for a in admissions],
            [len(a.new_tokens) for a in admissions],
            align=self.ec.pack_align,
            bucket_min=self.ec.pack_bucket_min,
        )
        arrays = paged.pack_arrays(layout, [a.new_tokens for a in admissions])
        caches = paged.build_packed_caches(
            self.cfg, layout, [a.artifact for a in admissions], self.device
        )
        last_idx = np.zeros((self.ec.max_slots,), np.int64)
        for i, seg in enumerate(layout.segments):
            last_idx[i] = seg.q_last
        jit_hit = self.jit_stats.record((layout.q_len, layout.kv_len))
        self.batches += 1
        self.packed_q_tokens += layout.q_tokens
        self.packed_q_len += layout.q_len
        events.append(
            ev.BatchAdmitted(
                t_s=t0, req_id=-1,
                req_ids=tuple(a.req.req_id for a in admissions),
                q_tokens=layout.q_tokens, q_len=layout.q_len,
                kv_len=layout.kv_len, jit_hit=jit_hit,
            )
        )

        with torch.inference_mode():
            logits, new_caches = self.api.prefill_packed(
                self.params, self.cfg, self._tensor(arrays["tokens"]), caches,
                q_pos=self._tensor(arrays["q_pos"]), q_seg=self._tensor(arrays["q_seg"]),
                q_rows=self._tensor(arrays["q_rows"]), kv_pos=self._tensor(arrays["kv_pos"]),
                kv_seg=self._tensor(arrays["kv_seg"]), last_idx=self._tensor(last_idx),
            )
        first = logits.argmax(dim=-1).tolist()

        lens = [len(a.new_tokens) for a in admissions]
        prefill_s = self.perf.t_prefill_packed(self.cost_cfg, lens)
        total_new = sum(lens)
        written = set()  # contexts written back within THIS batch (dedup:
        # several batch-mates recomputing the same context store it once)
        for a, seg in zip(admissions, layout.segments):
            if a.artifact is not None:
                a.load_s = a.delay
                events.append(
                    ev.KVLoaded(
                        t_s=t0, req_id=a.req.req_id, tier=a.lookup.entry.tier,
                        nbytes=a.nbytes, load_s=a.load_s, matched_tokens=a.matched,
                    )
                )
            else:
                if a.rec.degraded:
                    # the burned fetch time still delays this request (and,
                    # through the batch barrier below, its batch-mates)
                    a.load_s = a.delay
                if a.plan.store_after and tuple(a.req.context_tokens) not in written:
                    written.add(tuple(a.req.context_tokens))
                    art = paged.packed_to_artifact(
                        self.cfg, new_caches, seg, len(a.req.context_tokens)
                    )
                    self._write_back(a.req, paged.artifact_to_host(art), events)
            events.append(
                ev.PrefillDone(
                    t_s=t0, req_id=a.req.req_id,
                    n_tokens=len(a.new_tokens), prefill_s=prefill_s,
                )
            )

        batch_load = max((a.load_s for a in admissions), default=0.0)
        self.clock.advance(batch_load + prefill_s)
        self.admission_busy_s += batch_load + prefill_s

        for i, (a, seg) in enumerate(zip(admissions, layout.segments)):
            paged.insert_slot(
                self.cfg, self._state, seg.slot,
                paged.packed_to_artifact(self.cfg, new_caches, seg, seg.n_total),
            )
            a.rec.matched_tokens = a.matched
            # every batch member waits the load BARRIER (max of the batch's
            # fetches) before the shared launch
            a.rec.load_s = batch_load
            a.rec.prefill_s = prefill_s
            a.rec.compute_cost += self._c_gpu_s * prefill_s * (len(a.new_tokens) / total_new)
            self._finish_admission(a, int(first[i]), events)

    # -- storage fetch with cost-aware retry ----------------------------- #
    def _fetch_kv(self, req: Request, plan: ReusePlan, lookup: StoreLookup):
        """Charge + execute the storage fetch of a load/partial plan; returns
        (artifact, delay_s, billed_nbytes)."""
        entry = lookup.entry
        matched = plan.matched_tokens
        nbytes = plan.fetch_bytes
        override = None
        if self.cost_cfg is not self.cfg:
            # economics-at-scale: charge the FULL arch's KV bytes, and occupy
            # the tier's link for them
            nbytes = self._entry_fetch_bytes(entry, matched)
            override = nbytes
        artifact, delay = self.store.fetch(
            entry.entry_id, fraction=matched / entry.n_tokens, nbytes=override
        )
        return artifact, delay, nbytes

    def _fetch_kv_resilient(self, a: _Admission, events: List[ev.Event]) -> None:
        """Execute a load/partial plan's fetch under the retry policy.  On
        success fills ``a.artifact/delay/nbytes/matched``; on exhaustion
        leaves ``a.artifact`` None with the wasted time on ``a.delay`` and
        marks the record degraded — the request falls back to recompute."""
        req, plan, entry = a.req, a.plan, a.lookup.entry
        nbytes = plan.fetch_bytes
        if self.cost_cfg is not self.cfg:
            nbytes = self._entry_fetch_bytes(entry, plan.matched_tokens)
        policy = self.retry_policy
        wasted = 0.0
        attempt = 0
        while True:
            attempt += 1
            try:
                artifact, delay, billed = self._fetch_kv(req, plan, a.lookup)
                break
            except StorageError as exc:
                wasted += exc.delay_s
                events.append(ev.FetchFailed(
                    t_s=self.clock.now, req_id=req.req_id, tier=entry.tier,
                    entry_id=entry.entry_id, attempt=attempt, reason=exc.reason,
                    wasted_s=exc.delay_s, wasted_bytes=exc.wasted_bytes,
                ))
                backoff = policy.backoff(attempt)
                retry_cost = policy.retry_cost(
                    backoff_s=backoff,
                    est_load_s=self.store.estimate_load_delay(entry.tier, nbytes),
                    nbytes=nbytes,
                    gpu_cost_per_s=self._c_gpu_s,
                    per_gb_fee=self.pricing.tier(entry.tier).per_gb_transfer_fee,
                )
                recompute_cost = self._c_gpu_s * self.perf.t_prefill(
                    self.cost_cfg, max(plan.matched_tokens, 1)
                )
                if policy.should_retry(exc, attempt, tier=entry.tier,
                                       retry_cost=retry_cost,
                                       recompute_cost=recompute_cost):
                    wasted += backoff
                    events.append(ev.FetchRetried(
                        t_s=self.clock.now, req_id=req.req_id, tier=entry.tier,
                        entry_id=entry.entry_id, attempt=attempt + 1, backoff_s=backoff,
                    ))
                    continue
                a.rec.degraded = True
                a.artifact, a.nbytes, a.matched = None, 0.0, 0
                a.delay = wasted
                events.append(ev.DegradedToRecompute(
                    t_s=self.clock.now, req_id=req.req_id, tier=entry.tier,
                    entry_id=entry.entry_id, attempts=attempt, wasted_s=wasted,
                    reason="fetch_exhausted",
                ))
                return
        a.artifact, a.nbytes = artifact, billed
        a.delay = wasted + delay
        a.matched = plan.matched_tokens

    def _write_back(self, req: Request, artifact: Any, events: List[ev.Event]) -> None:
        ctx = list(req.context_tokens)
        saved = self._c_gpu_s * self.perf.t_prefill(self.cost_cfg, len(ctx))
        entry_id, _ = self.store.put(
            ctx, artifact, tier=self._store_tier(), saved_per_use=saved
        )
        self._emit_migrations(events)
        if entry_id is not None:
            e = self.store.entries[entry_id]
            events.append(
                ev.StoreWriteBack(
                    t_s=self.clock.now, req_id=req.req_id,
                    entry_id=entry_id, tier=e.tier, nbytes=e.nbytes,
                )
            )

    def _emit_migrations(self, events: List[ev.Event]) -> None:
        """Surface capacity-pressure spills of a put as typed events."""
        for m in self.store.drain_migrations():
            events.append(
                ev.TierMigrated(
                    t_s=m.t_s, req_id=-1, entry_id=m.entry_id,
                    from_tier=m.from_tier, to_tier=m.to_tier,
                    nbytes=m.nbytes, reason=m.reason,
                )
            )

    def _lookup(
        self, req: Request, pending: Optional[Dict[str, List[float]]] = None
    ) -> StoreLookup:
        """Consult the store about the request's context; quantify how much of
        it the architecture can consume.  ``pending`` — per-tier fetch bytes
        already planned by earlier batch-mates this admission instant,
        folded into the predicted queue wait."""
        if not self.ec.reuse_enabled:
            return StoreLookup.miss()
        match, entry = self.store.lookup(list(req.context_tokens))
        self.lookup_walks += 1
        partial_ok = paged.partial_reuse_allowed(self.cfg)
        frac = 0.0
        n_ctx = len(req.context_tokens)
        if entry is not None and match.matched_tokens > 0:
            if match.matched_tokens >= n_ctx:
                frac = 1.0
            elif partial_ok:
                frac = match.matched_tokens / n_ctx
        queue_wait: Dict[str, float] = {}
        if entry is not None and frac > 0:
            ahead = () if pending is None else tuple(pending.get(entry.tier, ()))
            wait = self.store.estimated_queue_wait(
                entry.tier,
                self._entry_fetch_bytes(entry, match.matched_tokens),
                pending=ahead,
            )
            if wait > 0:
                queue_wait[entry.tier] = wait
        return StoreLookup(
            match=match, entry=entry, fraction=frac, partial_ok=partial_ok,
            queue_wait_s=queue_wait,
        )

    def _entry_fetch_bytes(self, e, matched_tokens: int) -> float:
        """Bytes a fetch of ``matched_tokens`` moves, at economics scale."""
        if self.cost_cfg is not self.cfg:
            return s_storage_bytes(self.cost_cfg, matched_tokens)
        return e.nbytes * matched_tokens / max(e.n_tokens, 1)

    def _store_tier(self) -> str:
        if self.ec.store_tier is not None:
            return self.ec.store_tier
        return self.store.tier_order[-1]  # cloud tier (paper's EBS)

    # ------------------------------------------------------------------ #
    # Batched dense decode
    # ------------------------------------------------------------------ #
    def _decode_step(self, events: List[ev.Event]) -> None:
        active = np.array([s.active for s in self.slots])
        toks = np.array([[s.last_token if s.active else 0] for s in self.slots], np.int32)
        state = self._state
        with torch.inference_mode():
            logits, new_state = self.api.decode(
                self.params, self.cfg, self._tensor(toks), state
            )
        # inactive slots keep their position (their cache row writes are
        # masked by position for the next request placed there)
        self._state = new_state._replace(
            pos=torch.where(self._tensor(active), new_state.pos, state.pos)
        )
        nxt = logits.argmax(dim=-1).tolist()
        n_active = int(active.sum())
        lens = [
            s.record.context_len + s.record.prompt_len + s.generated
            for s in self.slots
            if s.active
        ]
        step_s = self.perf.t_decode(self.cost_cfg, 1, max(lens), batch=n_active)
        self.decode_steps += 1
        self.decode_busy_s += step_s
        self.decode_tokens += n_active
        self.clock.advance(step_s)
        cost = self._c_gpu_s * step_s / n_active
        for s in self.slots:
            if not s.active:
                continue
            tok = int(nxt[s.index])
            s.record.tokens.append(tok)
            s.record.decode_s += step_s
            s.record.compute_cost += cost
            s.last_token = tok
            tok_ev = ev.TokenEmitted(
                t_s=self.clock.now, req_id=s.request.req_id, token=tok, index=s.generated,
            )
            events.append(tok_ev)
            if self.on_token is not None:
                self.on_token(tok_ev)
            s.generated += 1
            self._maybe_finish(s, events)

    def _maybe_finish(self, s: Slot, events: List[ev.Event]) -> None:
        req = s.request
        done = s.generated >= req.max_new_tokens or (
            req.eos_token is not None and s.last_token == req.eos_token
        )
        if done:
            s.record.finish_s = self.clock.now
            self.records.append(s.record)
            events.append(
                ev.RequestFinished(t_s=self.clock.now, req_id=req.req_id, record=s.record)
            )
            s.active = False
            s.request = None
