"""The paper's analytical cost/delay model (§2), exactly as published.

Pipelines compared for one context reused ``N`` times over a period ``T``:

  C_text = C_GPU * N * [ T_prefill(L_ctx + L_prompt) + T_decode(L_out) ]

  C_KV   = C_GPU * { N * [ T_decode(L_out) + T_prefill(L_prompt) ]
                     + T_prefill(L_ctx) }                      (compute)
         + C_storage * S_storage(L_ctx) * T                    (storage)
         + C_transmission(S_storage(L_ctx), SLO)               (transmission)

plus the simplified ratio the paper derives:

  C_text / C_KV ≈ 1 + (N-1)/N * T_prefill(L_ctx)
                          / ( T_decode(L_out) + T_prefill(L_prompt) )

Beyond-paper extensions (kept separate, clearly flagged):
  * int8 KV compression factor on S_storage (halves storage+transfer),
  * partial prefix reuse (suffix prefill of the unmatched tail),
  * prefetch overlap in the delay model,
  * O(1) SSM/hybrid stored state (``ArchConfig.fixed_state_bytes``).

The reference's fused-reuse and routed-request terms come with those
features (ROADMAP queue A items 7 and 9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.pricing import GB, Pricing, StorageTier


# --------------------------------------------------------------------------- #
# Workload description (the paper's parameters)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Workload:
    L_context: int
    L_prompt: int
    L_output: int
    N: int  # requests reusing the same context within the period
    period_hours: float = 1.0  # T
    slo_ttft_s: Optional[float] = None  # SLO for time-to-first-token
    decode_batch: int = 1


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute: float
    storage: float
    transmission: float

    @property
    def total(self) -> float:
        return self.compute + self.storage + self.transmission


@dataclasses.dataclass(frozen=True)
class DelayBreakdown:
    load_s: float  # KV fetch from storage (0 for recompute)
    prefill_s: float
    decode_s: float

    @property
    def ttft_s(self) -> float:
        return self.load_s + self.prefill_s

    @property
    def e2e_s(self) -> float:
        return self.ttft_s + self.decode_s


# --------------------------------------------------------------------------- #
# S_storage — stored context state size
# --------------------------------------------------------------------------- #
def s_storage_bytes(
    cfg: ArchConfig, L_context: int, *, dtype_bytes: int = 2, compression: float = 1.0
) -> float:
    """Bytes of stored context state for ``L_context`` tokens.

    Attention KV scales with min(L, window) per SWA layer; SSM/hybrid archs
    add an L-independent (conv, SSD) state term.  ``compression`` < 1 models
    the int8 tier (beyond-paper)."""
    l_eff = min(L_context, cfg.sliding_window) if cfg.sliding_window else L_context
    per_token = cfg.kv_bytes_per_token(dtype_bytes)
    return (per_token * l_eff + cfg.fixed_state_bytes(dtype_bytes)) * compression


# --------------------------------------------------------------------------- #
# The two pipelines
# --------------------------------------------------------------------------- #
def cost_text(
    cfg: ArchConfig, w: Workload, pricing: Pricing, perf: PerfModel
) -> CostBreakdown:
    """Text-recomputation pipeline cost over the period (paper's C_text)."""
    c_gpu = pricing.compute.cost_per_hour / 3600.0  # $/s
    per_req = perf.t_prefill(cfg, w.L_context + w.L_prompt) + perf.t_decode(
        cfg, w.L_output, w.L_context + w.L_prompt, batch=w.decode_batch
    )
    return CostBreakdown(compute=c_gpu * w.N * per_req, storage=0.0, transmission=0.0)


def cost_kv(
    cfg: ArchConfig,
    w: Workload,
    pricing: Pricing,
    perf: PerfModel,
    *,
    tier: Optional[StorageTier] = None,
    compression: float = 1.0,
    reused_fraction: float = 1.0,
) -> CostBreakdown:
    """KV-reuse pipeline cost (paper's C_KV).

    ``reused_fraction`` < 1 models *partial* prefix reuse (beyond-paper): only
    that fraction of the context KV is loaded; the tail is suffix-prefilled.
    """
    tier = tier or pricing.tier()
    c_gpu = pricing.compute.cost_per_hour / 3600.0

    L_reused = int(w.L_context * reused_fraction)
    L_tail = w.L_context - L_reused

    # Compute: one context prefill for the period + per-request prompt(+tail)
    # prefill and decode.
    compute_s = perf.t_prefill(cfg, w.L_context)  # produce the stored KV once
    compute_s += w.N * (
        perf.t_prefill(cfg, w.L_prompt + L_tail)
        + perf.t_decode(cfg, w.L_output, w.L_context + w.L_prompt, batch=w.decode_batch)
    )
    compute = c_gpu * compute_s

    # Storage: GB-hours over the period.
    s_bytes = s_storage_bytes(cfg, w.L_context, compression=compression)
    storage = tier.cost_per_gb_hour * (s_bytes / GB) * w.period_hours

    # Transmission: provisioned-bandwidth fee to meet the TTFT SLO + any
    # per-GB transfer fees for N loads (+ 1 store).
    loaded_bytes = s_bytes * reused_fraction
    required_bw = 0.0
    if w.slo_ttft_s:
        required_bw = loaded_bytes / GB / max(w.slo_ttft_s, 1e-9)  # GB/s
    extra_bw = max(0.0, required_bw - tier.read_bw_gbps * perf.hw.hosts)
    transmission = (
        extra_bw * tier.provisioned_bw_cost_per_gbps_hour * w.period_hours
        + tier.per_gb_transfer_fee * (loaded_bytes * w.N + s_bytes) / GB
    )
    return CostBreakdown(compute=compute, storage=storage, transmission=transmission)


def cost_ratio(
    cfg: ArchConfig,
    w: Workload,
    pricing: Pricing,
    perf: PerfModel,
    **kv_kwargs,
) -> float:
    """C_text / C_KV — > 1 means KV reuse is more economical."""
    return (
        cost_text(cfg, w, pricing, perf).total
        / cost_kv(cfg, w, pricing, perf, **kv_kwargs).total
    )


def simplified_ratio(cfg: ArchConfig, w: Workload, perf: PerfModel) -> float:
    """The paper's closed-form approximation (§2, Insights)."""
    tp_ctx = perf.t_prefill(cfg, w.L_context)
    denom = perf.t_decode(
        cfg, w.L_output, w.L_context + w.L_prompt, batch=w.decode_batch
    ) + perf.t_prefill(cfg, w.L_prompt)
    return 1.0 + (w.N - 1) / w.N * tp_ctx / max(denom, 1e-12)


def break_even_reuses(
    cfg: ArchConfig,
    w: Workload,
    pricing: Pricing,
    perf: PerfModel,
    *,
    tier: Optional[StorageTier] = None,
    compression: float = 1.0,
    max_n: int = 10_000,
) -> Optional[int]:
    """Smallest N with C_KV < C_text (the paper's 'more than once per hour'
    insight); None if reuse never wins within ``max_n``."""
    n = 1
    while n <= max_n:
        wn = dataclasses.replace(w, N=n)
        if cost_kv(cfg, wn, pricing, perf, tier=tier, compression=compression).total < (
            cost_text(cfg, wn, pricing, perf).total
        ):
            return n
        n = n + 1 if n < 16 else int(n * 1.5)
    return None


# --------------------------------------------------------------------------- #
# Fused-prefill pipeline term (CacheBlend-style non-prefix chunk reuse)
# --------------------------------------------------------------------------- #


# --------------------------------------------------------------------------- #
# Cluster routing terms: expected TTFT + $ of sending a request to a replica
# --------------------------------------------------------------------------- #


# --------------------------------------------------------------------------- #
# Delay model (end-to-end, per request)
# --------------------------------------------------------------------------- #
def delay_text(cfg: ArchConfig, w: Workload, perf: PerfModel) -> DelayBreakdown:
    return DelayBreakdown(
        load_s=0.0,
        prefill_s=perf.t_prefill(cfg, w.L_context + w.L_prompt),
        decode_s=perf.t_decode(
            cfg, w.L_output, w.L_context + w.L_prompt, batch=w.decode_batch
        ),
    )


def delay_kv(
    cfg: ArchConfig,
    w: Workload,
    perf: PerfModel,
    *,
    tier: StorageTier,
    compression: float = 1.0,
    reused_fraction: float = 1.0,
    overlap_load: bool = False,
) -> DelayBreakdown:
    """Per-request delay under KV reuse.  ``overlap_load=True`` models the
    beyond-paper prefetch pipeline where the load overlaps queueing/prompt
    prefill (the paper's measured pipeline loads first, then prefills)."""
    s_bytes = s_storage_bytes(cfg, w.L_context, compression=compression)
    load = perf.kv_load_time(s_bytes * reused_fraction, tier)
    L_tail = w.L_context - int(w.L_context * reused_fraction)
    prefill = perf.t_prefill(cfg, w.L_prompt + L_tail)
    if overlap_load:
        # load hidden behind prefill of the prompt; only the excess shows up
        load = max(0.0, load - prefill)
    return DelayBreakdown(
        load_s=load,
        prefill_s=prefill,
        decode_s=perf.t_decode(
            cfg, w.L_output, w.L_context + w.L_prompt, batch=w.decode_batch
        ),
    )
