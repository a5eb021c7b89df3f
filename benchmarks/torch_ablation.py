"""Ablation grid over the port's beyond-paper serving features.

The port's counterpart of ``benchmarks/ablation.py``: one serve of the
port's ``ServingEngine`` per configuration (reduced llama compute, full
llama-7b economics, the paper's 4x V100 and AWS prices), on one workload,
so each feature's contribution to cost and TTFT shows against (a) the
recompute baseline and (b) the paper's plain reuse pipeline.  Times and
dollars are modelled; the ``exact`` column says whether the tokens equal the
recompute row's (the int8 tier is lossy, so its rows may say no).

    PYTHONPATH=src python -m benchmarks.torch_ablation --device cpu
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.perf_model import V100_X4_HF, PerfModel
from repro_torch.core.pricing import AWS_PAPER
from repro_torch.data.synthetic import WorkloadSpec, serving_workload
from repro_torch.kvcache.hierarchy import TierSpec
from repro_torch.models import registry
from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine
from repro_torch.serving.scheduler import HedgePolicy

# The tier hierarchy rows: write-backs land hot (host_dram), the break-even
# pass demotes cold entries toward s3, and the cloud link is bounded so burst
# fetches queue instead of streaming for free in parallel.
_HIERARCHY = dict(
    tier_specs=[
        TierSpec("host_dram", 64.0),
        TierSpec("local_nvme", 512.0),
        TierSpec("s3", 4096.0, concurrency=2),
    ],
    store_tier="host_dram",
    migration_interval_s=1.0,
    spill_on_pressure=True,
)

# config name -> EngineConfig kwargs; every reuse row plans with the
# unconditional-reuse planner so the ablation isolates the execute-side
# features (tiers, overlap, hedging, prefetch), not the policy.
CONFIGS: Dict[str, dict] = {
    "recompute": dict(reuse_enabled=False),
    "paper": dict(),
    "paper+int8": dict(compress_tier="io2"),
    "paper+overlap": dict(overlap_load=True),
    "paper+hedge": dict(hedge=HedgePolicy(threshold_s=0.8)),
    "paper+prefetch": dict(prefetch_lookahead=4),
    "paper+tiers": dict(**_HIERARCHY),
    "beyond(all)": dict(
        compress_tier="io2", overlap_load=True,
        hedge=HedgePolicy(threshold_s=0.8), prefetch_lookahead=4,
    ),
    "beyond+tiers": dict(
        overlap_load=True, hedge=HedgePolicy(threshold_s=0.8),
        prefetch_lookahead=4, **_HIERARCHY,
    ),
}


def sweep(n_requests: int = 18, n_contexts: int = 3, seed: int = 0, *,
          device: str = "cuda", params: Optional[Any] = None) -> List[dict]:
    """One row per configuration.  ``params`` are the reduced llama-7b's
    weights on ``device`` (default: drawn from ``lm.init``'s seeded
    generator)."""
    cfg = reduced_config(get_config("llama-7b"))
    if params is None:
        params = registry.get_model(cfg).init(cfg, seed=0, device=device)
    spec = WorkloadSpec(
        n_contexts=n_contexts,
        reuses_per_context=max(1, n_requests // n_contexts),
        context_len=96, prompt_len=16, output_len=8,
        # bursty arrivals: requests queue behind busy slots, so lookahead
        # prefetch has loads to hide (it is inert on an empty queue)
        arrival_rate_per_s=50.0, seed=seed,
    )
    reqs = serving_workload(cfg, spec)

    rows = []
    ref_tokens = None
    for name, kw in CONFIGS.items():
        eng = ServingEngine(
            cfg, params,
            engine_cfg=EngineConfig(
                max_slots=2, max_len=256, chunk_tokens=16,
                cost_arch="llama-7b", **kw,
            ),
            planner=AlwaysReusePlanner(),
            pricing=AWS_PAPER, perf=PerfModel(V100_X4_HF), device=device,
        )
        for r in reqs:
            eng.submit(Request(**r.__dict__))
        s = eng.run()
        toks = {rec.req_id: rec.tokens for rec in eng.records}
        if name == "recompute":
            ref_tokens = toks
        rows.append(
            {
                "config": name,
                "cost": s.total_cost,
                "ttft": s.mean_ttft_s,
                "p99_e2e": s.p99_e2e_s,
                "hits": s.reuse_hits,
                "tokens_exact": toks == ref_tokens,
            }
        )
    return rows


def lines(rows: List[dict]) -> List[str]:
    """``benchmarks/ablation.py``'s CSV lines for ``rows``."""
    base = rows[0]
    return [
        f"ablation/{r['config']},{r['ttft']*1e6:.0f},"
        f"cost_x={base['cost']/max(r['cost'],1e-12):.2f};"
        f"ttft_x={base['ttft']/max(r['ttft'],1e-9):.2f};"
        f"exact={int(r['tokens_exact'])}"
        for r in rows
    ]


def run(device: str = "cuda", params: Optional[Any] = None) -> List[str]:
    return lines(sweep(device=device, params=params))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the model runs (cuda or cpu)")
    args = ap.parse_args()
    rows = sweep(device=args.device)
    base = rows[0]
    print(f"{'config':<16s} {'cost $':>9s} {'vs base':>8s} {'TTFT s':>8s} {'vs base':>8s} "
          f"{'hits':>5s} {'exact':>6s}")
    for r in rows:
        print(
            f"{r['config']:<16s} {r['cost']:9.4f} {base['cost']/r['cost']:7.2f}x "
            f"{r['ttft']:8.3f} {base['ttft']/max(r['ttft'],1e-9):7.2f}x "
            f"{r['hits']:5d} {str(r['tokens_exact']):>6s}"
        )
