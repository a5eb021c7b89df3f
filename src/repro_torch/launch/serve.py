"""Serving launcher of the port: the reference's ``repro.launch.serve`` with
the same flags, defaults and output, run on the card.

It serves a synthetic context-sharing workload (reduced compute, full-size
economics via the arch's ``cost_arch``).  Weights are random, drawn from a
seeded generator (``lm.init(cfg, seed=0)``).  ``--platform paper`` (the
default) models the paper's 4x V100 at AWS prices, ``--platform h100`` one
H100 at the port's prices; ``--device cpu`` runs it on the CPU through the
kernels' plain versions.  ``--overlap`` charges only the part of each load
that the prefill does not hide, ``--hedge`` hedges reads from the remote
tiers (``HedgePolicy()``), as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \\
        --requests 32 --contexts 8 --policy cost --compress
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.configs import CONFIGS, get_config, reduced_config
from repro_torch.core.perf_model import V100_X4_HF, PerfModel, h100
from repro_torch.core.pricing import AWS_PAPER, h100_pricing
from repro_torch.data.synthetic import WorkloadSpec, serving_workload
from repro_torch.models import registry
from repro_torch.serving import (
    AlwaysReusePlanner,
    CostAwarePlanner,
    EngineConfig,
    ServingEngine,
)
from repro_torch.serving.scheduler import HedgePolicy


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="serving launcher")
    ap.add_argument("--arch", default="llama-7b", choices=sorted(CONFIGS))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--contexts", type=int, default=8)
    ap.add_argument("--context-len", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--output-len", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="cost", choices=["cost", "always", "never"])
    ap.add_argument("--compress", action="store_true", help="int8 storage tier")
    ap.add_argument("--overlap", action="store_true", help="prefetch overlap")
    ap.add_argument("--hedge", action="store_true", help="hedged storage reads")
    ap.add_argument("--platform", default="paper", choices=["paper", "h100"])
    ap.add_argument("--device", default="cuda", help="where the model runs (cuda or cpu)")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="run reduced compute with full-size economics")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    full_cfg = get_config(args.arch)
    cfg = reduced_config(full_cfg) if args.reduced else full_cfg
    ec = EngineConfig(
        max_slots=args.slots,
        max_len=args.context_len + args.prompt_len + args.output_len + 32,
        chunk_tokens=16,
        reuse_enabled=args.policy != "never",
        compress_tier="io2" if args.compress else None,
        overlap_load=args.overlap,
        hedge=HedgePolicy() if args.hedge else None,
        cost_arch=args.arch if args.reduced else None,
    )
    params = registry.get_model(cfg).init(cfg, seed=0, device=args.device)

    if args.platform == "h100":
        pricing, perf = h100_pricing(1), PerfModel(h100(1))
    else:
        pricing, perf = AWS_PAPER, PerfModel(V100_X4_HF)

    planner = AlwaysReusePlanner() if args.policy == "always" else CostAwarePlanner()
    engine = ServingEngine(
        cfg, params, engine_cfg=ec, planner=planner, pricing=pricing, perf=perf,
        device=args.device,
    )

    spec = WorkloadSpec(
        n_contexts=args.contexts,
        reuses_per_context=max(1, args.requests // args.contexts),
        context_len=args.context_len,
        prompt_len=args.prompt_len,
        output_len=args.output_len,
        arrival_rate_per_s=2.0,
    )
    for req in serving_workload(cfg, spec):
        engine.submit(req)
    summary = engine.run()

    if args.json:
        print(json.dumps({**summary.as_dict(), "store": engine.store.stats()}, indent=2))
    else:
        print(f"served {summary.n_requests} requests "
              f"({summary.reuse_hits} reuse hits) on {cfg.name}")
        print(f"  cost ${summary.total_cost:.4f} "
              f"(compute {summary.compute_cost:.4f} / storage {summary.storage_cost:.6f} "
              f"/ transfer {summary.transfer_cost:.6f})")
        print(f"  TTFT mean {summary.mean_ttft_s:.3f}s p99 {summary.p99_ttft_s:.3f}s; "
              f"e2e p99 {summary.p99_e2e_s:.3f}s")


if __name__ == "__main__":
    main()
