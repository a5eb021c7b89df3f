"""Console dashboard: one readable text block over a Telemetry session.

``chip_smoke.py`` prints this after its telemetry serve — the
headline cache-hit-rate gauge first (the production metric that matters),
then latency histograms, then the cost ledger's "where did the money go"
tables, then the conservation residuals against the run's summary.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.obs.telemetry import Telemetry


def _hist_line(tel: Telemetry, name: str, label: str, replica) -> Optional[str]:
    m = tel.registry.get(name)
    if m is None:
        return None
    s = m.hist(replica=replica)
    if s is None or s.n == 0:
        return None
    return (
        f"  {label:<12s} n={s.n:<5d} mean={s.total / s.n:8.4f}s "
        f"p50~{s.quantile(0.5):8.4f}s p90~{s.quantile(0.9):8.4f}s"
    )


def render(tel: Telemetry, summary=None, *, top_n: int = 5) -> str:
    lines: List[str] = ["== telemetry dashboard =="]
    hit = tel.registry.get("kv_cache_hit_rate")
    hit_v = hit.value() if hit is not None and hit.series else float("nan")
    tokens = tel.registry.get("tokens_emitted_total")
    n_tokens = sum(tokens.series.values()) if tokens else 0
    reqs = tel.registry.get("serving_requests_total")
    n_reqs = sum(reqs.series.values()) if reqs else 0
    lines.append(
        f"cache hit rate {hit_v:.3f} | {int(n_reqs)} requests | "
        f"{int(n_tokens)} tokens"
    )

    replicas = sorted(
        {rep for rep, _ in tel.events} | {0}
    )
    lines.append("latency:")
    for rep in replicas:
        rep_lines = [
            h for h in (
                _hist_line(tel, "queue_wait_seconds", "queue wait", rep),
                _hist_line(tel, "ttft_seconds", "TTFT", rep),
                _hist_line(tel, "tbt_seconds", "TBT", rep),
                _hist_line(tel, "e2e_seconds", "e2e", rep),
            ) if h is not None
        ]
        if rep_lines:
            lines.append(f" replica {rep}:")
            lines.extend(rep_lines)

    lines.append("cost ledger ($):")
    totals = tel.ledger.totals()
    lines.append(
        f"  compute {totals['compute']:.6f}  storage {totals['storage']:.6f}"
        f"  transfer {totals['transfer']:.6f}  total {tel.ledger.total():.6f}"
    )
    by_act = tel.ledger.by_activity()
    if by_act:
        lines.append("  by activity: " + "  ".join(
            f"{a}={d:.6f}" for a, d in sorted(by_act.items())
        ))
    by_tier = tel.ledger.by_tier()
    if by_tier:
        lines.append("  by tier:     " + "  ".join(
            f"{t}={d:.6f}" for t, d in sorted(by_tier.items())
        ))
    infra = tel.ledger.infrastructure_total()
    lines.append(f"  infrastructure (unattributed to requests): {infra:.6f}")
    top = sorted(
        tel.ledger.by_request().items(), key=lambda kv: -kv[1]
    )[:top_n]
    if top:
        lines.append("  top requests: " + "  ".join(
            f"#{rid}={d:.6f}" for rid, d in top
        ))

    if summary is not None:
        residuals = tel.check(summary)
        worst = max(residuals.values())
        lines.append(
            f"conservation vs summary: OK (max residual {worst:.2e} <= 1e-9)"
        )
    return "\n".join(lines)
