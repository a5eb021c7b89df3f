"""Per-request SLO audit over the engine's typed event stream.

Folds the events of a serving run into one row per request — where its TTFT
went (queue / load / prefill), which storage tier served it, and whether it
met its TTFT SLO — without touching engine internals.  Any consumer that
kept the event stream (a live trace, a replayed log) can produce the same
table; ``chip_smoke.py`` checks a saved trace's table against the live one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from repro_torch.serving import events as ev
from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class AuditRow:
    req_id: int
    action: str  # recompute | load | partial
    tier: Optional[str]  # storage tier served from (None = recompute)
    queue_s: float
    load_s: float
    prefill_s: float
    ttft_s: float
    e2e_s: float
    slo_ttft_s: Optional[float]
    # the planned fetch failed and this request fell back to exact recompute
    # (tokens unaffected; load_s carries the burned fetch time)
    degraded: bool = False

    @property
    def slo_met(self) -> Optional[bool]:
        """True/False against the TTFT SLO; None when the request has none."""
        if self.slo_ttft_s is None:
            return None
        return self.ttft_s <= self.slo_ttft_s


def audit(
    events: Iterable[ev.Event],
    requests: Optional[Iterable[Request]] = None,
) -> List[AuditRow]:
    """One row per finished request, in req_id order.  ``requests`` (when
    given) supplies the TTFT SLOs; the event stream alone carries the rest."""
    slo: Dict[int, Optional[float]] = {}
    for r in requests or ():
        slo[r.req_id] = r.slo_ttft_s
    tier: Dict[int, str] = {}
    rows: List[AuditRow] = []
    for e in events:
        if isinstance(e, ev.KVLoaded):
            tier[e.req_id] = e.tier
        elif isinstance(e, ev.RequestFinished):
            rec = e.record
            rows.append(
                AuditRow(
                    req_id=rec.req_id,
                    action=rec.action,
                    tier=tier.get(rec.req_id),
                    queue_s=rec.queue_s,
                    load_s=rec.load_s,
                    prefill_s=rec.prefill_s,
                    ttft_s=rec.ttft_s,
                    e2e_s=rec.e2e_s,
                    slo_ttft_s=slo.get(rec.req_id),
                    degraded=getattr(rec, "degraded", False),
                )
            )
    return sorted(rows, key=lambda r: r.req_id)


def audit_from_trace(path, requests: Optional[Iterable[Request]] = None) -> List[AuditRow]:
    """The same audit rows from a SAVED trace file: replay parity means a
    trace on disk answers the same SLO questions as the live stream."""
    from repro_torch.serving.trace import read_events

    return audit(read_events(path), requests)


def cluster_audit_from_trace(
    path, requests: Optional[Iterable[Request]] = None,
) -> Dict[int, List[AuditRow]]:
    """Per-replica audit rows from a saved replica-tagged cluster trace."""
    from repro_torch.serving.trace import read_tagged_events

    tagged = read_tagged_events(path)
    n = max((rep for rep, _ in tagged), default=-1) + 1
    streams: List[List[ev.Event]] = [[] for _ in range(n)]
    for rep, e in tagged:
        streams[rep].append(e)
    return cluster_audit(streams, requests)


def slo_summary(rows: List[AuditRow]) -> Dict[str, int]:
    met = sum(1 for r in rows if r.slo_met is True)
    violated = sum(1 for r in rows if r.slo_met is False)
    return {
        "requests": len(rows),
        "slo_met": met,
        "slo_violated": violated,
        "no_slo": len(rows) - met - violated,
        "degraded": sum(1 for r in rows if r.degraded),
    }


def cluster_audit(
    events_by_replica: List[List[ev.Event]],
    requests: Optional[Iterable[Request]] = None,
) -> Dict[int, List[AuditRow]]:
    """Per-replica audit over a cluster's replica-tagged event streams
    (``ServingCluster.events_by_replica``).  The SLO source is shared: a
    request's SLO is known at submit time, not per replica."""
    reqs = list(requests or ())
    return {
        i: audit(evs, reqs) for i, evs in enumerate(events_by_replica)
    }


def format_cluster_table(rows_by_replica: Dict[int, List[AuditRow]]) -> str:
    """Per-replica audit tables plus one aggregate SLO line — the cluster
    version of ``format_table``."""
    sections: List[str] = []
    all_rows: List[AuditRow] = []
    for i in sorted(rows_by_replica):
        rows = rows_by_replica[i]
        if not rows:
            continue
        s = slo_summary(rows)
        sections.append(
            f"-- replica {i}: {s['requests']} requests, "
            f"{s['slo_met']} SLO ok, {s['slo_violated']} missed --"
        )
        sections.append(format_table(rows))
        all_rows.extend(rows)
    agg = slo_summary(all_rows)
    sections.append(
        f"== cluster: {agg['requests']} requests, {agg['slo_met']} SLO ok, "
        f"{agg['slo_violated']} missed, {agg['no_slo']} no-SLO =="
    )
    return "\n".join(sections)


def format_table(rows: List[AuditRow]) -> str:
    """Fixed-width text table of the audit."""
    header = (
        f"{'req':>4s} {'action':<10s} {'tier':<11s} {'queue s':>8s} "
        f"{'load s':>8s} {'prefill s':>9s} {'TTFT s':>8s} {'SLO s':>7s} "
        f"{'SLO':>4s} {'deg':>4s}"
    )
    lines = [header]
    for r in rows:
        slo = f"{r.slo_ttft_s:7.2f}" if r.slo_ttft_s is not None else f"{'-':>7s}"
        verdict = {True: "ok", False: "MISS", None: "-"}[r.slo_met]
        lines.append(
            f"{r.req_id:>4d} {r.action:<10s} {(r.tier or '-'):<11s} "
            f"{r.queue_s:8.3f} {r.load_s:8.3f} {r.prefill_s:9.3f} "
            f"{r.ttft_s:8.3f} {slo} {verdict:>4s} "
            f"{'DEG' if r.degraded else '-':>4s}"
        )
    return "\n".join(lines)
