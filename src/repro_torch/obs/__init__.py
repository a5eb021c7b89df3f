"""Unified telemetry: spans, a labeled metrics registry, a cost ledger.

The paper's whole argument is an accounting identity — reuse wins only when
compute + storage + network dollars and delays are measured honestly — so
this package makes the serving stack's observability first-class instead of
scattered:

  * ``registry``  — ``MetricsRegistry``: labeled counters/gauges/histograms
    with Prometheus-style text exposition and a JSON snapshot.  Absorbs the
    engine/store/cluster counters (shape buckets, migration evals/skips,
    lookup walks, block-pool audit, packed/fused stats) into one view.
  * ``ledger``    — ``CostLedger``: every dollar of the cost model attributed
    to a request or an infrastructure activity (migration, rebalance,
    dedup'd write-back, gossip), with a conservation law against
    ``ServingSummary`` totals at 1e-9.
  * ``spans``     — per-request span trees (queue → plan → per-tier fetch →
    prefill → decode → write-back) derived purely from the typed event
    stream, with cluster parent info (routing/rebalance) and a Chrome
    trace-event export loadable in Perfetto.
  * ``telemetry`` — the ``Telemetry`` facade engines/clusters accept:
    subscribes to the event stream, feeds all three pillars, and stays
    entirely host-side (telemetry on gives the tokens and the kernel launch
    counts of telemetry off).

Telemetry is OFF by default everywhere; pass ``telemetry=Telemetry()`` to
``ServingEngine``/``ServingCluster`` to turn it on.
"""
from repro_torch.obs.ledger import (
    CostLedger,
    LedgerEntry,
    check_conservation,
    ledger_from_simulation,
)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import (
    Span,
    build_cluster_spans,
    build_spans,
    chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.telemetry import Telemetry

__all__ = [
    "CostLedger",
    "LedgerEntry",
    "MetricsRegistry",
    "Span",
    "Telemetry",
    "build_cluster_spans",
    "build_spans",
    "check_conservation",
    "chrome_trace",
    "ledger_from_simulation",
    "write_chrome_trace",
]
