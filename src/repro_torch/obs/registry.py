"""Labeled metrics registry: counters, gauges, histograms, two expositions.

One ``MetricsRegistry`` per telemetry session.  Metrics are created (or
fetched — creation is idempotent) by name + label-name tuple; every
``(label values)`` combination is its own series, Prometheus-style::

    reg = MetricsRegistry()
    c = reg.counter("requests_total", "Finished requests", ("action", "replica"))
    c.inc(action="load", replica=0)
    reg.histogram("ttft_seconds", "TTFT", ("replica",)).observe(0.12, replica=0)
    print(reg.to_prometheus())       # text exposition
    snap = reg.snapshot()            # JSON-ready nested dict

Everything is plain host-side Python: no tensors and no numpy arrays are
retained, so feeding the registry from a serving hot loop adds no device
work and launches no kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# default histogram buckets: latency-flavored, seconds (upper bounds)
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

LabelValues = Tuple[Tuple[str, str], ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, object]) -> LabelValues:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {tuple(labelnames)}, got {tuple(labels)}"
        )
    return tuple((n, str(labels[n])) for n in labelnames)


def _fmt_labels(kv: LabelValues) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in kv)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if v == math.inf:
        return "+Inf"
    return repr(v) if isinstance(v, float) else str(v)


@dataclasses.dataclass
class _HistSeries:
    buckets: Tuple[float, ...]
    counts: List[int]
    total: float = 0.0
    n: int = 0

    def observe(self, value: float) -> None:
        self.total += value
        self.n += 1
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
        # +Inf bucket is implicit: == n

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (NaN when empty) — good enough for
        the console dashboard; exact stats live in ServingSummary."""
        if self.n == 0:
            return float("nan")
        rank = q * self.n
        cum = 0
        lo = 0.0
        for ub, c_ in zip(self.buckets, self.counts):
            # counts are cumulative per bucket; convert to per-bin
            binc = c_ - cum
            if cum + binc >= rank and binc > 0:
                frac = (rank - cum) / binc
                return lo + frac * (ub - lo)
            cum += binc
            lo = ub
        return lo  # landed in +Inf bucket: report the last finite bound


class Metric:
    """One named metric family; per-label-value series live in ``series``."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ):
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets or DEFAULT_BUCKETS)
        self.series: Dict[LabelValues, object] = {}

    # -- writes --------------------------------------------------------- #
    def inc(self, value: float = 1.0, **labels) -> None:
        assert self.kind == "counter", self.name
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({value})")
        k = _label_key(self.labelnames, labels)
        self.series[k] = self.series.get(k, 0.0) + value

    def set(self, value: float, **labels) -> None:
        assert self.kind == "gauge", self.name
        self.series[_label_key(self.labelnames, labels)] = value

    def observe(self, value: float, **labels) -> None:
        assert self.kind == "histogram", self.name
        k = _label_key(self.labelnames, labels)
        s = self.series.get(k)
        if s is None:
            s = self.series[k] = _HistSeries(
                self.buckets, [0] * len(self.buckets)
            )
        s.observe(value)

    # -- reads ---------------------------------------------------------- #
    def value(self, **labels) -> float:
        """Current value of one counter/gauge series (0.0 when never set)."""
        assert self.kind in ("counter", "gauge"), self.name
        return float(self.series.get(_label_key(self.labelnames, labels), 0.0))

    def hist(self, **labels) -> Optional[_HistSeries]:
        assert self.kind == "histogram", self.name
        return self.series.get(_label_key(self.labelnames, labels))


class MetricsRegistry:
    """Name -> Metric map with idempotent creation and two expositions."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get(
        self, name: str, kind: str, help: str,
        labelnames: Sequence[str], buckets=None,
    ) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Metric(name, kind, help, labelnames, buckets)
        else:
            if m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}{tuple(labelnames)} "
                    f"(was {m.kind}{m.labelnames})"
                )
        return m

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Metric:
        return self._get(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Metric:
        return self._get(name, "gauge", help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Metric:
        return self._get(name, "histogram", help, labelnames, buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def metrics(self) -> Iterable[Metric]:
        return self._metrics.values()

    # -- expositions ----------------------------------------------------- #
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one family per # HELP/# TYPE
        block; histograms expand to _bucket/_sum/_count)."""
        lines: List[str] = []
        for m in self._metrics.values():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for kv in sorted(m.series):
                if m.kind == "histogram":
                    s: _HistSeries = m.series[kv]
                    for ub, c in zip(s.buckets, s.counts):
                        bl = kv + (("le", _fmt_value(float(ub))),)
                        lines.append(
                            f"{m.name}_bucket{_fmt_labels(bl)} {c}"
                        )
                    bl = kv + (("le", "+Inf"),)
                    lines.append(f"{m.name}_bucket{_fmt_labels(bl)} {s.n}")
                    lines.append(
                        f"{m.name}_sum{_fmt_labels(kv)} {_fmt_value(s.total)}"
                    )
                    lines.append(f"{m.name}_count{_fmt_labels(kv)} {s.n}")
                else:
                    v = m.series[kv]
                    lines.append(
                        f"{m.name}{_fmt_labels(kv)} {_fmt_value(float(v))}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready nested dict: name -> {kind, help, series: [...]}.
        Histogram series carry buckets/counts/sum/count."""
        out: Dict[str, dict] = {}
        for m in self._metrics.values():
            series = []
            for kv in sorted(m.series):
                entry: Dict[str, object] = {"labels": dict(kv)}
                if m.kind == "histogram":
                    s: _HistSeries = m.series[kv]
                    entry.update(
                        buckets=list(s.buckets),
                        counts=list(s.counts),
                        sum=s.total,
                        count=s.n,
                    )
                else:
                    entry["value"] = float(m.series[kv])
                series.append(entry)
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out
