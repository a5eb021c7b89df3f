"""Per-request span trees derived from the typed event stream.

A span is a named wall-clock interval on a replica's SimClock.  The tree
for one request mirrors its lifecycle::

    request #7 (action=load, replica=0)
      ├─ queue        [arrival, start]
      ├─ plan         @start            (action, tier, estimates)
      ├─ fetch:s3     [start, +load_s]  (one per KVLoaded, per source tier)
      ├─ prefill      [start+load, +prefill_s]  (packed | fused | single)
      ├─ write_back   @t                (entry, tier, bytes)
      └─ decode       [ttft_end, finish]  (tokens, busy_s)

Spans are a PURE function of the event stream — no engine internals — so a
saved JSONL trace (``serving/trace.py``) reconstructs byte-identical trees:
``build_spans(read_events(path))`` equals the live-stream result exactly
(tests/test_torch_obs.py pins this for engine and cluster runs, and holds
the trees to the reference package's).

Cluster streams are replica-tagged ``(replica, event)`` pairs
(``ServingCluster.events``): ``build_cluster_spans`` files each request
under its landing replica, prepends a ``route`` child carrying the router's
digest-predicted overlap and score, and returns cluster infrastructure
spans (rebalance copies, migrations, batch admissions) alongside.

``chrome_trace`` exports any span list as Chrome trace-event JSON —
``write_chrome_trace(path, spans)`` produces a file Perfetto
(https://ui.perfetto.dev) loads directly; see docs/OBSERVABILITY.md.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.serving import events as ev


@dataclasses.dataclass
class Span:
    """One named interval; ``children`` nest (zero-duration = instant)."""

    name: str
    start_s: float
    end_s: float
    req_id: int = -1  # -1 = infrastructure / engine-level
    replica: int = 0
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    def walk(self) -> Iterable["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


@dataclasses.dataclass
class _ReqEvents:
    admitted: Optional[ev.RequestAdmitted] = None
    plan: Optional[ev.PlanChosen] = None
    loads: List[ev.KVLoaded] = dataclasses.field(default_factory=list)
    fused: Optional[ev.FusedAdmitted] = None
    writeback: Optional[ev.StoreWriteBack] = None
    finished: Optional[ev.RequestFinished] = None
    routed: Optional[ev.RequestRouted] = None
    n_tokens: int = 0


def _collect(
    events: Iterable[ev.Event],
) -> Tuple[Dict[int, _ReqEvents], Dict[int, tuple], List[ev.Event]]:
    """Split a stream into per-request groups, the packed-batch membership
    map, and the engine-level infrastructure events."""
    reqs: Dict[int, _ReqEvents] = {}
    batches: Dict[int, tuple] = {}  # req_id -> its BatchAdmitted's req_ids
    infra: List[ev.Event] = []
    for e in events:
        if isinstance(e, ev.BatchAdmitted):
            for rid in e.req_ids:
                batches[rid] = e.req_ids
            infra.append(e)
            continue
        if isinstance(e, (ev.TierMigrated, ev.ReplicaRebalanced)):
            infra.append(e)
            continue
        if isinstance(e, ev.ClockAdvanced):
            continue
        r = reqs.setdefault(e.req_id, _ReqEvents())
        if isinstance(e, ev.RequestAdmitted):
            r.admitted = e
        elif isinstance(e, ev.PlanChosen):
            r.plan = e
        elif isinstance(e, ev.KVLoaded):
            r.loads.append(e)
        elif isinstance(e, ev.FusedAdmitted):
            r.fused = e
        elif isinstance(e, ev.StoreWriteBack):
            r.writeback = e
        elif isinstance(e, ev.RequestFinished):
            r.finished = e
        elif isinstance(e, ev.RequestRouted):
            r.routed = e
        elif isinstance(e, ev.TokenEmitted):
            r.n_tokens += 1
    return reqs, batches, infra


def _request_tree(
    rid: int, r: _ReqEvents, in_batch: bool, replica: int
) -> Optional[Span]:
    if r.finished is None:
        return None  # request still in flight: no complete tree to build
    rec = r.finished.record
    arrival = rec.arrival_s
    start = rec.start_s
    load_end = start + rec.load_s
    ttft_end = load_end + rec.prefill_s
    root = Span(
        name=f"request #{rid}",
        start_s=arrival, end_s=rec.finish_s, req_id=rid, replica=replica,
        attrs={
            "action": rec.action,
            "matched_tokens": rec.matched_tokens,
            "tokens": len(rec.tokens),
            "compute_cost": rec.compute_cost,
        },
    )
    if r.routed is not None:
        root.children.append(
            Span(
                name="route", start_s=r.routed.t_s, end_s=r.routed.t_s,
                req_id=rid, replica=replica,
                attrs={
                    "replica": r.routed.replica,
                    "predicted_matched_tokens": r.routed.matched_tokens,
                    "score": r.routed.score,
                    "ring_owner": r.routed.ring_owner,
                },
            )
        )
    root.children.append(
        Span("queue", arrival, start, req_id=rid, replica=replica)
    )
    if r.plan is not None:
        p = r.plan.plan
        root.children.append(
            Span(
                "plan", start, start, req_id=rid, replica=replica,
                attrs={
                    "action": p.action,
                    "tier": p.tier,
                    "est_ttft_s": p.est_ttft_s,
                    "est_cost": p.est_cost,
                    "store_after": p.store_after,
                },
            )
        )
    for kv in r.loads:
        root.children.append(
            Span(
                f"fetch:{kv.tier}", kv.t_s, kv.t_s + kv.load_s,
                req_id=rid, replica=replica,
                attrs={
                    "tier": kv.tier,
                    "nbytes": kv.nbytes,
                    "matched_tokens": kv.matched_tokens,
                },
            )
        )
    mode = "fused" if r.fused is not None else ("packed" if in_batch else "single")
    prefill_attrs: Dict[str, object] = {"mode": mode}
    if r.fused is not None:
        prefill_attrs.update(
            reused_tokens=r.fused.reused_tokens,
            recompute_tokens=r.fused.recompute_tokens,
            n_sources=r.fused.n_sources,
            jit_hit=r.fused.jit_hit,
        )
    root.children.append(
        Span(
            "prefill", load_end, ttft_end, req_id=rid, replica=replica,
            attrs=prefill_attrs,
        )
    )
    if r.writeback is not None:
        wb = r.writeback
        root.children.append(
            Span(
                "write_back", wb.t_s, wb.t_s, req_id=rid, replica=replica,
                attrs={
                    "entry_id": wb.entry_id,
                    "tier": wb.tier,
                    "nbytes": wb.nbytes,
                },
            )
        )
    root.children.append(
        Span(
            "decode", ttft_end, rec.finish_s, req_id=rid, replica=replica,
            attrs={"tokens": len(rec.tokens), "busy_s": rec.decode_s},
        )
    )
    return root


def _infra_span(e: ev.Event, replica: int) -> Span:
    if isinstance(e, ev.TierMigrated):
        return Span(
            f"migration:{e.reason}", e.t_s, e.t_s, replica=replica,
            attrs={
                "entry_id": e.entry_id, "from_tier": e.from_tier,
                "to_tier": e.to_tier, "nbytes": e.nbytes,
            },
        )
    if isinstance(e, ev.ReplicaRebalanced):
        return Span(
            "rebalance", e.t_s, e.t_s, replica=replica,
            attrs={
                "content_key": e.content_key,
                "from_replica": e.from_replica,
                "to_replica": e.to_replica,
                "nbytes": e.nbytes,
                "hits": e.hits,
            },
        )
    assert isinstance(e, ev.BatchAdmitted), e
    return Span(
        "batch", e.t_s, e.t_s, replica=replica,
        attrs={
            "n_requests": len(e.req_ids),
            "q_tokens": e.q_tokens,
            "q_len": e.q_len,
            "kv_len": e.kv_len,
            "jit_hit": e.jit_hit,
        },
    )


def build_spans(
    events: Iterable[ev.Event], *, replica: int = 0
) -> List[Span]:
    """Span trees for one engine's event stream: one root per FINISHED
    request (req_id order), then the engine's infrastructure spans in
    stream order."""
    reqs, batches, infra = _collect(events)
    out: List[Span] = []
    for rid in sorted(reqs):
        tree = _request_tree(rid, reqs[rid], rid in batches, replica)
        if tree is not None:
            out.append(tree)
    out.extend(_infra_span(e, replica) for e in infra)
    return out


def build_cluster_spans(
    tagged_events: Iterable[Tuple[int, ev.Event]],
) -> List[Span]:
    """Span trees for a replica-tagged cluster stream
    (``ServingCluster.events``): per-replica request trees — each with its
    ``route`` child carrying the router's prediction — then every replica's
    infrastructure spans.  Replica order, then req_id order, so live and
    trace-replayed streams produce identical lists."""
    by_replica: Dict[int, List[ev.Event]] = {}
    for rep, e in tagged_events:
        by_replica.setdefault(rep, []).append(e)
    out: List[Span] = []
    infra_all: List[Span] = []
    for rep in sorted(by_replica):
        reqs, batches, infra = _collect(by_replica[rep])
        for rid in sorted(reqs):
            tree = _request_tree(rid, reqs[rid], rid in batches, rep)
            if tree is not None:
                out.append(tree)
        infra_all.extend(_infra_span(e, rep) for e in infra)
    return out + infra_all


# --------------------------------------------------------------------------- #
# Chrome trace-event export (Perfetto)
# --------------------------------------------------------------------------- #
def _span_events(s: Span) -> List[dict]:
    tid = s.req_id + 1 if s.req_id >= 0 else 0  # tid 0 = infrastructure lane
    base = {
        "name": s.name,
        "pid": s.replica,
        "tid": tid,
        "cat": "serving",
        "args": dict(s.attrs),
    }
    ts = s.start_s * 1e6  # trace-event timestamps are microseconds
    if s.duration_s > 0:
        out = [{**base, "ph": "X", "ts": ts, "dur": s.duration_s * 1e6}]
    else:
        out = [{**base, "ph": "i", "ts": ts, "s": "t"}]
    for c in s.children:
        out.extend(_span_events(c))
    return out


def chrome_trace(spans: List[Span]) -> dict:
    """Chrome trace-event JSON (the object form Perfetto/chrome://tracing
    load): one complete ("X") event per timed span, instants ("i") for the
    zero-duration ones, pid = replica, tid = request."""
    events: List[dict] = []
    pids = sorted({s.replica for sp in spans for s in sp.walk()})
    for pid in pids:
        events.append(
            {
                "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": f"replica {pid}"},
            }
        )
    for sp in spans:
        events.extend(_span_events(sp))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, spans: List[Span]) -> pathlib.Path:
    p = pathlib.Path(path)
    p.write_text(json.dumps(chrome_trace(spans)))
    return p
