"""JSONL live trace exporter over the engine's typed event stream.

One line per event, written (and flushed) as it arrives, so a crashed or
interrupted run still leaves a readable trace.  Each line is::

    {"event": "TokenEmitted", "t_s": 1.25, "req_id": 3, "token": 17, ...}

— the event class name plus its dataclass fields, recursively serialized
(``RequestFinished`` lines therefore embed the full ``RequestRecord``
including its executed ``ReusePlan``/``FusedSchedule``).  Extra key/values
passed to ``write``/``write_all`` are merged into every line (e.g. a
``mode`` tag when several engine runs share one file, or the ``replica``
tag ``ServingCluster`` writes).

A fresh file starts with one schema header line::

    {"__trace__": {"version": 1, "format": "repro.serving.events"}}

so consumers can detect the schema; ``read_trace`` tolerates it (header
lines never appear among the returned events — the parsed header rides on
the result's ``.header`` attribute).  The header names the reference
package's format, and the lines are the reference's, so either package
reads the other's traces.  Non-JSON-native leaves (numpy scalars and
arrays, torch tensors on any device) serialize deterministically as their
Python values instead of crashing mid-run or degrading to ``repr`` strings.

The trace is self-sufficient: ``read_events`` rebuilds TYPED events —
nested plans, fused schedules and records included — whose
``summarize_events`` / ``audit`` / span-tree views match the live stream
exactly (tests/test_torch_obs.py), and ``read_tagged_events`` recovers a
cluster's replica-tagged stream.  ``ServingCluster(trace=...)`` writes its
replica-tagged stream through this exporter.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

TRACE_FORMAT = "repro.serving.events"
TRACE_VERSION = 1
_HEADER_KEY = "__trace__"


def event_to_dict(event: Any, **extra: Any) -> Dict[str, Any]:
    """Flatten one typed event into a JSON-ready dict: class name + fields
    (nested dataclasses — records, plans, fusion schedules — recurse)."""
    out: Dict[str, Any] = {"event": type(event).__name__}
    out.update(dataclasses.asdict(event))
    out.update(extra)
    return out


def _json_default(o: Any) -> Any:
    """Deterministic serialization for non-JSON-native leaves: numpy
    scalars become their Python values, arrays and tensors become nested
    lists (a tensor is copied to the host first, so a bf16 tensor gives its
    values as floats), bytes hex-encode.  Anything else falls back to
    ``str`` (never crashes the run mid-trace)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (bytes, bytearray)):
        return o.hex()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    return str(o)


class TraceWriter:
    """Append-mode JSONL sink for the typed event stream.

    Usage::

        with TraceWriter(path) as tw:
            for event in engine.drain():
                tw.write(event)

    Lines flush per event (live tailing works); ``n_events`` counts what was
    written.  A schema header line is emitted when the file starts empty
    (append mode onto an existing trace inherits its header)."""

    def __init__(self, path, *, append: bool = False):
        self.path = pathlib.Path(path)
        fresh = not (append and self.path.exists() and self.path.stat().st_size)
        self._f = open(self.path, "a" if append else "w")
        self.n_events = 0
        if fresh:
            json.dump(
                {_HEADER_KEY: {"version": TRACE_VERSION, "format": TRACE_FORMAT}},
                self._f,
            )
            self._f.write("\n")
            self._f.flush()

    def write(self, event: Any, **extra: Any) -> None:
        json.dump(event_to_dict(event, **extra), self._f, default=_json_default)
        self._f.write("\n")
        self._f.flush()
        self.n_events += 1

    def write_all(self, events: Iterable[Any], **extra: Any) -> int:
        n = 0
        for e in events:
            self.write(e, **extra)
            n += 1
        return n

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None


class Trace(List[Dict[str, Any]]):
    """``read_trace``'s result: a plain list of event dicts, with the parsed
    schema header (or None for headerless/legacy traces) as ``.header``."""

    header: Optional[Dict[str, Any]] = None


def read_trace(path) -> Trace:
    """Parse a JSONL trace back into event dicts (blank lines skipped).
    Header lines are tolerated and returned via the result's ``.header``
    attribute, never as events."""
    out = Trace()
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        if _HEADER_KEY in d:
            out.header = d[_HEADER_KEY]
        else:
            out.append(d)
    return out


# --------------------------------------------------------------------------- #
# Replay: trace dicts -> typed events
# --------------------------------------------------------------------------- #
def _fused_span(d: Dict[str, Any]):
    from repro_torch.kvcache.fusion import FusedSpan

    return FusedSpan(
        start=d["start"], end=d["end"], kind=d["kind"],
        entry_id=d["entry_id"], src_start=d["src_start"],
        chunk_hashes=tuple(d["chunk_hashes"]),
    )


def _fused_schedule(d: Optional[Dict[str, Any]]):
    if d is None:
        return None
    from repro_torch.kvcache.fusion import CompositeMatch, FusedSchedule

    m = d["match"]
    match = CompositeMatch(
        spans=tuple(_fused_span(s) for s in m["spans"]),
        total_tokens=m["total_tokens"],
        chunk_tokens=m["chunk_tokens"],
    )
    return FusedSchedule(
        match=match,
        recompute_frac=d["recompute_frac"],
        spans=tuple(_fused_span(s) for s in d["spans"]),
        reused_tokens=d["reused_tokens"],
        recompute_tokens=d["recompute_tokens"],
        selected_tokens=d["selected_tokens"],
    )


def _plan(d: Optional[Dict[str, Any]]):
    if d is None:
        return None
    from repro_torch.serving.planner import ReusePlan

    return ReusePlan(
        action=d["action"], tier=d["tier"],
        matched_tokens=d["matched_tokens"],
        reused_fraction=d["reused_fraction"],
        fetch_bytes=d["fetch_bytes"], store_after=d["store_after"],
        est_ttft_s=d["est_ttft_s"], est_cost=d["est_cost"],
        fused=_fused_schedule(d.get("fused")),
    )


def _record(d: Dict[str, Any]):
    from repro_torch.serving.request import RequestRecord

    return RequestRecord(
        req_id=d["req_id"], arrival_s=d["arrival_s"],
        context_len=d["context_len"], prompt_len=d["prompt_len"],
        tokens=list(d["tokens"]), action=d["action"],
        matched_tokens=d["matched_tokens"], plan=_plan(d.get("plan")),
        start_s=d["start_s"], load_s=d["load_s"],
        prefill_s=d["prefill_s"], decode_s=d["decode_s"],
        finish_s=d["finish_s"], compute_cost=d["compute_cost"],
        degraded=d.get("degraded", False),  # absent in pre-faults traces
    )


def event_from_dict(d: Dict[str, Any]):
    """One trace line back into its typed event (extra tags — ``mode``,
    ``replica`` — are ignored; nested plans/records/schedules rebuild as
    the original dataclasses, tuples restored)."""
    from repro_torch.serving import events as ev

    cls = getattr(ev, d["event"], None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise ValueError(f"unknown event class in trace: {d['event']!r}")
    kw: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name == "plan":
            v = _plan(v)
        elif f.name == "record":
            v = _record(v)
        elif f.name == "req_ids":
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def events_from_dicts(dicts: Iterable[Dict[str, Any]]) -> List[Any]:
    return [event_from_dict(d) for d in dicts]


def read_events(path) -> List[Any]:
    """Typed event stream from a saved trace — the replay entry point:
    ``summarize_events``/``audit``/``obs.build_spans`` over the result
    match the live stream exactly."""
    return events_from_dicts(read_trace(path))


def read_tagged_events(path) -> List[Tuple[int, Any]]:
    """Replica-tagged typed events from a cluster trace (lines carry the
    ``replica`` extra ``ServingCluster`` writes; untagged lines land on
    replica 0) — feeds ``obs.build_cluster_spans`` and
    ``audit.cluster_audit`` the same shapes the live cluster produces."""
    return [
        (int(d.get("replica", 0)), event_from_dict(d)) for d in read_trace(path)
    ]
