"""The port's JSONL trace exporter (``repro_torch.serving.trace``) against
the JAX package's.

The two tests of ``tests/test_trace.py`` replay on the port's fused engine
(reduced llama-7b on the CPU, weights converted from the reference's, the
reference's default hardware and prices): the event stream written to disk
round-trips, every line carrying its type, time, request id and fields,
including the nested record, plan and ``FusedSchedule`` of a fused
admission.  The same serve on the reference writes the same lines.  A
torch tensor leaf (f32 and bf16, on the CPU) takes the place of the
reference's jax-array case.

The port's ``read_events`` rebuilds a fused trace's typed events; the
reference's cannot (its ``_fused_schedule`` leaves out ``selected_tokens``,
a required field of ``FusedSchedule``), which the last test pins.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro_torch.serving import BlendPlanner, EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.trace import TraceWriter, read_events, read_trace  # noqa: E402
from test_torch_engine import _reference_perf_and_pricing, _setup  # noqa: E402
from test_torch_obs import _same, _same_lines  # noqa: E402

torch.set_num_threads(1)


def _fused_requests(vocab):
    """``tests/test_trace.py``'s two requests, from the same seed."""
    rng = np.random.default_rng(2)
    chunk = 16
    pool = [list(map(int, rng.integers(0, vocab, chunk))) for _ in range(3)]
    return [
        dict(req_id=0, context_tokens=sum(pool, []), prompt_tokens=[1, 2, 3, 4],
             max_new_tokens=2, arrival_s=0.0, expected_reuses=3),
        dict(req_id=1, context_tokens=pool[2] + pool[0] + pool[1],
             prompt_tokens=[5, 6, 7, 8], max_new_tokens=2, arrival_s=20.0, expected_reuses=3),
    ]


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """The fused serve of ``tests/test_trace.py`` on both packages, each
    traced with a ``mode`` tag: (port events, port trace, reference
    events, reference trace)."""
    jcfg, jparams, cfg, params = _setup("llama-7b")
    perf, pricing = _reference_perf_and_pricing()
    kw = dict(max_slots=2, max_len=128, chunk_tokens=16, fusion_enabled=True)
    d = tmp_path_factory.mktemp("trace")
    out = []
    for port in (True, False):
        if port:
            eng = ServingEngine(cfg, params, engine_cfg=EngineConfig(**kw), perf=perf,
                                pricing=pricing, device="cpu",
                                planner=BlendPlanner(recompute_frac=0.25, always=True))
        else:
            eng = jserving.ServingEngine(
                jcfg, jparams, engine_cfg=jserving.EngineConfig(**kw),
                planner=jserving.BlendPlanner(recompute_frac=0.25, always=True))
        for r in _fused_requests(cfg.vocab):
            eng.submit((Request if port else jserving.Request)(**r))
        path = d / ("port.jsonl" if port else "ref.jsonl")
        events = []
        with (TraceWriter if port else jtrace.TraceWriter)(path) as tw:
            for e in eng.drain():
                events.append(e)
                tw.write(e, mode="fused")
            assert tw.n_events == len(events) > 0
        out += [events, path]
    return out


def test_trace_round_trips_event_stream(fused):
    events, path, _, jpath = fused
    lines = read_trace(path)
    assert len(lines) == len(events)
    assert [l["event"] for l in lines] == [type(e).__name__ for e in events]
    assert all(l["mode"] == "fused" for l in lines)
    # times and req ids survive verbatim
    assert [l["t_s"] for l in lines] == [e.t_s for e in events]
    assert [l["req_id"] for l in lines] == [e.req_id for e in events]
    # the fused admission serialized with its payload fields
    fused_lines = [l for l in lines if l["event"] == "FusedAdmitted"]
    assert len(fused_lines) == 1
    assert fused_lines[0]["reused_tokens"] > 0 and fused_lines[0]["n_sources"] >= 1
    # RequestFinished embeds the full record, including the executed plan
    fins = [l for l in lines if l["event"] == "RequestFinished"]
    assert sorted(f["record"]["req_id"] for f in fins) == [0, 1]
    fused_rec = next(f for f in fins if f["record"]["req_id"] == 1)
    assert fused_rec["record"]["action"] == "fused"
    assert fused_rec["record"]["plan"]["fused"]["recompute_frac"] == 0.25
    # tokens reconstructed from the trace match the live stream's view
    want = ev.tokens_from_events(events)
    got = {}
    for l in lines:
        if l["event"] == "TokenEmitted":
            got.setdefault(l["req_id"], []).append(l["token"])
    assert got == want
    # the reference's serve writes the same lines
    _same_lines(path, jpath)


def test_trace_append_mode(tmp_path):
    path, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    for writer, mod, p in ((TraceWriter, ev, path), (jtrace.TraceWriter, jev, jpath)):
        e = mod.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0)
        with writer(p) as tw:
            tw.write(e)
        with writer(p, append=True) as tw:
            tw.write(e, wave=2)
    lines = read_trace(path)
    assert len(lines) == 2 and lines[1]["wave"] == 2
    assert path.read_bytes() == jpath.read_bytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_leaf_serializes_as_its_values(tmp_path, dtype):
    """In place of ``test_jax_array_serializes``: a tensor leaf becomes the
    nested list of its values (bf16 ones as the floats they hold), the same
    line on every write."""
    x = torch.tensor([[0.5, -1.25, 3.0], [1.0078125, 0.0, -2.0]], dtype=dtype)
    p = tmp_path / "t.jsonl"
    with TraceWriter(p) as tw:
        for _ in range(2):
            tw.write(ev.ClockAdvanced(t_s=1.0, req_id=-1, to_s=1.0), dev=x, ids=torch.arange(3))
    a, b = read_trace(p)
    assert a == b
    assert a["dev"] == x.float().tolist() == [[0.5, -1.25, 3.0], [1.0078125, 0.0, -2.0]]
    assert a["ids"] == [0, 1, 2]
    assert json.loads(p.read_text().splitlines()[1])["dev"] == a["dev"]


def test_fused_trace_replays_typed_events(fused):
    """The port rebuilds a fused trace's typed events, its own and the
    reference's; the reference's ``read_events`` raises on a fused trace,
    as it does on its own."""
    events, path, jevents, jpath = fused
    assert read_events(path) == events
    _same(read_events(jpath), jevents, "port reads the reference's fused trace")
    assert any(e.record.action == "fused" for e in events if isinstance(e, ev.RequestFinished))
    for p in (path, jpath):
        with pytest.raises(TypeError, match="selected_tokens"):
            jtrace.read_events(p)
