"""The port's discrete-event simulator (``repro_torch.core.simulator``)
against the JAX package's.

The six tests of ``tests/test_simulator.py`` run on the port's simulator,
``PerfModel`` and prices; then ``simulate()`` and ``compare_pipelines()``
run on both packages over the same traces, and every ``RequestResult`` and
``SimResult`` field and every comparison key must agree at 1e-9.  The
paper's V100 hardware specs must equal the reference's field by field.  The
simulator is host code: nothing here runs a model.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import perf_model as jperf_model  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro.core.pricing import AWS_PAPER as JAWS_PAPER  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import perf_model, simulator  # noqa: E402
from repro_torch.core.cost_model import Workload, cost_kv, cost_text  # noqa: E402
from repro_torch.core.perf_model import V100_X4_HF, PerfModel  # noqa: E402
from repro_torch.core.pricing import AWS_PAPER  # noqa: E402
from test_torch_engine import _close  # noqa: E402

LLAMA = get_config("llama-7b")
PM = PerfModel(V100_X4_HF)
JLLAMA = jget_config("llama-7b")
JPM = jperf_model.PerfModel(jperf_model.V100_X4_HF)


def _trace(L_ctx, L_out=32, n_contexts=10, reuses=5, rate=0.05, seed=0, sim=simulator):
    return sim.make_trace(
        n_contexts=n_contexts, reuses_per_context=reuses, L_context=L_ctx,
        L_prompt=32, L_output=L_out, arrival_rate_per_s=rate, seed=seed,
    )


# --------------------------------------------------------------------------- #
# tests/test_simulator.py on the port
# --------------------------------------------------------------------------- #
def test_simulator_matches_analytic_costs():
    """Light load (no queueing): simulated GPU cost tracks the analytic model
    within 10% for both pipelines."""
    trace = _trace(8_000, rate=0.01)
    tier = AWS_PAPER.tier("io2")
    text = simulator.simulate(LLAMA, trace, PM, reuse_kv=False, tier=tier)
    kv = simulator.simulate(LLAMA, trace, PM, reuse_kv=True, tier=tier)
    w = Workload(L_context=8_000, L_prompt=32, L_output=32, N=5,
                 period_hours=text.horizon_s / 3600.0)
    ct = cost_text(LLAMA, w, AWS_PAPER, PM).total * 10  # 10 contexts
    ck_compute = cost_kv(LLAMA, w, AWS_PAPER, PM).compute * 10
    assert text.cost(AWS_PAPER, tier) == pytest.approx(ct, rel=0.1)
    c_gpu = AWS_PAPER.compute.cost_per_hour / 3600
    assert c_gpu * kv.gpu_busy_s == pytest.approx(ck_compute, rel=0.15)


def test_fig2a_trend_savings_grow_with_input_length():
    """Paper Fig 2(a): both savings increase with context length."""
    res = {L: simulator.compare_pipelines(LLAMA, _trace(L), PM, AWS_PAPER)
           for L in (1_000, 10_000)}
    assert res[10_000]["cost_saving_x"] > res[1_000]["cost_saving_x"]
    assert res[10_000]["delay_saving_x"] > res[1_000]["delay_saving_x"]
    assert 1.0 <= res[1_000]["delay_saving_x"] <= 2.0  # paper: 1.1x at 1K
    assert res[10_000]["delay_saving_x"] >= 2.0  # paper: 2.9x at 10K


def test_fig2b_trend_savings_shrink_with_output_length():
    """Paper Fig 2(b): longer outputs amortise the prefill saving away."""
    short = simulator.compare_pipelines(LLAMA, _trace(10_000, L_out=1), PM, AWS_PAPER)
    long_ = simulator.compare_pipelines(LLAMA, _trace(10_000, L_out=100), PM, AWS_PAPER)
    assert short["delay_saving_x"] > long_["delay_saving_x"]
    assert short["cost_saving_x"] > long_["cost_saving_x"]


def test_reuse_never_recomputes_contexts_twice():
    trace = _trace(4_000)
    kv = simulator.simulate(LLAMA, trace, PM, reuse_kv=True, tier=AWS_PAPER.tier("io2"))
    n_ctx = len({r.context_id for r in trace})
    assert sum(1 for r in kv.results if not r.reused) == n_ctx


def test_host_cache_reduces_load_delay():
    trace = _trace(8_000)
    tier = AWS_PAPER.tier("io2")
    cold = simulator.simulate(LLAMA, trace, PM, reuse_kv=True, tier=tier)
    warm = simulator.simulate(LLAMA, trace, PM, reuse_kv=True, tier=tier,
                              host_cache_gb=10_000.0)
    assert warm.mean_ttft_s < cold.mean_ttft_s


def test_overlap_load_improves_ttft():
    trace = _trace(8_000)
    tier = AWS_PAPER.tier("io2")
    plain = simulator.simulate(LLAMA, trace, PM, reuse_kv=True, tier=tier)
    ovl = simulator.simulate(LLAMA, trace, PM, reuse_kv=True, tier=tier, overlap_load=True)
    assert ovl.mean_ttft_s <= plain.mean_ttft_s


# --------------------------------------------------------------------------- #
# Port against reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(reuse_kv=False), dict(reuse_kv=True), dict(reuse_kv=True, overlap_load=True),
    dict(reuse_kv=True, host_cache_gb=1.0),
], ids=["text", "kv", "kv-overlap", "kv-host-cache"])
def test_simulate_equals_reference(kw):
    """Every ``RequestResult`` and ``SimResult`` field, and the derived
    summaries, equal the reference's at 1e-9 on the same trace."""
    trace = _trace(6_000, rate=0.2, seed=3)
    jtrace = _trace(6_000, rate=0.2, seed=3, sim=jsimulator)
    _close(trace, jtrace, "trace")
    got = simulator.simulate(LLAMA, trace, PM, tier=AWS_PAPER.tier("io2"), **kw)
    want = jsimulator.simulate(JLLAMA, jtrace, JPM, tier=JAWS_PAPER.tier("io2"), **kw)
    _close(got, want, "sim")
    for name in ("mean_ttft_s", "mean_e2e_s", "p99_e2e_s", "horizon_s"):
        assert getattr(got, name) == pytest.approx(getattr(want, name), abs=1e-9), name
    assert got.cost(AWS_PAPER, AWS_PAPER.tier("io2")) == pytest.approx(
        want.cost(JAWS_PAPER, JAWS_PAPER.tier("io2")), abs=1e-9)


@pytest.mark.parametrize("L_ctx,L_out", [(1_000, 32), (10_000, 1), (10_000, 100)])
def test_compare_pipelines_equals_reference(L_ctx, L_out):
    got = simulator.compare_pipelines(LLAMA, _trace(L_ctx, L_out=L_out), PM, AWS_PAPER)
    want = jsimulator.compare_pipelines(
        JLLAMA, _trace(L_ctx, L_out=L_out, sim=jsimulator), JPM, JAWS_PAPER)
    assert got.keys() == want.keys()
    _close(got, want, "compare")


def test_paper_v100_specs_equal_the_reference():
    for name in ("V100_X4", "V100_X1_PAPER", "V100_X4_HF"):
        assert dataclasses.asdict(getattr(perf_model, name)) == \
            dataclasses.asdict(getattr(jperf_model, name)), name
