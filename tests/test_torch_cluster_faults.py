"""Replica crashes and the chaos property on the port's cluster, against the
JAX package.

``TestClusterCrash`` (2) and ``TestChaosProperty`` (1) of
``tests/test_faults.py`` replay here on the port's ``ServingCluster``: two
replicas of reduced llama-7b on the CPU (weights converted from the
reference's) over host_dram and one shared s3 tier, ``AlwaysReusePlanner``,
the reference's default hardware and prices.  Each run is also served by the
reference cluster with its own injector drawn from the same seed and the
same crash schedule, and the port is held to it: tokens exactly, every
record (and the replica it landed on) and the merged event stream at 1e-9,
``fault_stats()`` per replica and the injector's tally.

The crash test and the chaos property run with ``obs.Telemetry`` on both
clusters, as the reference's tests do: the port's ledger conserves against
each replica's summary at 1e-9 (``check`` per replica) and equals the
reference's ledger entry by entry.  Every test also counts ``FetchFailed``,
``DegradedToRecompute`` and ``ReplicaCrashed`` from the cluster's own event
stream and holds them to ``fault_stats()`` and the injector.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro_torch import serving as pserving  # noqa: E402
from repro_torch.kvcache import faults as pfaults  # noqa: E402
from repro_torch.kvcache import hierarchy as phierarchy  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.serving import events as ev  # noqa: E402
from test_torch_engine import _close, _reference_perf_and_pricing, _setup  # noqa: E402
from test_torch_faults import _requests  # noqa: E402
from test_torch_obs import _same_ledger  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return _setup("llama-7b")


def _run_cluster(setup, reqs, *, faults=None, retry=None, port=True, tel=None):
    """``tests/test_faults.py``'s ``_run_cluster`` on one package: returns
    (cluster, summary, tokens by request)."""
    jcfg, jparams, cfg, params = setup
    mod, hier = (pserving, phierarchy) if port else (jserving, jhierarchy)
    ec = mod.EngineConfig(
        max_slots=2, max_len=128, chunk_tokens=16,
        tier_specs=[hier.TierSpec("host_dram", 1.0), hier.TierSpec("s3", 1.0)],
        faults=faults, retry_policy=retry,
    )
    kw = {}
    if port:
        perf, pricing = _reference_perf_and_pricing()
        kw = dict(perf=perf, pricing=pricing, device="cpu")
    cl = mod.ServingCluster(cfg if port else jcfg, params if port else jparams,
                            cluster_cfg=mod.ClusterConfig(n_replicas=2), engine_cfg=ec,
                            planner_factory=mod.AlwaysReusePlanner, telemetry=tel, **kw)
    for r in reqs:
        cl.submit(mod.Request(**r))
    summary = cl.run()
    return cl, summary, {r.req_id: r.tokens for r in cl.records}


def _held_to_reference(setup, reqs, make_injector, retry=None, telemetry=False):
    """Serve ``reqs`` on both clusters, each with the injector
    ``make_injector(faults module)`` builds and the retry policy ``retry``
    (kwargs of ``RetryPolicy``), and with telemetry if ``telemetry``; hold
    the port to the reference (the ledger too, and its conservation per
    replica).  Returns the port's (cluster, summary, tokens, injector)."""
    out = []
    for port, mod in ((True, pfaults), (False, jfaults)):
        inj = make_injector(mod)
        policy = mod.RetryPolicy(**retry) if retry is not None else None
        tel = (Telemetry() if port else jobs.Telemetry()) if telemetry else None
        out.append(_run_cluster(setup, reqs, faults=inj, retry=policy, port=port, tel=tel)
                   + (inj, tel))
    (cl, summary, tok, inj, tel), (jcl, jsummary, jtok, jinj, jtel) = out
    assert tok == jtok
    where = {r.req_id: i for i, e in enumerate(cl.replicas) for r in e.records}
    jwhere = {r.req_id: i for i, e in enumerate(jcl.replicas) for r in e.records}
    assert where == jwhere
    _close(sorted(cl.records, key=lambda r: r.req_id),
           sorted(jcl.records, key=lambda r: r.req_id), "records")
    assert [(i, type(e).__name__) for i, e in cl.events] == \
        [(i, type(e).__name__) for i, e in jcl.events]
    _close(cl.events, jcl.events, "events")
    for i, (e, je) in enumerate(zip(cl.replicas, jcl.replicas)):
        fs, jfs = e.fault_stats(), je.fault_stats()
        assert fs.keys() == jfs.keys()
        _close({k: v for k, v in fs.items() if k != "injector"},
               {k: v for k, v in jfs.items() if k != "injector"}, f"fault_stats[{i}]")
    assert inj.stats() == jinj.stats()
    _close(_nan_named(summary.as_dict()), _nan_named(jsummary.as_dict()), "summary")
    _check_event_counts(cl, inj)
    if telemetry:
        for i, s in enumerate(summary.replicas):
            assert max(tel.check(s, replica=i).values()) <= 1e-9
        _same_ledger(tel.ledger, jtel.ledger)
        # each cluster-level event reached the telemetry once
        assert tel.events == cl.events
    return cl, summary, tok, inj


def _nan_named(d):
    """A summary with each NaN (the latency stats of a replica that crashed
    before it finished a request) spelt ``"nan"``, so that both sides must
    report it where the other does."""
    if isinstance(d, dict):
        return {k: _nan_named(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_nan_named(v) for v in d]
    return "nan" if isinstance(d, float) and math.isnan(d) else d


def _check_event_counts(cl, inj):
    """The event-stream tally the reference's ledger check stands for: each
    replica's ``FetchFailed`` and ``DegradedToRecompute`` events count what
    its ``fault_stats()`` counts, each ``ReplicaCrashed`` names another
    replica and stands for a crash the injector fired (a crash of a missing
    or dead replica fires and is ignored), and every request is recorded
    exactly once."""
    for i, eng in enumerate(cl.replicas):
        fs = eng.fault_stats()
        mine = cl.events_by_replica[i]
        assert sum(isinstance(e, ev.FetchFailed) for e in mine) == fs["fetch_failures"]
        assert sum(isinstance(e, ev.DegradedToRecompute) for e in mine) == \
            fs["degraded_requests"]
    crashed = [e for _, e in cl.events if isinstance(e, ev.ReplicaCrashed)]
    assert len({e.replica for e in crashed}) == len(crashed) <= inj.stats()["crashes_fired"]
    ids = [r.req_id for r in cl.records]
    assert len(ids) == len(set(ids))


@pytest.fixture(scope="module")
def cluster_baseline(setup):
    reqs = _requests(setup[2].vocab, n=8)
    _, _, tok0 = _run_cluster(setup, reqs)
    _, _, jtok0 = _run_cluster(setup, reqs, port=False)
    assert tok0 == jtok0
    return reqs, tok0


class TestClusterCrash:
    def test_crash_resubmits_and_stays_token_identical(self, setup, cluster_baseline):
        reqs, tok0 = cluster_baseline

        def injector(mod):
            inj = mod.FaultInjector(seed=3, fail_rate=0.3)
            inj.schedule_crash(1, 0.02)
            return inj

        cl, summary, tok1, inj = _held_to_reference(
            setup, reqs, injector, retry=dict(max_attempts=2, cost_aware=False),
            telemetry=True)
        crashes = [e for _, e in cl.events if isinstance(e, ev.ReplicaCrashed)]
        assert len(crashes) == 1 and crashes[0].replica == 1
        assert inj.stats()["crashes_fired"] == 1
        # every request (including harvested in-flight/queued ones) finished,
        # exactly once, with the fault-free tokens
        assert tok1 == tok0
        # the dead replica took no requests after the crash
        assert all(rec.req_id in tok0 for rec in cl.records)
        assert summary.n_requests == len(reqs)

    def test_crash_of_missing_replica_is_ignored(self, setup, cluster_baseline):
        reqs, tok0 = cluster_baseline

        def injector(mod):
            inj = mod.FaultInjector(seed=0)
            inj.schedule_crash(7, 0.01)  # no such replica
            inj.schedule_crash(1, 0.01)
            inj.schedule_crash(1, 0.03)  # double-kill: second must be a no-op
            return inj

        cl, _, tok1, _ = _held_to_reference(setup, reqs, injector)
        crashes = [e for _, e in cl.events if isinstance(e, ev.ReplicaCrashed)]
        assert len(crashes) == 1
        assert tok1 == tok0


class TestChaosProperty:
    """Any seeded fault schedule leaves cluster tokens bitwise-identical to
    the fault-free run, and the port's run equal to the reference's."""

    @given(seed=st.integers(0, 2**16),
           fail_rate=st.floats(0.0, 0.5),
           corrupt_rate=st.floats(0.0, 0.3),
           crash_replica=st.integers(0, 1),
           crash_at=st.floats(0.0, 0.3))
    @settings(max_examples=5, deadline=None, derandomize=True)
    def test_any_schedule_token_identical_and_conserving(
            self, setup, cluster_baseline, seed, fail_rate, corrupt_rate,
            crash_replica, crash_at):
        reqs, tok0 = cluster_baseline

        def injector(mod):
            inj = mod.FaultInjector(seed=seed, fail_rate=fail_rate,
                                    corrupt_rate=corrupt_rate)
            inj.add_brownout("host_dram", crash_at, crash_at + 0.05)
            inj.schedule_crash(crash_replica, crash_at)
            return inj

        _, _, tok1, _ = _held_to_reference(setup, reqs, injector,
                                           retry=dict(max_attempts=2), telemetry=True)
        assert tok1 == tok0
