"""Fault injection and failure handling on the port, against the JAX package.

Every test of ``tests/test_faults.py`` outside its cluster half replays here
on the port's modules: the typed error taxonomy, the content checksum, the
seeded injector (whose draws must also equal the reference injector's, key
for key, so a seeded schedule fails the same attempts on both), the
cost-aware retry policy, backend integrity, the store's put rollback and
corrupt-entry discard, the admission queue's drain, and the engine's three
degradation scenarios.

Each engine scenario runs the port's ``ServingEngine`` (reduced llama-7b on
the CPU, weights converted from the reference's) and the JAX engine on the
same requests, each with its own injector drawn from the same seed, and
holds the port to the reference at 1e-9: actions, matched tokens,
``degraded``, every modelled time and dollar, ``fault_stats()`` without the
injector's tally, then the tally itself, and the typed event stream field by
field.  Tokens must match exactly.  The faulted scenario also runs with
``obs.Telemetry`` on both engines, as the reference's test does: the
port's ledger conserves against its summary at 1e-9, carries one
zero-dollar ``fetch_failed`` marker per failed attempt, and equals the
reference's ledger entry by entry.
"""
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402

if HAVE_HYPOTHESIS and not os.environ.get("HYPOTHESIS_STORAGE_DIRECTORY"):
    # Every ``st.text()`` draw rewrites hypothesis's codec table under its
    # storage directory, and the checkout's ``.hypothesis/`` is tracked, so
    # the session keeps that storage in the temporary directory instead.
    # Each pytest-xdist worker imports this module while it collects, before
    # any property test of the session draws.
    from hypothesis.configuration import set_hypothesis_home_dir

    set_hypothesis_home_dir(os.path.join(tempfile.gettempdir(), "hypothesis-port"))

from repro import obs as jobs  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro_torch.kvcache import faults as pfaults  # noqa: E402
from repro_torch.kvcache.backend import HostMemoryBackend  # noqa: E402
from repro_torch.kvcache.faults import (  # noqa: E402
    CorruptPayload,
    FaultInjector,
    KeyNotFound,
    RetryPolicy,
    StorageError,
    TierUnavailable,
    payload_checksum,
    retryable,
)
from repro_torch.kvcache.hierarchy import DiskSpillBackend, TieredStore, TierSpec  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.serving import Request  # noqa: E402
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.scheduler import AdmissionQueue  # noqa: E402
from test_torch_engine import _close, _serve_both, _setup  # noqa: E402
from test_torch_obs import _same_ledger  # noqa: E402

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# Typed errors
# --------------------------------------------------------------------------- #
class TestTypedErrors:
    def test_retryable_classification(self):
        assert retryable(TierUnavailable("x", tier="s3"))
        assert retryable(CorruptPayload("x", at_rest=False))
        assert not retryable(CorruptPayload("x", at_rest=True))
        assert not retryable(KeyNotFound("x", tier="s3", key="k"))
        assert not retryable(ValueError("not a storage error"))

    def test_key_not_found_is_a_key_error(self):
        with pytest.raises(KeyError):
            raise KeyNotFound("gone", tier="host_dram", key="k")

    def test_error_carries_accounting_context(self):
        e = TierUnavailable("drop", tier="s3", key="k", delay_s=0.25,
                            wasted_bytes=1024.0, reason="unavailable")
        assert (e.tier, e.key, e.delay_s, e.wasted_bytes, e.reason) == \
            ("s3", "k", 0.25, 1024.0, "unavailable")
        assert isinstance(e, StorageError)


# --------------------------------------------------------------------------- #
# Content checksum
# --------------------------------------------------------------------------- #
class TestChecksum:
    def test_container_identity_irrelevant(self):
        a = {"k": np.arange(6, dtype=np.float32), "v": [1, 2, (3, "s")]}
        b = {"k": np.arange(6, dtype=np.float32), "v": [1, 2, (3, "s")]}
        assert payload_checksum(a) == payload_checksum(b)
        # the reference stamps the same content with the same checksum
        assert payload_checksum(a) == jfaults.payload_checksum(a)

    def test_content_change_detected(self):
        a = {"k": np.zeros(4, np.float32)}
        b = {"k": np.zeros(4, np.float32)}
        b["k"][2] = 1e-7
        assert payload_checksum(a) != payload_checksum(b)

    def test_dtype_and_shape_matter(self):
        assert payload_checksum(np.zeros(4, np.float32)) != \
            payload_checksum(np.zeros(4, np.float64))
        assert payload_checksum(np.zeros((2, 2), np.float32)) != \
            payload_checksum(np.zeros(4, np.float32))


# --------------------------------------------------------------------------- #
# Seeded injector
# --------------------------------------------------------------------------- #
class TestInjector:
    def test_deterministic_across_instances(self):
        a = FaultInjector(seed=5, fail_rate=0.3, corrupt_rate=0.2)
        b = FaultInjector(seed=5, fail_rate=0.3, corrupt_rate=0.2)
        j = jfaults.FaultInjector(seed=5, fail_rate=0.3, corrupt_rate=0.2)
        keys = [f"k{i}" for i in range(200)]
        fails = [a.should_fail("s3", k) for k in keys]
        assert fails == [b.should_fail("s3", k) for k in keys]
        assert fails == [j.should_fail("s3", k) for k in keys]
        corrupts = [a.should_corrupt("s3", k) for k in keys]
        assert corrupts == [b.should_corrupt("s3", k) for k in keys]
        assert corrupts == [j.should_corrupt("s3", k) for k in keys]
        assert a.stats() == j.stats()

    def test_interleaving_independent(self):
        """The n-th draw for a (tier, key) is a pure hash: what other keys or
        tiers did in between cannot change it."""
        a = FaultInjector(seed=9, fail_rate=0.4)
        b = FaultInjector(seed=9, fail_rate=0.4)
        seq_a = [a.should_fail("s3", "hot") for _ in range(20)]
        seq_b = []
        for i in range(20):
            b.should_fail("host_dram", f"noise{i}")  # interleaved traffic
            seq_b.append(b.should_fail("s3", "hot"))
            b.should_fail("s3", f"other{i}")
        assert seq_a == seq_b
        j = jfaults.FaultInjector(seed=9, fail_rate=0.4)
        assert seq_a == [j.should_fail("s3", "hot") for _ in range(20)]

    def test_rates_are_respected_statistically(self):
        inj = FaultInjector(seed=0, fail_rate=0.3, corrupt_rate=0.1)
        n = 4000
        fails = sum(inj.should_fail("s3", f"k{i}") for i in range(n))
        corrupts = sum(inj.should_corrupt("s3", f"k{i}") for i in range(n))
        assert abs(fails / n - 0.3) < 0.05
        assert abs(corrupts / n - 0.1) < 0.05
        assert inj.stats()["injected_failures"] == fails

    def test_per_tier_rates_and_arm(self):
        inj = FaultInjector(seed=1, fail_rate={"s3": 1.0})
        assert inj.should_fail("s3", "k")
        assert not inj.should_fail("host_dram", "k")
        inj.arm(fail_rate={"*": 0.0})
        assert not inj.should_fail("s3", "k")

    def test_brownout_window(self):
        inj = FaultInjector(seed=0)
        inj.add_brownout("host_dram", 1.0, 2.0)
        assert not inj.browned_out("host_dram", 0.5)
        assert inj.browned_out("host_dram", 1.0)
        assert inj.browned_out("host_dram", 1.999)
        assert not inj.browned_out("host_dram", 2.0)  # half-open window
        assert not inj.browned_out("s3", 1.5)
        assert inj.stats()["brownout_rejections"] == 2

    def test_due_crashes_pop_once(self):
        inj = FaultInjector(seed=0)
        inj.schedule_crash(1, 0.5)
        inj.schedule_crash(0, 2.0)
        assert inj.due_crashes(0.4) == []
        due = inj.due_crashes(1.0)
        assert [(c.replica, c.at_s) for c in due] == [(1, 0.5)]
        assert inj.due_crashes(1.0) == []  # popped, not re-fired
        assert [(c.replica, c.at_s) for c in inj.due_crashes(3.0)] == [(0, 2.0)]
        assert inj.stats()["crashes_fired"] == 2

    @given(seed=st.integers(0, 2**32 - 1),
           rate=st.floats(0.0, 1.0),
           key=st.text(min_size=1, max_size=12))
    @settings(max_examples=50, deadline=None, derandomize=True)
    def test_draw_sequence_is_pure(self, seed, rate, key):
        a = FaultInjector(seed=seed, fail_rate=rate)
        b = FaultInjector(seed=seed, fail_rate=rate)
        j = jfaults.FaultInjector(seed=seed, fail_rate=rate)
        seq = [a.should_fail("s3", key) for _ in range(8)]
        assert seq == [b.should_fail("s3", key) for _ in range(8)]
        assert seq == [j.should_fail("s3", key) for _ in range(8)]


# --------------------------------------------------------------------------- #
# Retry policy
# --------------------------------------------------------------------------- #
class TestRetryPolicy:
    def test_backoff_grows_exponentially(self):
        p = RetryPolicy(backoff_s=0.01, backoff_factor=2.0)
        assert p.backoff(1) == pytest.approx(0.01)
        assert p.backoff(2) == pytest.approx(0.02)
        assert p.backoff(3) == pytest.approx(0.04)

    def test_attempt_bounds_and_tier_override(self):
        p = RetryPolicy(max_attempts=3, tier_max_attempts={"s3": 1}, cost_aware=False)
        exc = TierUnavailable("x", tier="host_dram")
        assert p.should_retry(exc, 1)
        assert p.should_retry(exc, 2)
        assert not p.should_retry(exc, 3)
        assert not p.should_retry(TierUnavailable("x", tier="s3"), 1)

    def test_permanent_failures_never_retry(self):
        p = RetryPolicy(cost_aware=False)
        assert not p.should_retry(KeyNotFound("x", tier="s3", key="k"), 1)
        assert not p.should_retry(CorruptPayload("x", at_rest=True), 1)
        assert p.should_retry(CorruptPayload("x", at_rest=False), 1)

    def test_cost_gate_prefers_recompute_when_cheaper(self):
        p = RetryPolicy(max_attempts=5, cost_aware=True)
        exc = TierUnavailable("x", tier="s3")
        assert p.should_retry(exc, 1, retry_cost=1e-6, recompute_cost=1e-3)
        assert not p.should_retry(exc, 1, retry_cost=1e-3, recompute_cost=1e-6)

    def test_retry_cost_prices_idle_gpu_and_refetch(self):
        p = RetryPolicy()
        gb = 1024.0 ** 3
        kw = dict(backoff_s=0.1, est_load_s=0.4, nbytes=2 * gb, gpu_cost_per_s=10.0,
                  per_gb_fee=0.5)
        assert p.retry_cost(**kw) == pytest.approx(10.0 * 0.5 + 0.5 * 2)
        assert p.retry_cost(**kw) == jfaults.RetryPolicy().retry_cost(**kw)


# --------------------------------------------------------------------------- #
# Backend integrity: atomic spill, checksum verify, typed raises
# --------------------------------------------------------------------------- #
class TestBackendIntegrity:
    def test_disk_spill_atomic_no_stray_tmp(self, tmp_path):
        b = DiskSpillBackend("local_nvme", root=tmp_path)
        b.put("k", {"x": np.arange(8, dtype=np.float32)}, nbytes=32.0)
        assert not list(tmp_path.glob("*.tmp"))
        payload, _ = b.get("k")
        assert np.allclose(payload["x"], np.arange(8, dtype=np.float32))

    def test_disk_spill_torn_file_raises_corrupt_at_rest(self, tmp_path):
        b = DiskSpillBackend("local_nvme", root=tmp_path)
        b.put("k", {"x": np.zeros(16, np.float32)}, nbytes=64.0)
        path = b._path("k")
        path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
        with pytest.raises(CorruptPayload) as ei:
            b.get("k")
        assert ei.value.at_rest

    def test_disk_spill_bitrot_fails_embedded_checksum(self, tmp_path):
        b = DiskSpillBackend("local_nvme", root=tmp_path)
        b.put("k", {"x": np.zeros(16, np.float32)}, nbytes=64.0)
        path = b._path("k")
        rec = pickle.loads(path.read_bytes())
        rec["payload"]["x"][3] = 42.0  # valid pickle, rotten content
        path.write_bytes(pickle.dumps(rec))
        with pytest.raises(CorruptPayload) as ei:
            b.get("k")
        assert ei.value.at_rest

    def test_missing_key_raises_typed_not_found(self, tmp_path):
        with pytest.raises(KeyNotFound):
            DiskSpillBackend("local_nvme", root=tmp_path).get("never-put")
        with pytest.raises(KeyNotFound):
            HostMemoryBackend("host_dram").get("never-put")

    def test_memory_backend_verifies_checksum_on_get(self):
        b = HostMemoryBackend("host_dram")
        b.put("k", {"x": np.zeros(4, np.float32)}, nbytes=16.0)
        tampered = {"x": np.zeros(4, np.float32)}
        tampered["x"][0] = 1.0
        b._data["k"] = (tampered, 16.0)
        with pytest.raises(CorruptPayload) as ei:
            b.get("k")
        assert ei.value.at_rest

    def test_injected_faults_fire_after_charge(self):
        inj = FaultInjector(seed=0, fail_rate=1.0)
        b = HostMemoryBackend("host_dram", faults=inj)
        b.put("k", {"x": np.zeros(4, np.float32)}, nbytes=16.0)
        with pytest.raises(TierUnavailable) as ei:
            b.get("k")
        assert ei.value.wasted_bytes == 16.0

    def test_brownout_fails_fast_uncharged(self):
        inj = FaultInjector(seed=0)
        inj.add_brownout("host_dram", 0.0, 10.0)
        b = HostMemoryBackend("host_dram", faults=inj)
        with pytest.raises(TierUnavailable):
            b.put("k", {"x": np.zeros(4, np.float32)}, nbytes=16.0)
        with pytest.raises(TierUnavailable) as ei:
            b.get("k")
        assert ei.value.delay_s == 0.0  # no bytes ever moved


# --------------------------------------------------------------------------- #
# Store-level handling: put rollback, corrupt-entry discard
# --------------------------------------------------------------------------- #
class TestStoreFailureHandling:
    def _store(self, faults=None):
        return TieredStore(tiers=[TierSpec("host_dram", 1.0)], chunk_tokens=4, faults=faults,
                           device="cpu")

    def test_failed_put_rolls_back_all_bookkeeping(self):
        inj = FaultInjector(seed=0)
        inj.add_brownout("host_dram", 0.0, 10.0)
        s = self._store(faults=inj)
        eid, delay = s.put(list(range(8)), {"x": np.zeros(4, np.float32)}, tier="host_dram")
        assert eid is None and delay == 0.0
        assert s.failed_puts == 1
        assert not s.entries  # never advertised
        _, entry = s.lookup(list(range(8)))
        assert entry is None

    def test_at_rest_corruption_discards_entry(self):
        s = self._store()
        j = jhierarchy.TieredStore(tiers=[jhierarchy.TierSpec("host_dram", 1.0)],
                                   chunk_tokens=4)
        for store in (s, j):
            eid, _ = store.put(list(range(8)), {"x": np.zeros(4, np.float32)},
                               tier="host_dram")
            assert eid is not None
            tampered = {"x": np.zeros(4, np.float32)}
            tampered["x"][0] = 5.0
            store.backends["host_dram"]._data[eid] = (tampered, 16.0)
            with pytest.raises((CorruptPayload, jfaults.CorruptPayload)):
                store.fetch(eid)
            assert store.discards == 1
            assert eid not in store.entries  # the next lookup plans a recompute
        assert s.stats() == j.stats()


# --------------------------------------------------------------------------- #
# Queue drain
# --------------------------------------------------------------------------- #
def _req(i, arrival=0.0):
    return Request(req_id=i, context_tokens=[1, 2, 3], prompt_tokens=[4],
                   max_new_tokens=1, arrival_s=arrival)


class TestQueueDrain:
    def test_drain_returns_everything_once(self):
        q = AdmissionQueue()
        for i in range(4):
            q.push(_req(i, arrival=0.1 * i))
        q.pop_admissible(1.0)  # one already admitted: not drained
        got = q.drain()
        assert sorted(r.req_id for r in got) == [1, 2, 3]
        assert q.drain() == []
        assert q.pop_admissible(10.0) is None

    def test_drain_covers_pending_and_ready(self):
        q = AdmissionQueue()
        q.push(_req(0, arrival=0.0))
        q.push(_req(1, arrival=99.0))  # not yet arrived
        q.peek_next(0.0)  # promotes req 0 into the ready heap
        assert sorted(r.req_id for r in q.drain()) == [0, 1]


# --------------------------------------------------------------------------- #
# Engine: retries, degradation, brownout planning; tokens never change
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


def _requests(vocab, n=6, n_ctx=2, ctx_len=48, prompt_len=8, new=3, seed=0):
    """``tests/test_faults.py``'s request mix, drawn from the same seed."""
    rng = np.random.default_rng(seed)
    ctxs = [list(map(int, rng.integers(0, vocab, ctx_len))) for _ in range(n_ctx)]
    return [
        dict(req_id=i, context_tokens=ctxs[i % n_ctx],
             prompt_tokens=list(map(int, rng.integers(0, vocab, prompt_len))),
             max_new_tokens=new, arrival_s=i * 0.01, expected_reuses=max(n // n_ctx, 1))
        for i in range(n)
    ]


def _fault_kw(seed, retry=None, brownout=None, **rates):
    """The same injector (and retry policy) built once from each package:
    (port kwargs, reference kwargs)."""
    out = []
    for mod in (pfaults, jfaults):
        inj = mod.FaultInjector(seed=seed, **rates)
        if brownout is not None:
            inj.add_brownout(*brownout)
        kw = dict(faults=inj)
        if retry is not None:
            kw["retry_policy"] = mod.RetryPolicy(**retry)
        out.append(kw)
    return out


def _held_to_reference(llama, reqs, port_kw, jax_kw, telemetry=(None, None), **ec_kw):
    """Serve ``reqs`` on both engines (``AlwaysReusePlanner``, the
    reference's hardware and prices, the (port's, reference's)
    ``telemetry`` pair); hold records, summary, store entries, events,
    ``fault_stats()`` and the injector's tally to the reference.  Returns
    the port's engine and events."""
    eng, events, jeng, jevents = _serve_both(
        llama, reqs, "always", jax_kw=jax_kw, telemetry=telemetry, **ec_kw, **port_kw)
    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _close(recs, jrecs, "records")
    _close(eng.summary().as_dict(), jeng.summary().as_dict(), "summary")
    entries = [sorted((e.entry_id, e.tier, e.nbytes) for e in x.store.entries.values())
               for x in (eng, jeng)]
    assert entries[0] == entries[1]
    assert [type(e).__name__ for e in events] == [type(e).__name__ for e in jevents]
    _close(events, jevents, "events")
    fs, jfs = eng.fault_stats(), jeng.fault_stats()
    assert fs.keys() == jfs.keys()
    _close({k: v for k, v in fs.items() if k != "injector"},
           {k: v for k, v in jfs.items() if k != "injector"}, "fault_stats")
    assert fs.get("injector") == jfs.get("injector")
    return eng, events


def _tokens(eng):
    return {r.req_id: r.tokens for r in eng.records}


class TestEngineDegradation:
    def test_faulted_engine_is_token_identical(self, llama):
        reqs = _requests(llama[2].vocab)
        clean, _ = _held_to_reference(llama, reqs, {}, {})
        port_kw, jax_kw = _fault_kw(7, retry=dict(max_attempts=2, cost_aware=False),
                                    fail_rate=0.4, corrupt_rate=0.2)
        tel, jtel = Telemetry(), jobs.Telemetry()
        eng, events = _held_to_reference(llama, reqs, port_kw, jax_kw, telemetry=(tel, jtel))
        assert _tokens(eng) == _tokens(clean)
        fs = eng.fault_stats()
        assert fs["fetch_failures"] > 0
        assert fs["fetch_wasted_bytes"] > 0
        evs = [e for _, e in tel.events]  # replica-tagged, replica 0 here
        assert evs == events
        n_failed = sum(isinstance(e, ev.FetchFailed) for e in evs)
        n_deg = sum(isinstance(e, ev.DegradedToRecompute) for e in evs)
        assert n_failed == fs["fetch_failures"]
        assert n_deg == fs["degraded_requests"]
        # degraded requests are recorded as recompute and flagged
        degraded_ids = {e.req_id for e in evs if isinstance(e, ev.DegradedToRecompute)}
        for rec in eng.records:
            assert rec.degraded == (rec.req_id in degraded_ids)
            if rec.degraded:
                assert rec.action == "recompute"
        # the ledger still conserves, wasted attempts marked zero-dollar
        assert max(tel.check(eng.summary()).values()) <= 1e-9
        marks = [e for e in tel.ledger.entries if e.activity == "fetch_failed"]
        assert len(marks) == fs["fetch_failures"]
        assert all(m.dollars == 0.0 and m.nbytes > 0 for m in marks)
        assert fs["fetch_retries"] > 0 and "fetch_retry" in tel.ledger.by_activity()
        _same_ledger(tel.ledger, jtel.ledger)

    def test_cost_aware_gate_skips_pointless_retries(self, llama):
        """At reduced-config scale recomputing a short prefix costs almost
        nothing, so the cost-aware gate degrades instead of retrying."""
        reqs = _requests(llama[2].vocab)
        port_kw, jax_kw = _fault_kw(7, retry=dict(max_attempts=3), fail_rate=0.8)
        eng, _ = _held_to_reference(llama, reqs, port_kw, jax_kw)
        fs = eng.fault_stats()
        assert fs["fetch_failures"] > 0 and fs["fetch_retries"] == 0

    @pytest.mark.parametrize("decode", ["dense", "paged", "unified"])
    def test_brownout_plans_around_the_tier(self, llama, decode):
        """Entries ingested before the window exist on the browned-out tier,
        but requests arriving inside it plan an honest recompute: the lookup
        excludes unavailable tiers, so no fetch is ever attempted."""
        reqs = _requests(llama[2].vocab)
        late = [dict(r, req_id=r["req_id"] + 10, arrival_s=1e3 + r["arrival_s"])
                for r in reqs[:2]]
        kw = dict(tier_specs=[TierSpec("host_dram", 1.0)], store_tier="host_dram",
                  paged_decode=decode != "dense", unified_step=decode == "unified")
        jkw = dict(tier_specs=[jhierarchy.TierSpec("host_dram", 1.0)])
        clean, _ = _held_to_reference(llama, reqs + late, {}, jkw, **kw)
        port_kw, jax_kw = _fault_kw(1, brownout=("host_dram", 500.0, 1e9))
        eng, _ = _held_to_reference(llama, reqs + late, port_kw, {**jax_kw, **jkw}, **kw)
        assert _tokens(eng) == _tokens(clean)
        acts = {r.req_id: r.action for r in eng.records}
        assert "load" in acts.values()  # pre-window traffic did reuse
        assert len(eng.store.entries) > 0  # entries exist on the dead tier
        assert all(acts[r["req_id"]] == "recompute" for r in late)
        # planned around, never attempted: degradation-free graceful path
        assert eng.fault_stats()["fetch_failures"] == 0
        assert eng.ec.faults.stats()["brownout_rejections"] > 0


@pytest.mark.parametrize("decode", ["paged", "unified"])
def test_faulted_engine_replays_under_paged_and_unified_decode(llama, decode):
    """The faulted scenario of ``test_faulted_engine_is_token_identical``
    under paged decode and the unified step: the same failed attempts,
    retries and degradations as the JAX engine, the fault-free tokens."""
    reqs = _requests(llama[2].vocab)
    kw = dict(paged_decode=True, unified_step=decode == "unified")
    clean, _ = _held_to_reference(llama, reqs, {}, {}, **kw)
    port_kw, jax_kw = _fault_kw(7, retry=dict(max_attempts=2, cost_aware=False),
                                fail_rate=0.4, corrupt_rate=0.2)
    eng, events = _held_to_reference(llama, reqs, port_kw, jax_kw, **kw)
    assert _tokens(eng) == _tokens(clean)
    assert eng.fault_stats()["fetch_failures"] > 0
    assert sum(isinstance(e, ev.FetchFailed) for e in events) == \
        eng.fault_stats()["fetch_failures"]
