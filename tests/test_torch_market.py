"""The port's KV marketplace (``repro_torch.market``) against the JAX package's.

The 18 tests of ``tests/test_market.py`` replay here on the port, each fed
to both packages' objects with the same operations and held to the
reference: settlement accounts, fees and totals at 1e-9, reputation scores
and blacklists exactly, catalogs, ACLs and quotes field by field (prices at
1e-9, checksums equal).  The serves (reduced llama-7b, f32, on the CPU, the
reference's weights converted and its hardware and prices on both sides)
hold the port's tokens exactly to the reference's, and its records, events,
``mp.stats()``, settlement ledger and summary at 1e-9.

The reference's spot check compares bought KV with a fresh prefill bitwise,
and on this CPU that rejects its own honest purchase: the seller's rows come
out of a packed launch, the check's out of a per-request prefill, and they
differ in the last bits (``test_reference_bitwise_check_rejects_honest_purchase``
pins it).  The port's check is a tolerance check (``SPOT_CHECK_TOL``).  So
on the reference engine instance only, and only in these tests,
``market_spot_check`` is replaced through ``monkeypatch`` by the same
tolerance rule over the reference's own ``_jit_prefill``, ``extract_slot``
and ``insert_slot`` (``_tolerant``).  Nothing of the reference changes.

Then the port's own cases, each held to the reference so substituted: a
purchase under paged decode and under the unified step, a purchase by
mamba2 engines (whose admissions take ``_admit_single``), a seller that
publishes another context's KV under this context's key, the seller's
stored payload left as it was, a two-replica market cluster, and a market
serve's trace and telemetry.  Last, ROADMAP C11's market half on reduced
mixtral (a ring of 16 rows): a buyer never buys a wrapped ring, whole or in
part, where the reference's planner takes the quote; a ring that has not
wrapped is bought and passes the spot check.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import market as jmarket  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core.perf_model import PerfModel as JPerfModel  # noqa: E402
from repro.core.perf_model import V100_X4_HF as J_V100  # noqa: E402
from repro.core.pricing import AWS_PAPER as J_AWS  # noqa: E402
from repro.kvcache import faults as jfaults  # noqa: E402
from repro.kvcache import hierarchy as jhierarchy  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.kvcache import transfer as jtransfer  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro_torch import market as pmarket  # noqa: E402
from repro_torch import obs as pobs  # noqa: E402
from repro_torch import serving as pserving  # noqa: E402
from repro_torch.core.perf_model import PerfModel, V100_X4_HF  # noqa: E402
from repro_torch.core.pricing import AWS_PAPER  # noqa: E402
from repro_torch.kvcache import faults as pfaults  # noqa: E402
from repro_torch.kvcache import hierarchy as phierarchy  # noqa: E402
from repro_torch.kvcache import transfer as ptransfer  # noqa: E402
from repro_torch.kvcache.faults import payload_checksum  # noqa: E402
from repro_torch.market.market import _tamper  # noqa: E402
from repro_torch.serving import events as pev  # noqa: E402
from repro_torch.serving import trace as ptrace  # noqa: E402
from repro_torch.serving.engine import SPOT_CHECK_TOL  # noqa: E402
from test_torch_engine import _close, _reference_perf_and_pricing, _setup  # noqa: E402
from test_torch_obs import _same, _same_ledger, _same_snapshot  # noqa: E402

torch.set_num_threads(1)

# each package's modules and objects, so one scenario runs on either
PORT = types.SimpleNamespace(
    port=True, market=pmarket, serving=pserving, ev=pev, faults=pfaults, hier=phierarchy,
    transfer=ptransfer, obs=pobs, trace=ptrace, pricing=AWS_PAPER,
    perf=lambda: PerfModel(V100_X4_HF))
REF = types.SimpleNamespace(
    port=False, market=jmarket, serving=jserving, ev=jev, faults=jfaults, hier=jhierarchy,
    transfer=jtransfer, obs=jobs, trace=jtrace, pricing=J_AWS,
    perf=lambda: JPerfModel(J_V100))
F32_TOL = SPOT_CHECK_TOL["float32"]


@pytest.fixture(scope="module")
def llama():
    return _setup("llama-7b")


@pytest.fixture(scope="module")
def mamba():
    return _setup("mamba2-1.3b")


def _requests(vocab, n, seed=0, ctx_len=64, prompt_len=8):
    """``tests/test_market.py``'s requests: one context, ``n`` prompts."""
    rng = np.random.default_rng(seed)
    ctx = tuple(map(int, rng.integers(0, vocab, ctx_len)))
    return [
        dict(req_id=i, context_tokens=ctx,
             prompt_tokens=tuple(map(int, rng.integers(0, vocab, prompt_len))),
             max_new_tokens=3, arrival_s=i * 0.01)
        for i in range(n)
    ]


def _reading(want_leaves, got_leaves) -> float:
    """The port's spot-check reading over two lists of leaves."""
    out = 0.0
    for w, g in zip(want_leaves, got_leaves):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        out = max(out, np.abs(g - w).max() / max(1.0, np.abs(w).max()))
    return out


def _reference_reading(jeng, context_tokens, artifact, n):
    """The reference engine's own spot-check canonicalisation (a fresh
    ``_jit_prefill`` of the first ``n`` tokens, ``extract_slot`` and
    ``insert_slot``), read by the port's rule."""
    tokens = jnp.asarray([list(context_tokens[:n])], jnp.int32)
    temp = jeng.api.init_state(jeng.cfg, 1, jeng.ec.max_len)
    _, fresh = jeng._jit_prefill(jeng.params, tokens, temp)
    want = jpaged.extract_slot(jeng.cfg, fresh, 0, n)
    temp = jeng.api.init_state(jeng.cfg, 1, jeng.ec.max_len)
    temp = jpaged.insert_slot(jeng.cfg, temp, 0, artifact, n_tokens=n)
    got = jpaged.extract_slot(jeng.cfg, temp, 0, n)
    return _reading(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got))


def _tolerant(monkeypatch, jeng):
    """Replace the reference engine instance's bitwise ``market_spot_check``
    by the port's tolerance rule (f32) over its own prefill and slot
    layout; everything else of the check (sample length, modelled seconds
    and dollars) is the reference's."""
    def check(context_tokens, artifact, n_tokens):
        n = int(min(n_tokens, len(context_tokens)))
        if n <= 0:
            return True, 0.0, 0.0
        ok = _reference_reading(jeng, context_tokens, artifact, n) <= F32_TOL
        verify_s = jeng.perf.t_prefill(jeng.cost_cfg, n)
        return bool(ok), verify_s, jeng._c_gpu_s * verify_s
    monkeypatch.setattr(jeng, "market_spot_check", check)


def _engine(pkg, model, monkeypatch=None, *, market=None, planner=None, telemetry=None,
            replica=0, **ec_kw):
    """``tests/test_market.py``'s ``_engine`` on one package: the reference's
    default hardware and prices on both (the port's rebuilt from them), and
    on the reference the tolerant spot check when ``monkeypatch`` is given."""
    jcfg, jparams, cfg, params = model
    kw = dict(max_slots=2, max_len=128, chunk_tokens=16)
    kw.update(ec_kw)
    common = dict(planner=planner, market=market, telemetry=telemetry,
                  telemetry_replica=replica)
    if pkg.port:
        perf, pricing = _reference_perf_and_pricing()
        return pserving.ServingEngine(
            cfg, params, engine_cfg=pserving.EngineConfig(**kw), perf=perf, pricing=pricing,
            device="cpu", **common)
    eng = jserving.ServingEngine(jcfg, jparams, engine_cfg=jserving.EngineConfig(**kw),
                                 **common)
    if monkeypatch is not None:
        _tolerant(monkeypatch, eng)
    return eng


def _run(pkg, eng, reqs):
    for r in reqs:
        eng.submit(pkg.serving.Request(**r))
    eng.last_events = list(eng.drain())
    return {rec.req_id: rec.tokens for rec in eng.records}


def _planner(pkg, **kw):
    return pkg.market.MarketPlanner(pkg.serving.AlwaysReusePlanner(), **kw)


def _store(pkg, cap_gb=1.0):
    clock = pkg.transfer.SimClock()
    tr = pkg.transfer.TransferModel(pkg.perf(), pkg.pricing)
    return pkg.hier.TieredStore(
        tiers=[pkg.hier.TierSpec("host_dram", cap_gb)], transfer=tr, clock=clock,
        chunk_tokens=4, pricing=pkg.pricing,
        backends={"host_dram": pkg.hier.HostMemoryBackend("host_dram", transfer=tr,
                                                          clock=clock)},
        **(dict(device="cpu") if pkg.port else {}))


def _art(i, floats=64):
    return {"k": np.full((1, floats), float(i), np.float32)}


def _strip(x):
    """``x`` as plain data with every ``checksum`` key dropped: a quote's
    stamp hashes the seller's stored bytes, which each package computes
    itself (equal at 1e-6, not bit for bit)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _strip({"__class__": type(x).__name__,
                       **{f.name: getattr(x, f.name) for f in dataclasses.fields(x)}})
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "checksum"}
    if isinstance(x, (list, tuple)):
        return [_strip(v) for v in x]
    return x


def _hold_engines(eng, jeng, where):
    """A port engine held to a reference engine after a serve: tokens
    exactly; records, events, the market counters and the summary at 1e-9."""
    recs = sorted(eng.records, key=lambda r: r.req_id)
    jrecs = sorted(jeng.records, key=lambda r: r.req_id)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs], where
    _same(_strip(recs), _strip(jrecs), f"{where} records")
    _same(_strip(eng.last_events), _strip(jeng.last_events), f"{where} events")
    for attr in ("market_purchases", "market_failed", "market_spend", "degraded_requests"):
        _same(getattr(eng, attr), getattr(jeng, attr), f"{where} {attr}")
    _same(eng.summary().as_dict(), jeng.summary().as_dict(), f"{where} summary")


def _hold_markets(mp, jmp):
    """``mp.stats()`` (counters, reputation, the settlement's accounts and
    rows) and the settlement ledger, entry by entry, at 1e-9."""
    _same(mp.stats(), jmp.stats(), "stats")
    _same_ledger(mp.settlement, jmp.settlement)
    assert mp.settlement.assert_conserved(1e-9) <= 1e-9


def _trade(pkg, model, monkeypatch, reqs, *, adversary=False, mp_kw=None, **ec_kw):
    """The reference's two-engine purchase on one package: seller ``s``
    serves ``reqs[:1]`` and writes it back, then (if ``adversary``) is armed
    to corrupt every delivery, then buyer ``b`` serves ``reqs[1:]``.
    Returns (marketplace, seller, buyer, buyer's tokens)."""
    mp = pkg.market.Marketplace(**{**dict(verify_rate=1.0, seed=0), **(mp_kw or {})})
    seller = _engine(pkg, model, monkeypatch, market=mp.join("s"), planner=_planner(pkg),
                     **ec_kw)
    _run(pkg, seller, reqs[:1])
    if adversary:
        inj = pkg.faults.FaultInjector(seed=0)
        inj.arm(corrupt_rate=1.0)
        mp.arm_adversary("s", inj)
    buyer = _engine(pkg, model, monkeypatch, market=mp.join("b"), planner=_planner(pkg),
                    **ec_kw)
    return mp, seller, buyer, _run(pkg, buyer, reqs[1:])


def _both_trades(model, monkeypatch, reqs, **kw):
    """``_trade`` on both packages; the port held to the reference."""
    out = [_trade(pkg, model, monkeypatch, reqs, **kw) for pkg in (PORT, REF)]
    (mp, _, buyer, _), (jmp, _, jbuyer, _) = out
    _hold_engines(buyer, jbuyer, "buyer")
    _hold_markets(mp, jmp)
    return out


def _assert_seller_intact(mp, seller):
    """Every entry of the seller's store still hashes to the stamp its
    catalog took before the buyer served: no purchase wrote into it."""
    ts = mp.tenants["s"]
    assert ts._checksums and seller.store.entries
    for eid, e in seller.store.entries.items():
        stamp = ts._checksums[(eid, e.compressed)]
        assert payload_checksum(seller.store.backends[e.tier].peek(eid)) == stamp, eid


# --------------------------------------------------------------------------- #
# Settlement: double-entry conservation
# --------------------------------------------------------------------------- #
class TestSettlement:
    def test_single_purchase_books_both_sides(self):
        out = []
        for pkg in (PORT, REF):
            led = pkg.market.SettlementLedger(fee_rate=0.10, flat_fee=0.5)
            price = led.buyer_price(2.0)
            assert price == pytest.approx(2.5)
            credit = led.settle_purchase(
                buyer="a", seller="b", price=price, nbytes=100.0, entry_id="e0",
            )
            fee = led.fee_for(price)
            assert fee == pytest.approx(0.5 + 0.10 * 2.0)
            assert credit == pytest.approx(price - fee)
            assert led.accounts["a"] == pytest.approx(-price)
            assert led.accounts["b"] == pytest.approx(credit)
            # the category nets to exactly the fees
            assert led.totals()["market"] == pytest.approx(fee)
            assert led.assert_conserved(1e-9) <= 1e-9
            out.append((led, credit, fee))
        _same(out[0][1:], out[1][1:], "credit, fee")
        _same_ledger(out[0][0], out[1][0])

    def test_dedup_credit_moves_no_dollars(self):
        leds = []
        for pkg in (PORT, REF):
            led = pkg.market.SettlementLedger()
            led.record_dedup_credit("a", 1234.0)
            assert led.dedup_bytes == 1234.0 and led.n_dedup_credits == 1
            assert led.totals()["market"] == 0.0
            assert not led.accounts
            led.assert_conserved(1e-9)
            leds.append(led)
        _same_ledger(*leds)

    @settings(max_examples=50, deadline=None)
    @given(
        trades=st.lists(
            st.tuples(
                st.integers(0, 4),  # buyer
                st.integers(0, 4),  # seller
                st.floats(0.0, 1e3, allow_nan=False, allow_infinity=False),
                st.floats(0.0, 1e6, allow_nan=False, allow_infinity=False),
            ),
            min_size=1, max_size=40,
        ),
        fee_rate=st.floats(0.0, 0.5),
        flat_fee=st.floats(0.0, 1.0),
    )
    def test_conservation_under_random_trades(self, trades, fee_rate, flat_fee):
        leds = []
        for pkg in (PORT, REF):
            led = pkg.market.SettlementLedger(fee_rate=fee_rate, flat_fee=flat_fee)
            for bi, si, ask, nb in trades:
                led.settle_purchase(
                    buyer=f"t{bi}", seller=f"t{si}",
                    price=led.buyer_price(ask), nbytes=nb, entry_id="e",
                )
            assert led.assert_conserved(1e-9) <= 1e-9
            assert led.debits == pytest.approx(led.credits + led.fees_collected)
            leds.append(led)
        _same_ledger(*leds)


# --------------------------------------------------------------------------- #
# Reputation: price-down then blacklist; blacklisted = never matched again
# --------------------------------------------------------------------------- #
class TestReputation:
    def test_corrupt_delivery_blacklists(self):
        books = []
        for pkg in (PORT, REF):
            book = pkg.market.ReputationBook(blacklist_after=1)
            assert book.record_verification("s", ok=False) is True
            assert book.is_blacklisted("s")
            # repeat failures do not "re-blacklist" (the event fires once)
            assert book.record_verification("s", ok=False) is False
            books.append(book.as_dict())
        assert books[0] == books[1]

    def test_score_decays_and_recovers(self):
        books = []
        for pkg in (PORT, REF):
            book = pkg.market.ReputationBook(blacklist_after=3, decay=0.5, recover=0.1)
            book.record_verification("s", ok=False)
            low = book.score("s")
            assert low < 1.0 and not book.is_blacklisted("s")
            assert book.price_multiplier("s") > 1.0
            book.record_verification("s", ok=True)
            assert book.score("s") > low
            books.append((low, book.price_multiplier("s"), book.as_dict()))
        assert books[0] == books[1]

    def test_blacklisted_seller_never_quoted(self):
        quotes = []
        for pkg in (PORT, REF):
            mp = pkg.market.Marketplace()
            store = _store(pkg)
            toks = list(range(16))
            store.put(toks, _art(1), tier="host_dram")
            mp.register("s", pkg.market.TenantStore("s", store, pricing=pkg.pricing))
            q = mp.quote("b", toks)
            assert q is not None
            mp.reputation.record_verification("s", ok=False)
            assert mp.reputation.is_blacklisted("s")
            assert mp.quote("b", toks) is None
            quotes.append((q, mp.stats()))
        _same(*quotes, "quote, stats")

    @settings(max_examples=30, deadline=None)
    @given(outcomes=st.lists(st.booleans(), min_size=1, max_size=30))
    def test_blacklist_is_permanent(self, outcomes):
        """Once corrupt deliveries cross the threshold, no sequence of later
        successes resurrects the seller; both books agree at every step."""
        books = [pkg.market.ReputationBook(blacklist_after=2) for pkg in (PORT, REF)]
        dead_at = None
        for i, ok in enumerate(outcomes):
            newly = [book.record_verification("s", ok=ok) for book in books]
            assert newly[0] == newly[1]
            assert books[0].as_dict() == books[1].as_dict()
            if dead_at is None and books[0].is_blacklisted("s"):
                dead_at = i
            if dead_at is not None:
                assert books[0].is_blacklisted("s")
        assert (dead_at is not None) == (outcomes.count(False) >= 2)


# --------------------------------------------------------------------------- #
# ACL: a private entry is invisible to every other tenant
# --------------------------------------------------------------------------- #
class TestACL:
    def test_private_entry_never_quoted(self):
        seen = []
        for pkg in (PORT, REF):
            mp = pkg.market.Marketplace()
            store = _store(pkg)
            toks = list(range(16))
            eid, _ = store.put(toks, _art(1), tier="host_dram")
            ts = pkg.market.TenantStore("s", store, pricing=pkg.pricing)
            mp.register("s", ts)
            first = mp.quote("b", toks)
            assert first is not None
            ts.set_private(eid)
            assert mp.quote("b", toks) is None
            assert all(e.entry_id != eid for e in ts.catalog().entries)
            private_catalog = ts.catalog()
            ts.set_public(eid)
            again = mp.quote("b", toks)
            assert again is not None
            seen.append((first, private_catalog, ts.catalog(), again))
        _same(*seen, "quotes, catalogs")

    def test_self_quotes_excluded(self):
        """A tenant never buys its own entry: its store serves it for free."""
        for pkg in (PORT, REF):
            mp = pkg.market.Marketplace()
            store = _store(pkg)
            toks = list(range(16))
            store.put(toks, _art(1), tier="host_dram")
            mp.register("s", pkg.market.TenantStore("s", store, pricing=pkg.pricing))
            assert mp.quote("s", toks) is None

    @settings(max_examples=30, deadline=None)
    @given(private=st.sets(st.integers(0, 5)), probe=st.integers(0, 5))
    def test_acl_filtering_is_exact(self, private, probe):
        """Quote iff the probed context's entry is public: tenant B can never
        fetch (or even see) tenant A's private entries; both packages quote
        the same."""
        got = []
        for pkg in (PORT, REF):
            mp = pkg.market.Marketplace()
            store = _store(pkg)
            ts = pkg.market.TenantStore("a", store, pricing=pkg.pricing)
            mp.register("a", ts)
            eids = {}
            for i in range(6):
                # disjoint contexts (different first token => different trie path)
                toks = [i * 100 + j for j in range(8)]
                eids[i], _ = store.put(toks, _art(i), tier="host_dram")
            for i in private:
                ts.set_private(eids[i])
            q = mp.quote("b", [probe * 100 + j for j in range(8)])
            if probe in private:
                assert q is None
            else:
                assert q is not None and q.entry_id == eids[probe]
            got.append((q, ts.catalog()))
        _same(*got, "quote, catalog")


# --------------------------------------------------------------------------- #
# Quoting and the buy-vs-recompute decision
# --------------------------------------------------------------------------- #
class TestQuoting:
    def test_ask_price_arithmetic(self):
        asks = []
        for pkg in (PORT, REF):
            store = _store(pkg)
            eid, _ = store.put(list(range(16)), _art(1), tier="host_dram", saved_per_use=8.0)
            ts = pkg.market.TenantStore(
                "s", store, pricing=pkg.pricing,
                write_premium=0.25, expected_sales=4.0, margin=0.10,
            )
            e = store.entries[eid]
            fee = pkg.pricing.tier("host_dram").per_gb_transfer_fee * e.nbytes / 1e9
            assert ts.ask_dollars(e) == pytest.approx(1.10 * fee + 0.25 * 8.0 / 4.0)
            asks.append(ts.ask_dollars(e))
        _same(*asks, "ask")

    def test_longest_match_wins_then_price(self):
        quotes = []
        for pkg in (PORT, REF):
            mp = pkg.market.Marketplace()
            toks = list(range(32))
            s_long, s_short = _store(pkg), _store(pkg)
            s_long.put(toks, _art(1), tier="host_dram", saved_per_use=100.0)
            s_short.put(toks[:16], _art(2), tier="host_dram", saved_per_use=0.0)
            mp.register("long", pkg.market.TenantStore("long", s_long, pricing=pkg.pricing))
            mp.register("short", pkg.market.TenantStore("short", s_short, pricing=pkg.pricing))
            q = mp.quote("b", toks)
            # the longer (more expensive) match beats the cheaper shorter one
            assert q.seller == "long" and q.matched_tokens == 32
            quotes.append(q)
        _same(*quotes, "quote")

    def test_checksum_stamped_at_publication(self):
        stamps = []
        for pkg in (PORT, REF):
            store = _store(pkg)
            eid, _ = store.put(list(range(16)), _art(7), tier="host_dram")
            ts = pkg.market.TenantStore("s", store, pricing=pkg.pricing)
            payload = store.backends["host_dram"].peek(eid)
            assert ts.checksum(eid) == pkg.faults.payload_checksum(payload)
            stamps.append(ts.checksum(eid))
        assert stamps[0] == stamps[1]

    def test_planner_flips_on_price(self, llama, monkeypatch):
        """The cost-aware buy decision: a free-ish quote wins, an exorbitant
        flat fee loses to recompute, on the same workload; each serve held
        to the reference's."""
        reqs = _requests(llama[2].vocab, 2)
        for flat_fee, expect_buy in ((0.0, True), (1e9, False)):
            (mp, _, buyer, _), _ = _both_trades(llama, monkeypatch, reqs,
                                                mp_kw=dict(flat_fee=flat_fee))
            bought = buyer.market_purchases > 0
            assert bought == expect_buy, (flat_fee, bought)


# --------------------------------------------------------------------------- #
# End to end: the purchase pipeline over two engines
# --------------------------------------------------------------------------- #
class TestMarketServing:
    def test_purchase_settles_and_tokens_bit_identical(self, llama, monkeypatch):
        """The port's honest purchase passes its spot check (the reference's
        bitwise one would refuse it) and settles, its tokens equal pure
        recompute, and it replays the reference (substituted)."""
        reqs = _requests(llama[2].vocab, 3)
        (mp, seller, buyer, toks), _ = _both_trades(llama, monkeypatch, reqs)
        assert len(seller.store.entries) == 1
        assert buyer.market_purchases == 1
        assert buyer.market_spend > 0.0
        # the bought entry was absorbed: the next identical context loads
        # locally instead of paying the market again
        assert len(buyer.store.entries) == 1
        actions = {r.req_id: (r.action, r.plan.tier) for r in buyer.records}
        assert actions[1] == ("load", "market:s")
        assert actions[2][0] == "load" and not actions[2][1].startswith("market")
        led = mp.settlement
        assert led.assert_conserved(1e-9) <= 1e-9
        _assert_seller_intact(mp, seller)
        assert led.accounts["b"] == pytest.approx(-buyer.market_spend)
        assert led.accounts["s"] == pytest.approx(buyer.market_spend - led.fees_collected)
        assert mp.tenants["s"].sales == 1
        assert mp.tenants["s"].revenue == pytest.approx(led.accounts["s"])
        # acceptance bar: tokens identical to pure recompute
        assert toks == _run(PORT, _engine(PORT, llama), reqs[1:])
        evs = [e for e in buyer.last_events if isinstance(e, pev.KVPurchased)]
        assert len(evs) == 1 and evs[0].seller == "s" and evs[0].buyer == "b"
        verified = [e for e in buyer.last_events if isinstance(e, pev.SellerVerified)]
        assert [(e.ok, e.deep) for e in verified] == [(True, True)]

    def test_adversary_blocked_blacklisted_and_exact(self, llama, monkeypatch):
        """A dishonest seller (in-flight corruption through the fault
        injector) is caught by verification, never served, blacklisted, and
        the buyer's tokens equal pure recompute; the seller's stored bytes
        are untouched by the tampering."""
        reqs = _requests(llama[2].vocab, 3)
        (mp, seller, buyer, toks), _ = _both_trades(llama, monkeypatch, reqs, adversary=True,
                                                    mp_kw=dict(blacklist_after=1))
        _assert_seller_intact(mp, seller)
        assert mp.corrupt_served == 0
        assert mp.corrupt_blocked == 1
        assert mp.purchases == 0
        assert mp.reputation.is_blacklisted("s")
        assert buyer.market_failed == 1 and buyer.market_purchases == 0
        assert mp.settlement.n_purchases == 0
        assert mp.settlement.assert_conserved(1e-9) <= 1e-9
        assert toks == _run(PORT, _engine(PORT, llama), reqs[1:])
        evs = buyer.last_events
        bad = [e for e in evs if isinstance(e, pev.SellerVerified) and not e.ok]
        assert len(bad) == 1 and not bad[0].deep  # the checksum caught it
        assert any(isinstance(e, pev.SellerBlacklisted) for e in evs)
        assert any(isinstance(e, pev.DegradedToRecompute)
                   and e.reason == "market:verify_failed" for e in evs)

    def test_market_off_is_pure_parity(self, llama):
        """market=None: the same planner chain gives identical tokens and
        actions to an engine that never heard of the marketplace, on both
        packages."""
        reqs = _requests(llama[2].vocab, 3)
        engines = []
        for pkg in (PORT, REF):
            plain = _engine(pkg, llama, planner=pkg.serving.AlwaysReusePlanner())
            toks_plain = _run(pkg, plain, reqs)
            wrapped = _engine(pkg, llama, planner=_planner(pkg))
            toks_wrapped = _run(pkg, wrapped, reqs)
            assert toks_plain == toks_wrapped
            assert [r.action for r in plain.records] == [r.action for r in wrapped.records]
            assert wrapped.market_purchases == 0
            engines.append(wrapped)
        _hold_engines(*engines, "market-off")

    def test_dedup_credit_through_shared_core(self, llama, monkeypatch):
        """KVShare: two tenants over one shared content-addressed core; the
        second tenant's write-back of identical content moves zero bytes and
        books a zero-dollar dedup credit in the settlement ledger."""
        reqs = _requests(llama[2].vocab, 2)
        out = []
        for pkg in (PORT, REF):
            jcfg, jparams, cfg, params = llama
            mp = pkg.market.Marketplace()
            core = pkg.hier.SharedBackendCore()
            engines = []
            for name in ("a", "b"):
                clock = pkg.transfer.SimClock()
                tr = pkg.transfer.TransferModel(pkg.perf(), pkg.pricing)
                backends = {"s3": pkg.hier.SharedTierBackend(
                    "s3", core=core, namespace=name, transfer=tr, clock=clock)}
                ec = pkg.serving.EngineConfig(
                    max_slots=2, max_len=128, chunk_tokens=16,
                    tier_capacities_gb={"s3": 1.0}, store_tier="s3")
                kw = dict(backends=backends, clock=clock, transfer=tr, market=mp.join(name),
                          planner=_planner(pkg, always=True))
                if pkg.port:
                    perf, pricing = _reference_perf_and_pricing()
                    eng = pserving.ServingEngine(cfg, params, engine_cfg=ec, perf=perf,
                                                 pricing=pricing, device="cpu", **kw)
                else:
                    eng = jserving.ServingEngine(jcfg, jparams, engine_cfg=ec, **kw)
                    _tolerant(monkeypatch, eng)
                engines.append(eng)
            # the same context through both tenants: B's write-back dedups
            # against A's bytes already in the core
            _run(pkg, engines[0], reqs[:1])
            _run(pkg, engines[1], reqs[1:])
            assert core.stats()["dedup_hits"] >= 1
            assert mp.settlement.n_dedup_credits >= 1
            assert mp.settlement.dedup_bytes > 0.0
            assert mp.settlement.totals()["market"] == pytest.approx(
                mp.settlement.fees_collected)
            mp.settlement.assert_conserved(1e-9)
            out.append((mp, engines, core))
        (mp, engines, core), (jmp, jengines, jcore) = out
        for eng, jeng in zip(engines, jengines):
            _hold_engines(eng, jeng, "tenant")
        _hold_markets(mp, jmp)
        _same(core.stats(), jcore.stats(), "core")


def test_reference_bitwise_check_rejects_honest_purchase(llama):
    """Why the port's spot check is a tolerance check: on the honest
    artifact (the seller's stored context), the reference's own bitwise
    ``market_spot_check`` returns False, while the largest |difference|
    from a fresh prefill lies within the f32 tolerance.  The port's check
    passes the same purchase."""
    reqs = _requests(llama[2].vocab, 2)
    sides = {}
    for pkg in (PORT, REF):
        mp = pkg.market.Marketplace(verify_rate=1.0, seed=0)
        seller = _engine(pkg, llama, market=mp.join("s"), planner=_planner(pkg))
        _run(pkg, seller, reqs[:1])
        (eid, e), = seller.store.entries.items()
        buyer = _engine(pkg, llama, market=mp.join("b"), planner=_planner(pkg))
        sides[pkg.port] = (buyer, seller.store.backends[e.tier].peek(eid))
    ctx = reqs[1]["context_tokens"]
    jbuyer, jart = sides[False]
    ok, verify_s, _ = jbuyer.market_spot_check(ctx, jart, 16)
    assert not ok and verify_s > 0
    reading = _reference_reading(jbuyer, ctx, jart, 16)
    assert 0.0 < reading <= F32_TOL, reading
    buyer, art = sides[True]
    assert buyer.market_spot_check(ctx, art, 16)[0]
    assert buyer.spot_check_reading(list(ctx[:16]), art) <= F32_TOL


# --------------------------------------------------------------------------- #
# The port's own cases, each held to the reference (substituted)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["paged", "unified"])
def test_purchase_under_paged_and_unified(llama, monkeypatch, mode):
    """The purchase under paged decode (the packed admission lands in the
    pool) and under the unified step (the bought rows land in the pool
    before the chunks): the reference's serve, the seller's stored bytes
    as they were."""
    kw = dict(paged_decode=True, kv_block=128, pack_align=128)
    if mode == "unified":
        kw["unified_step"] = True
    reqs = _requests(llama[2].vocab, 3)
    (mp, seller, buyer, toks), _ = _both_trades(llama, monkeypatch, reqs, **kw)
    assert buyer.market_purchases == 1 and buyer.decode_stats()["paged"]
    assert (buyer.unified_stats()["steps"] > 0) == (mode == "unified")
    _assert_seller_intact(mp, seller)
    assert toks == _run(PORT, _engine(PORT, llama, **kw), reqs[1:])


def test_mamba_purchase_takes_the_per_request_admission(mamba, monkeypatch):
    """mamba2 engines admit through ``_admit_single``.  The spot check
    inserts the stored state whole (SSM state is all or nothing), so a
    16-token sample cannot match a 64-token snapshot: the port decides what
    the reference (substituted) decides, and the buyer's tokens equal pure
    recompute."""
    reqs = _requests(mamba[2].vocab, 3)
    (mp, _, buyer, toks), (jmp, _, jbuyer, _) = _both_trades(mamba, monkeypatch, reqs)
    assert not buyer._packable
    assert (buyer.market_purchases, buyer.market_failed) == (0, 1)
    verified = [e for e in buyer.last_events if isinstance(e, pev.SellerVerified)]
    assert [(e.ok, e.deep) for e in verified] == [(False, True)]
    assert [type(e).__name__ for e in buyer.last_events] == \
        [type(e).__name__ for e in jbuyer.last_events]
    assert toks == _run(PORT, _engine(PORT, mamba), reqs[1:])


def test_wrong_rows_under_a_valid_checksum_fail_the_spot_check(llama, monkeypatch):
    """A seller publishes context B's KV under context A's key: the
    checksum is valid (stamped from the published bytes), the rows are
    not this model's KV for A.  The spot check refuses the delivery
    (``SellerVerified(ok=False, deep=True)``), nothing settles, and the
    buyer's tokens equal pure recompute, as on the reference."""
    reqs_a = _requests(llama[2].vocab, 2, seed=0)
    reqs_b = _requests(llama[2].vocab, 1, seed=1)
    out = []
    for pkg in (PORT, REF):
        mp = pkg.market.Marketplace(verify_rate=1.0, seed=0)
        seller = _engine(pkg, llama, monkeypatch, market=mp.join("s"), planner=_planner(pkg))
        _run(pkg, seller, reqs_b)
        (eid_b, e), = seller.store.entries.items()
        wrong = seller.store.backends[e.tier].peek(eid_b)
        eid_a, _ = seller.store.put(list(reqs_a[0]["context_tokens"]), wrong, tier=e.tier,
                                    saved_per_use=e.saved_per_use)
        assert eid_a is not None
        buyer = _engine(pkg, llama, monkeypatch, market=mp.join("b"), planner=_planner(pkg))
        toks = _run(pkg, buyer, reqs_a[1:])
        verified = [e for e in buyer.last_events if isinstance(e, pkg.ev.SellerVerified)]
        assert [(e.ok, e.deep, e.entry_id) for e in verified] == [(False, True, eid_a)]
        assert mp.settlement.n_purchases == 0 and buyer.market_failed == 1
        assert any(isinstance(e, pkg.ev.DegradedToRecompute)
                   and e.reason == "market:verify_failed" for e in buyer.last_events)
        out.append((mp, buyer, toks))
    (mp, buyer, toks), (jmp, jbuyer, _) = out
    _hold_engines(buyer, jbuyer, "buyer")
    _hold_markets(mp, jmp)
    assert toks == _run(PORT, _engine(PORT, llama), reqs_a[1:])


def test_tamper_flips_a_copy_on_the_leaf_device():
    """``_tamper`` flips byte 0 of the first non-empty array leaf (``pos``
    of a state, as the reference's tree order gives it) on a copy: f32 and
    bf16 tensors through a byte view, host arrays likewise; the original is
    unchanged and the checksum moves."""
    k = torch.arange(12, dtype=torch.bfloat16).reshape(1, 3, 4)
    payload = {"b": np.arange(4, dtype=np.float32), "a": (k, None)}
    before = payload_checksum(payload)
    out = _tamper(payload)
    assert payload_checksum(payload) == before != payload_checksum(out)
    assert out["b"] is payload["b"]  # "a" sorts first, as in jax.tree_util
    got = out["a"][0]
    assert got.dtype == torch.bfloat16 and got.device == k.device and got is not k
    assert torch.equal(k, torch.arange(12, dtype=torch.bfloat16).reshape(1, 3, 4))
    raw, want = got.reshape(-1).view(torch.uint8), k.reshape(-1).view(torch.uint8)
    assert int(raw[0]) == int(want[0]) ^ 0xFF and torch.equal(raw[1:], want[1:])
    host = _tamper({"pos": np.asarray([64], np.int32)})["pos"]
    assert host.tolist() == [64 ^ 0xFF]


# --------------------------------------------------------------------------- #
# ROADMAP C11, the market half: a wrapped sliding-window ring is never bought
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mixtral():
    return _setup("mixtral-8x22b")  # reduced: a window (ring) of 16 rows


def _recorded_plans(eng):
    """Every plan the engine's planner returns, by request (on that
    instance only)."""
    plans, plan = {}, eng.planner.plan

    def run(request, lookup, workload):
        plans[request.req_id] = out = plan(request, lookup, workload)
        return out
    eng.planner.plan = run
    return plans


def _wrapped_requests(vocab):
    """Seller ``s`` serves a 48-token context A (three turns of the ring);
    buyer ``b`` asks for A whole (request 1) and for B, which shares A's
    first 32 tokens (request 2)."""
    rng = np.random.default_rng(5)
    a = tuple(map(int, rng.integers(0, vocab, 48)))
    b = a[:32] + tuple(map(int, rng.integers(0, vocab, 16)))
    return [dict(req_id=i, context_tokens=ctx,
                 prompt_tokens=tuple(map(int, rng.integers(0, vocab, 8))),
                 max_new_tokens=3, arrival_s=0.01 * i)
            for i, ctx in enumerate((a, a, b))]


@pytest.mark.parametrize("buy", [1, 2], ids=["whole", "partial"])
def test_c11_wrapped_ring_is_never_bought(mixtral, buy):
    """The seller's stored A is a wrapped ring: its rows ``[:n]`` hold the
    last positions, not positions ``0..n-1``.  The reference's
    ``MarketPlanner`` takes the quote (whole: ``load`` of 48 tokens; partial:
    ``partial`` of 32), though a whole buy fails the spot check (rows
    ``[:16]`` against a fresh 16-token prefill) and blacklists an honest
    seller, and a partial one inserts rows of the wrong positions; only
    that plan is pinned (the reference's bitwise check fails even honest
    sales, C5).  The port's buyer declines every quote of a stored context
    longer than the window: the request keeps its local plan (a recompute),
    nothing is bought or settled, the seller stays in good standing, and
    the tokens are recompute's."""
    reqs = _wrapped_requests(mixtral[2].vocab)
    reqs = [reqs[0], reqs[buy]]
    plans = {}
    for pkg in (PORT, REF):
        mp = pkg.market.Marketplace(verify_rate=1.0, seed=0)
        seller = _engine(pkg, mixtral, market=mp.join("s"), planner=_planner(pkg))
        _run(pkg, seller, reqs[:1])
        buyer = _engine(pkg, mixtral, market=mp.join("b"), planner=_planner(pkg))
        plans[pkg.port] = _recorded_plans(buyer)
        toks = _run(pkg, buyer, reqs[1:])
        if pkg.port:
            quote = mp.quote("b", reqs[1]["context_tokens"])
            assert quote is not None and quote.seller == "s"
            assert mp.tenants["s"].stored_length(quote.entry_id) == 48
            assert not buyer.planner._ring_unwrapped(quote)
            assert (buyer.market_purchases, buyer.market_failed) == (0, 0)
            assert not mp.reputation.is_blacklisted("s") and mp.purchases == 0
            assert toks == _run(PORT, _engine(PORT, mixtral, reuse_enabled=False), reqs[1:])
    want = ("load", 48) if buy == 1 else ("partial", 32)
    jplan, plan = plans[False][buy], plans[True][buy]
    assert jplan.market is not None and (jplan.action, jplan.matched_tokens) == want
    assert plan.market is None and plan.action == "recompute"


def test_c11_ring_within_the_window_is_bought_and_passes(mixtral, monkeypatch):
    """A 16-token context fills the ring without wrapping: its stored rows
    are positions 0-15, so the buyer buys it whole, the spot check passes
    and the serve replays the reference's (substituted check) at 1e-9, with
    recompute's tokens."""
    reqs = _requests(mixtral[2].vocab, 3, ctx_len=16)
    (mp, seller, buyer, toks), _ = _both_trades(mixtral, monkeypatch, reqs)
    (entry,) = seller.store.entries.values()
    assert mp.tenants["s"].stored_length(entry.entry_id) == 16
    assert (buyer.market_purchases, buyer.market_failed) == (1, 0)
    verified = [e for e in buyer.last_events if isinstance(e, pev.SellerVerified)]
    assert [(e.ok, e.deep) for e in verified] == [(True, True)]
    assert not mp.reputation.is_blacklisted("s")
    assert toks == _run(PORT, _engine(PORT, mixtral, reuse_enabled=False), reqs[1:])


def _market_clusters(model, monkeypatch, reqs):
    """A two-replica round-robin cluster with a marketplace and no shared
    tier on both packages: replica 1 buys what replica 0 wrote back."""
    jcfg, jparams, cfg, params = model
    out = []
    for pkg in (PORT, REF):
        mp = pkg.market.Marketplace(verify_rate=1.0, seed=0)
        ec = pkg.serving.EngineConfig(max_slots=2, max_len=128, chunk_tokens=16)
        cc = pkg.serving.ClusterConfig(n_replicas=2, shared_tier=None, tenants=["a", "b"])
        kw = dict(cluster_cfg=cc, engine_cfg=ec, router=pkg.serving.RoundRobinRouter(),
                  planner_factory=lambda pkg=pkg: _planner(pkg), market=mp)
        if pkg.port:
            perf, pricing = _reference_perf_and_pricing()
            cl = pserving.ServingCluster(cfg, params, perf=perf, pricing=pricing,
                                         device="cpu", **kw)
        else:
            cl = jserving.ServingCluster(jcfg, jparams, **kw)
            for eng in cl.replicas:
                _tolerant(monkeypatch, eng)
        for r in reqs:
            cl.submit(pkg.serving.Request(**r))
        out.append((cl, cl.run(), mp))
    return out


def test_two_replica_market_cluster_replays_reference(llama, monkeypatch):
    reqs = [dict(r, arrival_s=float(r["req_id"])) for r in _requests(llama[2].vocab, 4)]
    (cl, s, mp), (jcl, js, jmp) = _market_clusters(llama, monkeypatch, reqs)
    assert [cl.replicas[i].market is not None for i in range(2)] == [True, True]
    assert sorted(mp.tenants) == ["a", "b"]
    assert cl.replicas[1].market_purchases == 1 and mp.settlement.accounts["b"] < 0
    recs = sorted(cl.records, key=lambda r: r.req_id)
    jrecs = sorted(jcl.records, key=lambda r: r.req_id)
    assert [r.tokens for r in recs] == [r.tokens for r in jrecs]
    _same(_strip(recs), _strip(jrecs), "records")
    _same(_strip(cl.events), _strip(jcl.events), "events")
    _close(cl.stats(), jcl.stats(), "stats")
    _same(s.as_dict(), js.as_dict(), "summary")
    _hold_markets(mp, jmp)


def test_market_trace_and_telemetry_match_reference(llama, monkeypatch, tmp_path):
    """A market serve (an honest purchase, then an adversary's) with
    telemetry on and a trace written, on both packages: the traces equal
    line by line, each package's ``read_events`` reads the other's the way
    the other does, the registry's market series match series by series,
    and both ledgers conserve at 1e-9 with the zero-dollar ``kv_purchase``
    markers."""
    reqs = _requests(llama[2].vocab, 3)
    out = []
    for pkg in (PORT, REF):
        tel = pkg.obs.Telemetry()
        mp = pkg.market.Marketplace(verify_rate=1.0, seed=0)
        path = tmp_path / ("port.jsonl" if pkg.port else "ref.jsonl")
        engines = []
        with pkg.trace.TraceWriter(path) as tw:
            for i, (name, rs) in enumerate((("s", reqs[:1]), ("b", reqs[1:2]), ("c", reqs))):
                if name == "c":
                    inj = pkg.faults.FaultInjector(seed=0)
                    inj.arm(corrupt_rate=1.0)
                    mp.arm_adversary("s", inj)
                    mp.arm_adversary("b", inj)
                eng = _engine(pkg, llama, monkeypatch, market=mp.join(name),
                              planner=_planner(pkg), telemetry=tel, replica=i)
                for r in rs:
                    eng.submit(pkg.serving.Request(**r))
                while not eng.idle:
                    tw.write_all(eng.step(), mode=name)
                engines.append(eng)
        for i, eng in enumerate(engines):
            assert max(tel.check(eng.summary(), replica=i).values()) <= 1e-9
            tel.collect_engine(eng, replica=i)
        out.append((tel, path, engines, mp))
    (tel, path, engines, mp), (jtel, jpath, jengines, jmp) = out
    lines = [_strip(json.loads(x)) for x in open(path).read().splitlines()]
    jlines = [_strip(json.loads(x)) for x in open(jpath).read().splitlines()]
    _same(lines, jlines, "trace lines")
    assert any(line.get("event") == "KVPurchased" for line in lines)
    _same(ptrace.read_events(jpath), jtrace.read_events(jpath), "port reads reference")
    _same(jtrace.read_events(path), ptrace.read_events(path), "reference reads port")
    _same(ptrace.read_events(path), ptrace.read_events(jpath), "replays")
    snap, jsnap = tel.registry.snapshot(), jtel.registry.snapshot()
    _same_snapshot(snap, jsnap)
    market = ("kv_purchases_total", "kv_purchased_bytes_total", "seller_verifications_total",
              "sellers_blacklisted_total")
    assert all(snap[name]["series"] for name in market), {m: snap[m] for m in market}
    _same_ledger(tel.ledger, jtel.ledger)
    marks = [e for e in tel.ledger.all_entries() if e.activity == "kv_purchase"]
    assert len(marks) == 1 and marks[0].dollars == 0.0 and marks[0].nbytes > 0
    _hold_markets(mp, jmp)
