"""The port stands alone: no JAX, no ``repro``, no library attention.

``repro_torch`` and ``chip_smoke.py`` must run on a machine without JAX and
without the reference package, so they import neither, not even a module
of ``repro`` that is pure Python.  A subprocess with both blocked imports
every module of the port (the int8 tier, the synthetic workload and the
serving launcher among them), serves two requests on the CPU from the int8
tier, and runs the launcher with ``--compress``; another serves the reduced
mamba2-1.3b and runs the launcher with ``--arch mamba2-1.3b``; a third runs
the simulator and its benchmark files, serves under fault injection, hedged
and overlapped loads, lookahead prefetch and migrations, and runs the
launcher with ``--overlap --hedge``; a fourth serves a two-replica
cluster behind the affinity router over one shared, deduplicating s3 tier;
a fifth serves an engine and a cluster with telemetry and a JSONL trace on,
and reads the trace back; a sixth serves a marketplace purchase between two
engines.
"""
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cuh"))


def test_no_jax_or_reference_imports():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = ([p for p in _port_sources() if p.suffix == ".py"] + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "benchmarks").glob("torch_*.py")))
    assert any(p.name == "simulator.py" for p in files)
    names = {str(p.relative_to(PORT)) for p in files if PORT in p.parents}
    assert {"obs/__init__.py", "obs/registry.py", "obs/ledger.py", "obs/spans.py",
            "obs/telemetry.py", "obs/console.py", "serving/trace.py",
            "serving/audit.py", "market/__init__.py", "market/catalog.py",
            "market/market.py", "market/planner.py", "market/reputation.py",
            "market/settlement.py", "models/moe.py"} <= names, names
    hits = [f"{p}: {m.group(0).strip()}" for p in files for m in pattern.finditer(p.read_text())]
    assert not hits, hits


def test_no_library_attention_in_port():
    """The port's attention is its own kernels: no SDPA, cuDNN, compile or
    packages of finished kernels."""
    pattern = re.compile(r"scaled_dot_product_attention|torch\.compile|cudnn|flash_attn|xformers")
    hits = [str(p) for p in _port_sources() if pattern.search(p.read_text())]
    assert not hits, hits


def test_port_serves_mamba2_with_jax_and_repro_blocked():
    """The SSM family too: reduced mamba2-1.3b served on the CPU through the
    per-request path (a write-back and a load of its state), and the
    launcher's ``--arch mamba2-1.3b``, with JAX and the reference blocked."""
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.models import lm
        from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine
        cfg = reduced_config(get_config("mamba2-1.3b"))
        params = lm.init(cfg, seed=0, device="cpu")
        eng = ServingEngine(cfg, params, device="cpu", planner=AlwaysReusePlanner(),
                            engine_cfg=EngineConfig(max_slots=2, max_len=128))
        ctx = list(range(48))  # whole 16-token chunks: SSM state is all or nothing
        for i in range(2):
            eng.submit(Request(req_id=i, context_tokens=ctx, prompt_tokens=[7, 8, 9],
                               max_new_tokens=3, arrival_s=i * 0.01, expected_reuses=2))
        s = eng.run()
        assert s.n_requests == 2 and s.reuse_hits == 1 and eng.batches == 0, s
        from repro_torch.launch import serve
        serve.main(["--arch", "mamba2-1.3b", "--requests", "4", "--contexts", "2",
                    "--device", "cpu"])
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 requests" in out.stdout and "mamba2-1.3b-smoke" in out.stdout


def test_port_imports_and_serves_with_jax_and_repro_blocked():
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("repro_torch.kvcache.compression", "repro_torch.kernels.kv_quant",
                     "repro_torch.data.synthetic", "repro_torch.launch.serve",
                     "repro_torch.obs", "repro_torch.obs.telemetry",
                     "repro_torch.obs.console", "repro_torch.serving.trace",
                     "repro_torch.serving.audit", "repro_torch.market",
                     "repro_torch.market.market", "repro_torch.models.moe"):
            assert name in names, name
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.models import lm
        from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine
        cfg = reduced_config(get_config("llama-7b"))
        params = lm.init(cfg, seed=0, device="cpu")
        eng = ServingEngine(cfg, params, device="cpu", planner=AlwaysReusePlanner(),
                            engine_cfg=EngineConfig(max_slots=2, max_len=128,
                                                    compress_tier="io2"))
        ctx = list(range(40))
        for i in range(2):
            eng.submit(Request(req_id=i, context_tokens=ctx, prompt_tokens=[7, 8, 9],
                               max_new_tokens=3, arrival_s=i * 0.01, expected_reuses=2))
        s = eng.run()
        assert s.n_requests == 2 and s.reuse_hits == 1, s
        assert all(e.compressed for e in eng.store.entries.values())
        from repro_torch.launch import serve
        serve.main(["--requests", "4", "--contexts", "2", "--compress", "--device", "cpu"])
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("served", len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("served")
    assert "served 4 requests" in out.stdout


def test_port_runs_simulator_faults_and_latency_options_with_jax_and_repro_blocked():
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        from benchmarks import torch_ablation, torch_fig2a, torch_fig2b
        from repro_torch.core import simulator
        assert torch_fig2a.run() and torch_fig2b.run()
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.kvcache.faults import FaultInjector, RetryPolicy
        from repro_torch.kvcache.hierarchy import TierSpec
        from repro_torch.models import lm
        from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine
        from repro_torch.serving.scheduler import HedgePolicy
        cfg = reduced_config(get_config("llama-7b"))
        params = lm.init(cfg, seed=0, device="cpu")
        eng = ServingEngine(cfg, params, device="cpu", planner=AlwaysReusePlanner(),
                            engine_cfg=EngineConfig(
                                max_slots=1, max_len=128, overlap_load=True,
                                hedge=HedgePolicy(), prefetch_lookahead=2,
                                faults=FaultInjector(seed=7, fail_rate=0.4),
                                retry_policy=RetryPolicy(max_attempts=2, cost_aware=False),
                                tier_specs=[TierSpec("host_dram", 1.0), TierSpec("s3", 1.0)],
                                store_tier="host_dram", migration_interval_s=0.01))
        for i in range(4):
            eng.submit(Request(req_id=i, context_tokens=list(range(40)),
                               prompt_tokens=[7, 8, 9], max_new_tokens=2,
                               arrival_s=i * 0.02, expected_reuses=4))
        s = eng.run()
        assert s.n_requests == 4 and "injector" in eng.fault_stats(), s
        from repro_torch.launch import serve
        serve.main(["--requests", "4", "--contexts", "2", "--overlap", "--hedge",
                    "--device", "cpu"])
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 requests" in out.stdout


def test_port_serves_a_cluster_with_jax_and_repro_blocked():
    """Two replicas of the reduced llama-7b behind the affinity router over
    one shared s3 tier, on the CPU, with JAX and the reference blocked: every
    request routed once, reuse hits, and a second replica's write-back of a
    context the first stored deduplicated in the shared core."""
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.kvcache.hierarchy import TierSpec
        from repro_torch.models import lm
        from repro_torch.serving import (AffinityRouter, AlwaysReusePlanner, BloomDigest,
                                         ClusterConfig, EngineConfig, Request,
                                         RoundRobinRouter, ServingCluster)
        from repro_torch.serving import events as ev
        cfg = reduced_config(get_config("llama-7b"))
        params = lm.init(cfg, seed=0, device="cpu")
        ec = EngineConfig(max_slots=2, max_len=128,
                          tier_specs=[TierSpec("host_dram", 1.0), TierSpec("s3", 1.0)])
        for router in (AffinityRouter(), RoundRobinRouter()):
            cl = ServingCluster(cfg, params, device="cpu", engine_cfg=ec, router=router,
                                cluster_cfg=ClusterConfig(n_replicas=2, gossip_interval_s=0.01),
                                planner_factory=AlwaysReusePlanner)
            for i in range(9):
                ctx = list(range(100 * (i % 3), 100 * (i % 3) + 40))
                cl.submit(Request(req_id=i, context_tokens=ctx, prompt_tokens=[7, 8, 9],
                                  max_new_tokens=2, arrival_s=i * 0.02, expected_reuses=3))
            s = cl.run()
            routed = [e for _, e in cl.events if isinstance(e, ev.RequestRouted)]
            assert s.n_requests == 9 and len(routed) == 9 and s.reuse_hits > 0, s.as_dict()
            print(type(router).__name__, s.reuse_hits, cl.core.stats()["dedup_hits"])
        assert cl.core.stats()["dedup_hits"] > 0, cl.core.stats()
        assert isinstance(cl._digests[0], BloomDigest)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RoundRobinRouter" in out.stdout


def test_port_serves_with_telemetry_and_a_trace_with_jax_and_repro_blocked(tmp_path):
    """An engine and a two-replica cluster of the reduced llama-7b served on
    the CPU with ``obs.Telemetry`` and a ``TraceWriter``, with JAX and the
    reference blocked: the ledger conserves, and the trace read back gives
    the live summary, audit and span trees."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.kvcache.hierarchy import TierSpec
        from repro_torch.models import lm
        from repro_torch.obs import Telemetry, build_cluster_spans, build_spans
        from repro_torch.obs.console import render
        from repro_torch.serving import (AlwaysReusePlanner, ClusterConfig, EngineConfig,
                                         Request, ServingCluster, ServingEngine, TraceWriter,
                                         read_events, read_tagged_events)
        from repro_torch.serving.audit import audit, cluster_audit, cluster_audit_from_trace
        from repro_torch.serving.metrics import summarize_events
        cfg = reduced_config(get_config("llama-7b"))
        params = lm.init(cfg, seed=0, device="cpu")
        ec = EngineConfig(max_slots=2, max_len=128,
                          tier_specs=[TierSpec("host_dram", 1.0), TierSpec("s3", 1.0)])
        reqs = [Request(req_id=i, context_tokens=list(range(100 * (i % 2), 100 * (i % 2) + 40)),
                        prompt_tokens=[7, 8, 9], max_new_tokens=2, arrival_s=i * 0.02,
                        expected_reuses=3) for i in range(6)]
        tel = Telemetry()
        eng = ServingEngine(cfg, params, device="cpu", planner=AlwaysReusePlanner(),
                            engine_cfg=ec, telemetry=tel)
        for r in reqs:
            eng.submit(r)
        live = []
        with TraceWriter({str(tmp_path / "e.jsonl")!r}) as tw:
            for e in eng.drain():
                live.append(e)
                tw.write(e)
        s = eng.summary()
        assert max(tel.check(s).values()) <= 1e-9 and s.reuse_hits > 0, s
        got = read_events({str(tmp_path / "e.jsonl")!r})
        assert got == live
        assert summarize_events(got, storage_cost=s.storage_cost,
                                transfer_cost=s.transfer_cost) == s
        assert audit(got) == audit(live) and build_spans(got) == build_spans(live)
        tel.collect_engine(eng)
        assert "conservation vs summary: OK" in render(tel, s)
        ctel = Telemetry()
        tw = TraceWriter({str(tmp_path / "c.jsonl")!r})
        cl = ServingCluster(cfg, params, device="cpu", engine_cfg=ec, telemetry=ctel,
                            trace=tw, cluster_cfg=ClusterConfig(n_replicas=2,
                                                               gossip_interval_s=0.01),
                            planner_factory=AlwaysReusePlanner)
        for r in reqs:
            cl.submit(r)
        cs = cl.run()
        tw.close()
        for per_cat in ctel.check_cluster(cs).values():
            assert max(per_cat.values()) <= 1e-9
        tagged = read_tagged_events({str(tmp_path / "c.jsonl")!r})
        assert tagged == cl.events == ctel.events
        assert build_cluster_spans(tagged) == ctel.spans()
        assert cluster_audit_from_trace({str(tmp_path / "c.jsonl")!r}) == \
            cluster_audit(cl.events_by_replica)
        ctel.collect_cluster(cl)
        print("telemetry", len(live), len(tagged))
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("telemetry")


def test_port_serves_a_market_purchase_with_jax_and_repro_blocked():
    """Two tenants of one ``Marketplace`` on the CPU, with JAX and the
    reference blocked: the buyer buys the seller's stored context, its
    spot check passes, the settlement conserves, and its tokens equal a
    recompute's."""
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.market import Marketplace, MarketPlanner
        from repro_torch.models import lm
        from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine
        from repro_torch.serving import events as ev
        cfg = reduced_config(get_config("llama-7b"))
        params = lm.init(cfg, seed=0, device="cpu")
        mp = Marketplace(verify_rate=1.0, seed=0)
        def engine(tenant=None):
            return ServingEngine(cfg, params, device="cpu",
                                 engine_cfg=EngineConfig(max_slots=2, max_len=128),
                                 planner=MarketPlanner(AlwaysReusePlanner()),
                                 market=mp.join(tenant) if tenant else None)
        def req(i):
            return Request(req_id=i, context_tokens=list(range(64)), prompt_tokens=[7, 8, i],
                           max_new_tokens=3, arrival_s=i * 0.01)
        seller, buyer, plain = engine("s"), engine("b"), engine()
        seller.submit(req(0))
        seller.run()
        buyer.submit(req(1))
        events = list(buyer.drain())
        plain.submit(req(1))
        plain.run()
        assert buyer.market_purchases == 1, [type(e).__name__ for e in events]
        assert [(e.ok, e.deep) for e in events if isinstance(e, ev.SellerVerified)] == \\
            [(True, True)]
        assert mp.settlement.assert_conserved(1e-9) <= 1e-9
        assert buyer.records[0].tokens == plain.records[0].tokens
        print("market", buyer.market_spend)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("market")
