"""The port stands alone: no JAX, no ``repro``, no library attention.

``repro_torch`` and ``chip_smoke.py`` must run on a machine without JAX and
without the reference package, so they import neither, not even a module
of ``repro`` that is pure Python.  A subprocess with both blocked imports
every module of the port and serves two requests on the CPU.
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
    files = [p for p in _port_sources() if p.suffix == ".py"] + [ROOT / "chip_smoke.py"]
    hits = [f"{p}: {m.group(0).strip()}" for p in files for m in pattern.finditer(p.read_text())]
    assert not hits, hits


def test_no_library_attention_in_port():
    """The port's attention is its own kernels: no SDPA, cuDNN, compile or
    packages of finished kernels."""
    pattern = re.compile(r"scaled_dot_product_attention|torch\.compile|cudnn|flash_attn|xformers")
    hits = [str(p) for p in _port_sources() if pattern.search(p.read_text())]
    assert not hits, hits


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
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.models import lm
        from repro_torch.serving import AlwaysReusePlanner, EngineConfig, Request, ServingEngine
        cfg = reduced_config(get_config("llama-7b"))
        params = lm.init(cfg, seed=0, device="cpu")
        eng = ServingEngine(cfg, params, device="cpu", planner=AlwaysReusePlanner(),
                            engine_cfg=EngineConfig(max_slots=2, max_len=128))
        ctx = list(range(40))
        for i in range(2):
            eng.submit(Request(req_id=i, context_tokens=ctx, prompt_tokens=[7, 8, 9],
                               max_new_tokens=3, arrival_s=i * 0.01, expected_reuses=2))
        s = eng.run()
        assert s.n_requests == 2 and s.reuse_hits == 1, s
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
