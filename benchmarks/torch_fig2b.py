"""Paper Figure 2(b): cost and delay vs OUTPUT length (1-100 tokens) at 10K
input.  Paper bands: delay saving 1.6-3.5x, cost saving 1.7-4.5x, shrinking
as output grows (prefill saving amortised by decode).  Produced via the
port's discrete-event simulator (``repro_torch.core.simulator``, host code);
``run()`` prints the lines of ``benchmarks/fig2b.py``.

    PYTHONPATH=src python -m benchmarks.torch_fig2b
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import get_config
from repro_torch.core import simulator
from repro_torch.core.perf_model import PerfModel, V100_X4_HF
from repro_torch.core.pricing import AWS_PAPER

OUT_LENGTHS = (1, 5, 10, 25, 50, 100)


def sweep(n_contexts: int = 200, reuses: int = 5, seed: int = 0) -> List[dict]:
    cfg = get_config("llama-7b")
    pm = PerfModel(V100_X4_HF)
    rows = []
    for L_out in OUT_LENGTHS:
        trace = simulator.make_trace(
            n_contexts=n_contexts, reuses_per_context=reuses, L_context=10_000,
            L_prompt=32, L_output=L_out, arrival_rate_per_s=0.02, seed=seed,
        )
        m = simulator.compare_pipelines(cfg, trace, pm, AWS_PAPER)
        rows.append({"L_output": L_out, **m})
    return rows


def run() -> List[str]:
    rows = sweep(n_contexts=40)
    return [
        f"fig2b/Lout={r['L_output']},{r['kv_e2e_s']*1e6:.0f},"
        f"cost_saving={r['cost_saving_x']:.2f}x;delay_saving={r['delay_saving_x']:.2f}x"
        for r in rows
    ]


if __name__ == "__main__":
    for r in sweep():
        print(
            f"L_out={r['L_output']:4d}  text: ${r['text_cost']:.3f} {r['text_e2e_s']:6.2f}s"
            f" | kv: ${r['kv_cost']:.3f} {r['kv_e2e_s']:6.2f}s"
            f" | saving: {r['cost_saving_x']:.2f}x $, {r['delay_saving_x']:.2f}x delay"
        )
