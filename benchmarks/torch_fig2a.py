"""Paper Figure 2(a): cost and end-to-end delay vs INPUT length (1K-10K),
Llama-7B, TriviaQA-like workload (200 contexts x 5 reuses), both pipelines.

Paper's reported bands: delay saving 1.1-2.9x, cost saving 1.3-3.6x, growing
with input length.  Produced via the port's discrete-event simulator
(``repro_torch.core.simulator``, host code: no model runs) with the
paper-calibrated V100/HF-MP performance model; ``run()`` prints the lines of
``benchmarks/fig2a.py``.

    PYTHONPATH=src python -m benchmarks.torch_fig2a
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import get_config
from repro_torch.core import simulator
from repro_torch.core.perf_model import PerfModel, V100_X4_HF
from repro_torch.core.pricing import AWS_PAPER

LENGTHS = (1_000, 2_000, 4_000, 6_000, 8_000, 10_000)


def sweep(n_contexts: int = 200, reuses: int = 5, seed: int = 0) -> List[dict]:
    cfg = get_config("llama-7b")
    pm = PerfModel(V100_X4_HF)
    rows = []
    for L in LENGTHS:
        trace = simulator.make_trace(
            n_contexts=n_contexts, reuses_per_context=reuses, L_context=L,
            L_prompt=32, L_output=32, arrival_rate_per_s=0.02, seed=seed,
        )
        m = simulator.compare_pipelines(cfg, trace, pm, AWS_PAPER)
        rows.append({"L_input": L, **m})
    return rows


def run() -> List[str]:
    rows = sweep(n_contexts=40)  # reduced contexts: same stats, faster CI
    out = []
    for r in rows:
        out.append(
            f"fig2a/L={r['L_input']},{r['kv_e2e_s']*1e6:.0f},"
            f"cost_saving={r['cost_saving_x']:.2f}x;delay_saving={r['delay_saving_x']:.2f}x"
        )
    return out


if __name__ == "__main__":
    for r in sweep():
        print(
            f"L={r['L_input']:6d}  text: ${r['text_cost']:.3f} {r['text_e2e_s']:6.2f}s"
            f" | kv: ${r['kv_cost']:.3f} {r['kv_e2e_s']:6.2f}s"
            f" | saving: {r['cost_saving_x']:.2f}x $, {r['delay_saving_x']:.2f}x delay"
        )
