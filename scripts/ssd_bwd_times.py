"""Time this checkout's ``ssd_chunked_bwd`` and keep its outputs.

At the SSD backward launches of ``chip_smoke.py``'s phase 20 (bf16:
mamba2-1.3b's training launch B 2 x 2,048 with H 64, P 64, S 128, G 1, and
jamba-1.5-large-398b's one-layer step B 1 x 2,048 with H 128, P 128, S 16,
G 1; f32: mamba2's launch cast to f32, and B 2 x 300 over H 4, P 64, S 128,
G 2 with an initial state and a final-state gradient) on seeded inputs at
the model's scales (``tests/test_torch_kernels_gpu.py``'s helper) prints
the wall time per launch (CUDA events) and then the device time per launch
of each kernel it ran (``torch.profiler``), the memory a launch allocates
(outputs and scratch) and the compiler's registers and spills.  With
``--save DIR`` it writes each shape's ``(dx, ddt, dA, dB, dC, dh0)``;
``--compare A B`` says whether two such directories hold the same bits.
Run it from the root of a checkout:

    python3 scripts/ssd_bwd_times.py [--reps 20] [--save DIR]
    python3 scripts/ssd_bwd_times.py --compare DIR_A DIR_B

To compare two trees on one card, copy the script into the other tree's
``scripts/`` and run both in one call, in turns.
"""
from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_backward as sbk  # noqa: E402

# label: B, L, H, P, G, S, with an initial state and dhT, dtype
SHAPES = {
    "mamba2-1.3b training": (2, 2048, 64, 64, 1, 128, False, torch.bfloat16),
    "jamba training": (1, 2048, 128, 128, 1, 16, False, torch.bfloat16),
    "mamba2-1.3b training f32": (2, 2048, 64, 64, 1, 128, False, torch.float32),
    "groups, states f32": (2, 300, 4, 64, 2, 128, True, torch.float32),
}


def file_name(label: str) -> str:
    return label.replace(" ", "_").replace(",", "") + ".pt"


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device ms per call of each kernel of the SSD libraries, by name."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and ("ssd_bwd::" in e.key or "ssd::" in e.key):
            m = re.search(r"(\w+(?:<[^>]*>)?)\(", e.key)
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out


def ptxas() -> str:
    notes = []
    for e in build.ptxas_report("ssd_backward"):
        notes.append(f"{e['function']}: {e.get('registers')} regs, spill "
                     f"{e.get('spill_stores')}/{e.get('spill_loads')} B")
    return "; ".join(notes) or "no build log"


def compare(a: pathlib.Path, b: pathlib.Path) -> None:
    for label in SHAPES:
        got = [torch.load(d / file_name(label)) for d in (a, b)]
        same = [(x is None and y is None) or (x is not None and y is not None and torch.equal(x, y))
                for x, y in zip(*got)]
        print(f"{label}: dx, ddt, dA, dB, dC, dh0 equal bit for bit: {same}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save", type=pathlib.Path)
    ap.add_argument("--compare", type=pathlib.Path, nargs=2)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_times: no CUDA device")
    from test_torch_kernels_gpu import _ssd_bwd_case

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build_all(["ssd_scan", "ssd_backward"])
    cuda = torch.device("cuda")
    runs = []
    for label, (B, L, H, P, G, S, states, dtype) in SHAPES.items():
        ins, h0 = _ssd_bwd_case(cuda, dtype, B, L, H, P, G, S, states, seed=L + P)

        def fn(ins=ins, h0=h0):
            return sbk.ssd_chunked_bwd(*ins, initial_state=h0)

        if args.save:
            args.save.mkdir(parents=True, exist_ok=True)
            torch.save([None if t is None else t.cpu() for t in fn()],
                       args.save / file_name(label))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"{label}: ms per launch {time_ms(fn, args.reps):.4f}; peak memory of a launch "
              f"{peak / 2**30:.3f} GiB (outputs and scratch)", flush=True)
        runs.append((label, fn))
    for label, fn in runs:  # after every wall timing
        d = device_ms(fn, args.reps)
        print(f"{label}: device ms per launch: "
              f"{', '.join(f'{k} {v:.4f}' for k, v in d.items()) or 'not measured'}; "
              f"sum {sum(d.values()):.4f}", flush=True)
    print(f"ssd_backward ptxas: {ptxas()}", flush=True)


if __name__ == "__main__":
    main()
