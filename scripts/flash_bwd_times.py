"""Time this checkout's ``flash_attention_bwd`` and keep its outputs.

At ``chip_smoke.py``'s backward shapes (bf16: qwen2-0.5b's training shape
B 4 x S 2,048 with 14 heads on 2 at hd 64, llama's 32 on 32 at hd 128,
mixtral's 48 on 8 at hd 128 with a window of 1,024; f32: 1 x 512, 14 on 2,
hd 64; causal, seeded inputs, ``lse`` from the forward kernel) prints the
wall time per launch (CUDA events) and then the device time per launch of
each kernel it ran (``torch.profiler``).  With ``--save DIR`` it writes
each shape's ``(dq, dk, dv)``; ``--compare A B`` says whether two such
directories hold the same bits.  Run it from the root of a checkout:

    python3 scripts/flash_bwd_times.py [--reps 20] [--save DIR]
    python3 scripts/flash_bwd_times.py --compare DIR_A DIR_B

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
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import flash_backward as fbk  # noqa: E402
from repro_torch.kernels import flash_prefill as fk  # noqa: E402

# label: B, S, H, KV, hd, window, dtype
SHAPES = {
    "qwen2-0.5b training": (4, 2048, 14, 2, 64, None, torch.bfloat16),
    "llama heads": (1, 2048, 32, 32, 128, None, torch.bfloat16),
    "mixtral heads, window 1024": (1, 2048, 48, 8, 128, 1024, torch.bfloat16),
    "f32": (1, 512, 14, 2, 64, None, torch.float32),
}


def inputs(B, S, H, KV, hd, window, dtype, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, dout = (torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dtype) for _ in range(2))
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None].expand(B, S).contiguous()
    kw = dict(q_pos=pos, kv_pos=pos, causal=True, window=window)
    lse = torch.empty(B, S, H, dtype=torch.float32, device="cuda")
    out = fk.flash_attention(q, k, v, lse=lse, **kw)
    return (q, k, v, out, dout, lse), kw


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
    """Device ms per call of each kernel of the backward's library, by name."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and "flash_bwd" in e.key:
            m = re.search(r"(\w+)<", e.key)
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out


def compare(a: pathlib.Path, b: pathlib.Path) -> None:
    for label in SHAPES:
        name = label.replace(" ", "_").replace(",", "") + ".pt"
        same = [torch.equal(x, y) for x, y in zip(torch.load(a / name), torch.load(b / name))]
        print(f"{label}: dq, dk, dv equal bit for bit: {same}")


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
        sys.exit("flash_bwd_times: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for label, shape in SHAPES.items():
        (q, k, v, out, dout, lse), kw = inputs(*shape)

        def fn(q=q, k=k, v=v, out=out, dout=dout, lse=lse, kw=kw):
            return fbk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)

        if args.save:
            args.save.mkdir(parents=True, exist_ok=True)
            name = label.replace(" ", "_").replace(",", "") + ".pt"
            torch.save([t.cpu() for t in fn()], args.save / name)
        print(f"{label}: ms per launch {time_ms(fn, args.reps):.4f}", flush=True)
        runs.append((label, fn))
    for label, fn in runs:  # after every wall timing
        d = device_ms(fn, args.reps)
        print(f"{label}: device ms per launch: "
              f"{', '.join(f'{k} {v:.4f}' for k, v in d.items()) or 'not measured'}", flush=True)


if __name__ == "__main__":
    main()
