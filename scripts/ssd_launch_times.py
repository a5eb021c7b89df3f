"""Time this checkout's ``ssd_chunked`` at the mamba2-1.3b serve's shapes.

For the bf16 2,000-token launch from a zero state and the 32-token launch
after a stored state (B 1, H 64, P 64, S 128, G 1, chunk 256; inputs from
``tests/test_torch_kernels_gpu.py``'s seeded helper) prints the wall time
per launch, the host enqueue per launch and then the device time per launch
of every kernel the launch ran, profiled after all wall and host timings,
with ``chip_smoke.py``'s timing helpers; and the compiler's registers and
spills of the library's kernels.  Run it from the root of a checkout:

    python3 scripts/ssd_launch_times.py [--reps 20]

To compare two trees on one card, copy the script into the other tree's
``scripts/`` and run both in one call.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (exits without a card)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from test_torch_kernels_gpu import _ssd_inputs  # noqa: E402

KERNELS = {k: k for k in ("chunk_state_kernel", "state_pass_kernel", "chunk_output_kernel",
                          "ssd_kernel")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    build.build_all(["ssd_scan"])
    print(f"{smi}; {ssk.__file__}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    calls = {}
    for label, L, with_h0, seed in (("long", 2000, False, 1), ("short", 32, True, 2)):
        x, dt, A, Bm, Cm, h0 = _ssd_inputs("cuda", torch.bfloat16, 1, L, 64, 64, 1, 128,
                                           with_h0, seed)
        calls[label] = (lambda x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, h0=h0:
                        ssk.ssd_chunked(x, dt, A, Bm, Cm, chunk=256, initial_state=h0))
    for label, fn in calls.items():
        wall = smoke.time_ms(fn, args.reps)
        host = smoke.host_ms(fn, args.reps)
        print(f"ssd_chunked {label} bf16: wall ms per launch {wall:.4f}; host enqueue ms "
              f"{host:.4f}", flush=True)
    for label, fn in calls.items():
        parts = smoke.device_ms(fn, KERNELS, args.reps)
        print(f"ssd_chunked {label} bf16: device ms per launch "
              f"{', '.join(f'{k} {v:.4f}' for k, v in parts.items()) or 'not measured'}; "
              f"sum {sum(parts.values()):.4f}", flush=True)
    print(f"ssd_scan ptxas: {smoke.ptxas_notes('ssd_scan', '|'.join(KERNELS))}", flush=True)


if __name__ == "__main__":
    main()
