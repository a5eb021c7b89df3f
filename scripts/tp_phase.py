"""``chip_smoke.py`` phase 23 (tensor parallelism) alone on one card, then
its two kernel-phase entries (the flash forward with ``lse`` and its
backward on rank 0 of the model axis of 2).  Run from the repository root:

    python3 scripts/tp_phase.py
"""
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as s  # noqa: E402


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    s.log(smi)
    t0 = time.perf_counter()
    s.build.build_all()
    s.log(f"torch {torch.__version__} built in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    total, fwd, bwd = s.tensor_parallel_phase()
    at = "phase 23 rank"
    entries = [s.check_flash(fwd, total["flash_attention"], at),
               s.check_flash_bwd(bwd, total["flash_attention_bwd"], at)]
    s.log_device_times()
    print(json.dumps({"kernels": entries}))


if __name__ == "__main__":
    main()
