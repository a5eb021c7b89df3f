"""A CPU rehearsal of a training run of ``chip_smoke.py``: the same arch at
full width cut to a few layers, the same data (``token_batches`` with ids
from the first ``--data-vocab``), AdamW and cosine schedule, on the CPU in
f32, printing each step's loss and the drop of the 3-step means that the
smoke gates on the card.

    PYTHONPATH=src python scripts/train_loss_rehearsal.py --arch mamba2-1.3b \\
        --layers 2 --batch 4 --seq 512 --steps 20

``--reduced`` takes the arch's reduced config instead of its full width (a
few seconds; ``tests/test_torch_training_ssm.py`` runs it so).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.synthetic import token_batches
from repro_torch.models import lm
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_step import make_train_step


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-vocab", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, n_layers=args.layers, param_dtype="float32",
                              dtype="float32")
    params = lm.init(cfg, seed=0, device="cpu")
    opt = AdamW(lr=args.lr, weight_decay=0.01,
                schedule=cosine_schedule(warmup=args.warmup, total=args.steps))
    state, step = opt.init(params), make_train_step(cfg, opt)
    it = token_batches(dataclasses.replace(cfg, vocab=args.data_vocab), batch=args.batch,
                       seq_len=args.seq, seed=0)
    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, next(it))
        losses.append(float(m["loss"]))
        print(f"step {i}: loss {losses[-1]:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    drop = sum(losses[:3]) / 3 - sum(losses[-3:]) / 3
    print(f"{cfg.name} {args.layers} layers, B {args.batch} x S {args.seq}, {args.steps} steps: "
          f"drop of the 3-step means {drop:.4f}")
    return losses


if __name__ == "__main__":
    main()
