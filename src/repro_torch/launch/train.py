"""Training launcher of the port: the reference's ``repro.launch.train`` on
one device, with the full resilience substrate (auto-resume, async
checkpoints in the reference's format, straggler tracking).

The reference's flags, less the mesh (distribution is queue item A11), and
``--device`` (the card unless ``--device cpu``).  Weights are random, drawn
from a seeded generator (``init(cfg, seed=0)`` of the arch's model); the
batches are ``token_batches``' from seed 0, the reference's, and for the
encoder-decoder ``frame_batches``' (the same tokens as decoder tokens, with
random frames).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 128 --reduced --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import CONFIGS, get_config, reduced_config
from repro_torch.data.synthetic import frame_batches, token_batches
from repro_torch.models import registry
from repro_torch.models.common import resolve_device
from repro_torch.training.fault import LoopConfig, ResilientLoop
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_step import make_grad_accum_step, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="training launcher")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(CONFIGS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1, help="grad accumulation")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/launch_train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default="cuda", help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    device = resolve_device(args.device)

    opt = AdamW(lr=args.lr, weight_decay=0.01,
                schedule=cosine_schedule(warmup=10, total=args.steps))
    step = (
        make_train_step(cfg, opt)
        if args.accum == 1
        else make_grad_accum_step(cfg, opt, args.accum)
    )
    params = registry.get_model(cfg).init(cfg, seed=0, device=device)

    batches = frame_batches if cfg.family == "encdec" else token_batches
    it = batches(cfg, batch=args.batch, seq_len=args.seq, seed=0)
    cache = {}

    def batch_fn(i):
        if i not in cache:
            cache[i] = {k: torch.as_tensor(v, device=device) for k, v in next(it).items()}
        return cache[i]

    loop = ResilientLoop(
        step, batch_fn,
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   ckpt_dir=args.ckpt_dir),
        model_cfg=cfg,
    )
    out = loop.run(params, opt.init(params))
    print(f"{cfg.name}: step {out['completed']} "
          f"loss {float(out['metrics']['loss']):.4f} stragglers {out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
