"""Train a ~100M-parameter qwen2-family model on the port with the full
substrate: AdamW + cosine schedule, async checkpointing in the reference's
format, auto-resume and straggler tracking (ResilientLoop).  The port's
copy of ``examples/train_100m.py``.

The default invocation is CPU-sized (``--device cpu``: a few minutes);
``--full`` selects the real ~100M config, on the card by default:

    PYTHONPATH=src python examples/torch_train_100m.py --device cpu   # smoke size
    PYTHONPATH=src python examples/torch_train_100m.py --full --steps 300
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.synthetic import token_batches
from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.training.fault import LoopConfig, ResilientLoop
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import tree_leaves


def build_cfg(full: bool):
    base = get_config("qwen2-0.5b")
    if full:
        # ~100M params: 12 layers x d_model 640, vocab 32k
        return dataclasses.replace(
            base, name="qwen2-100m", n_layers=12, d_model=640, n_heads=10,
            n_kv_heads=2, d_ff=2560, vocab=32_000, head_dim=64,
            param_dtype="float32", dtype="float32", param_partition="dp",
            remat="none",
        )
    return reduced_config(base, n_layers=4, d_model=128, n_heads=4,
                          n_kv_heads=2, d_ff=512, vocab=2048, head_dim=32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="~100M-param config")
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_100m")
    ap.add_argument("--device", default="cuda", help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = build_cfg(args.full)
    device = resolve_device(args.device)
    params = lm.init(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")

    opt = AdamW(lr=3e-4, weight_decay=0.01,
                schedule=cosine_schedule(warmup=20, total=args.steps))
    step_fn = make_train_step(cfg, opt)

    it = token_batches(cfg, batch=args.batch, seq_len=args.seq, seed=0)
    cache = {}

    def batch_fn(i):
        if i not in cache:
            cache[i] = {k: torch.as_tensor(v, device=device) for k, v in next(it).items()}
        return cache[i]

    loop = ResilientLoop(
        step_fn, batch_fn,
        LoopConfig(total_steps=args.steps, ckpt_every=20, ckpt_dir=args.ckpt_dir),
        model_cfg=cfg,
    )
    out = loop.run(params, opt.init(params))
    print(f"finished at step {out['completed']}: "
          f"loss {float(out['metrics']['loss']):.3f}, "
          f"stragglers {out['stragglers']}, checkpoints in {args.ckpt_dir}")
    print("(re-running this command resumes from the newest checkpoint)")
    return out


if __name__ == "__main__":
    main()
