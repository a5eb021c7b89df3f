"""AdamW (hand-rolled, dependency-free) and the cosine schedule.

The reference's ``training/optimizer.py``: moments are f32 whatever the
parameter dtype, gradients are clipped by their global norm, the update is
bias-corrected with decoupled weight decay, and each parameter is updated
in f32 and cast back to its dtype.  The update is functional, as the
reference's: it returns new tensors and leaves its inputs as they were.
The step counter and the schedule stay on the parameters' device, so a
step needs no host sync.  ZeRO sharding of the moments (``opt_specs``)
waits for distribution (queue item A11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import Params
from repro_torch.training.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Params
    v: Params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    # optional learning-rate schedule: step -> multiplier
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def init(self, params: Params) -> AdamState:
        def zeros32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        device = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                         m=tree_map(zeros32, params), v=tree_map(zeros32, params))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState,
               params: Params) -> Tuple[Params, AdamState]:
        step = state.step + 1
        g32 = tree_map(lambda g: g.float(), grads)
        if self.grad_clip is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in tree_leaves(g32)))
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            g32 = tree_map(lambda g: g * scale, g32)

        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, g32)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g), state.v, g32)
        t = step.float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        lr = self.lr * (self.schedule(step) if self.schedule else 1.0)

        def upd(p, mm, vv):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), AdamState(step=step, m=m, v=v)


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """step -> multiplier: linear warm-up over ``warmup`` steps, then a
    cosine from 1 down to ``floor`` at ``total``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return fn
