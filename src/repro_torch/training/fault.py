"""Fault-tolerant training loop: checkpoint/restart, preemption survival,
straggler tracking (the reference's ``training/fault.py``).

``ResilientLoop`` wraps a train step with:
  * periodic async checkpoints + auto-resume from the newest complete one;
  * preemption simulation (an injectable failure hook — tests kill the loop
    mid-run and assert bit-exact continuation after restart);
  * straggler tracking: per-step wall time against an EMA of step time;
    steps exceeding ``straggler_factor``x the EMA are counted and surface
    in the result.

A step's wall ends when its loss is on the host: ``torch.cuda.synchronize()``
after a step whose loss lies on the card (the reference's
``jax.block_until_ready``).  With ``model_cfg`` the (params, opt_state)
pair goes to disk in the reference's layout (``models.convert``, and
``adam_to_jax`` / ``adam_from_jax`` here for the optimizer state), so a
checkpoint either package's loop writes resumes in the other's.

Under a mesh (a ``train_step.ShardedTrainStep``) the loop checkpoints
elastically, as the reference's unsharded layout allows: before a save the
ranks gather their ``model`` shards and ZeRO-1 moment slices, global rank 0
writes, and the ranks meet at a barrier before they read; a restore
re-shards the parameters by the step's ``param_specs`` and re-slices the
moments by its ``opt_specs``, whatever mesh wrote them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.models import convert
from repro_torch.models.common import resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamState
from repro_torch.training.train_step import ShardedTrainStep


class Preempted(RuntimeError):
    pass


def adam_to_jax(cfg: ArchConfig, state: AdamState) -> AdamState:
    """An ``AdamState`` with numpy leaves in the reference's layout."""
    return AdamState(step=np.asarray(int(state.step), dtype=np.int32),
                     m=convert.to_jax_params(cfg, state.m), v=convert.to_jax_params(cfg, state.v))


def adam_from_jax(cfg: ArchConfig, state_np: Any, device=None) -> AdamState:
    """The port's ``AdamState`` (f32 moments, an int32 step) from the
    reference's (any named tuple of ``step``, ``m``, ``v`` with array
    leaves)."""
    device = resolve_device(device)
    return AdamState(
        step=torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32, device=device),
        m=convert.from_jax_params(cfg, state_np.m, device, torch.float32),
        v=convert.from_jax_params(cfg, state_np.v, device, torch.float32),
    )

@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    straggler_factor: float = 3.0
    ema_beta: float = 0.9


class ResilientLoop:
    def __init__(
        self,
        step_fn: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
        batch_fn: Callable[[int], Any],  # step -> batch
        cfg: LoopConfig,
        *,
        failure_hook: Optional[Callable[[int], None]] = None,  # may raise Preempted
        model_cfg: Optional[ArchConfig] = None,  # write the reference's layout
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.failure_hook = failure_hook
        self.model_cfg = model_cfg
        self.ckpt = ckpt.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.stragglers = 0
        self._ema_s: Optional[float] = None
        self.sharded = step_fn if isinstance(step_fn, ShardedTrainStep) else None
        self.writes = self.sharded is None or dist.get_rank() == 0

    def _to_disk(self, params: Any, opt_state: Any) -> Any:
        if self.sharded is not None:
            params = self.sharded.gather_params(params)
            opt_state = self.sharded.gather_state(opt_state)
        if self.model_cfg is None:
            return params, opt_state
        return (convert.to_jax_params(self.model_cfg, params),
                adam_to_jax(self.model_cfg, opt_state))

    def _restore(self, params: Any, opt_state: Any):
        (p, o), start = ckpt.restore(self.cfg.ckpt_dir, self._to_disk(params, opt_state))
        if self.model_cfg is not None:
            table = params["embed"]["table"]
            p = convert.from_jax_params(self.model_cfg, p, device=table.device,
                                        dtype=table.dtype)
            o = adam_from_jax(self.model_cfg, o, device=table.device)
        if self.sharded is not None:
            p = self.sharded.shard_params(p)
            o = self.sharded.shard_state(o)
        return p, o, start

    def _barrier(self) -> None:
        if self.sharded is not None:
            dist.barrier()

    def run(self, params: Any, opt_state: Any) -> Dict[str, Any]:
        """Run (or resume) to total_steps.  On entry, restores the newest
        complete checkpoint if one exists — making restart-after-preemption
        a plain re-invocation."""
        start = 0
        self._barrier()  # every earlier write is published
        if ckpt.latest_step(self.cfg.ckpt_dir) is not None:
            params, opt_state, start = self._restore(params, opt_state)
        metrics = {}
        for step in range(start, self.cfg.total_steps):
            if self.failure_hook is not None:
                self.failure_hook(step)  # may raise Preempted mid-training

            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            if metrics["loss"].is_cuda:
                torch.cuda.synchronize(metrics["loss"].device)
            dt = time.perf_counter() - t0

            if self._ema_s is not None and dt > self.cfg.straggler_factor * self._ema_s:
                self.stragglers += 1
            self._ema_s = (
                dt
                if self._ema_s is None
                else self.cfg.ema_beta * self._ema_s + (1 - self.cfg.ema_beta) * dt
            )

            done = step + 1
            if done % self.cfg.ckpt_every == 0 or done == self.cfg.total_steps:
                tree = self._to_disk(params, opt_state)
                if self.writes:
                    self.ckpt.save(done, tree)
        self.ckpt.wait()
        self._barrier()
        return {
            "params": params,
            "opt_state": opt_state,
            "metrics": {k: convert.to_numpy(v) for k, v in metrics.items()},
            "stragglers": self.stragglers,
            "completed": self.cfg.total_steps,
        }
