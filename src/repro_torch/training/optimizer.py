"""AdamW (hand-rolled, dependency-free) and the cosine schedule.

The reference's ``training/optimizer.py``: moments are f32 whatever the
parameter dtype, gradients are clipped by their global norm, the update is
bias-corrected with decoupled weight decay, and each parameter is updated
in f32 and cast back to its dtype.  The update is functional, as the
reference's: it returns new tensors and leaves its inputs as they were.
The step counter and the schedule stay on the parameters' device, so a
step needs no host sync.

``opt_specs`` is the reference's ZeRO-1 rule: each moment takes its
parameter's spec, and where that does not use the ``data`` axis, the
largest unsharded dim that ``data`` divides gets it.  ``Zero1`` applies the
rule on a mesh (each rank keeps its slice of every moment) and
``AdamW.update_zero1`` is the update over it: the global-norm clip reads
the full gradient, each rank updates its slice of ``m``, ``v`` and the
parameter, and the ranks all-gather the parameter, which gives the
unsharded update's bits (every other op is elementwise).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import DATA, P, axis_size, to_placements
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
        m, v = self._moments(state, self._clipped(grads))
        return tree_map(self._param_update(step), params, m, v), AdamState(step=step, m=m, v=v)

    @torch.no_grad()
    def update_zero1(self, grads: Params, state: AdamState, params: Params,
                     zero: "Zero1") -> Tuple[Params, AdamState]:
        """``update`` with ``state``'s moments sliced by ``zero``: ``grads``
        are the full (all-reduced) gradients and ``params`` the full
        parameters on every rank; returns the full new parameters and the
        new sliced state, the bits ``update`` gives."""
        step = state.step + 1
        m, v = self._moments(state, zero.shard(self._clipped(grads)))
        local = tree_map(self._param_update(step), zero.shard(params), m, v)
        return zero.gather(local), AdamState(step=step, m=m, v=v)

    def _clipped(self, grads: Params) -> Params:
        """The gradients in f32, scaled down to a global norm of
        ``grad_clip`` where it is exceeded."""
        g32 = tree_map(lambda g: g.float(), grads)
        if self.grad_clip is None:
            return g32
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in tree_leaves(g32)))
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale, g32)

    def _moments(self, state: AdamState, g32: Params) -> Tuple[Params, Params]:
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, g32)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g), state.v, g32)
        return m, v

    def _param_update(self, step: torch.Tensor) -> Callable:
        """(p, m, v) -> the new p, elementwise, at ``step`` (already
        advanced)."""
        b1, b2 = self.b1, self.b2
        t = step.float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        lr = self.lr * (self.schedule(step) if self.schedule else 1.0)

        def upd(p, mm, vv):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return upd


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


# --------------------------------------------------------------------------- #
# ZeRO sharding of the optimizer state
# --------------------------------------------------------------------------- #
def opt_specs(param_spec_tree: Any, params_shapes: Any, mesh: Any) -> AdamState:
    """Moment specs: each parameter's spec, plus ZeRO-1 sharding over
    ``data`` of any moment whose parameter is not already sharded over it
    (on the largest unsharded dim that ``data`` divides)."""
    d = axis_size(mesh, DATA)

    def one(spec: P, x) -> P:
        parts = list(spec) + [None] * (len(x.shape) - len(spec))
        if DATA in parts or d <= 1:
            return P(*parts)
        best, best_dim = -1, -1
        for i, (entry, dim) in enumerate(zip(parts, x.shape)):
            if entry is None and dim % d == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best >= 0:
            parts[best] = DATA
        return P(*parts)

    m_specs = tree_map(one, param_spec_tree, params_shapes)
    return AdamState(step=P(), m=m_specs, v=m_specs)


class Zero1:
    """The moments' ZeRO-1 layout on a ``DeviceMesh``: ``shard`` takes a
    tree of full tensors (moments, gradients or parameters, in the moment
    specs' tree) to this rank's slices and ``gather`` takes slices back to
    full tensors (an all-gather over ``data``), both through DTensor.  Only
    the ``data`` axis slices: tensor-parallel execution over ``model`` is
    not run (queue item A11d), so every other mesh dim has size 1.  On a
    mesh whose ``data`` has size 1 both are the identity."""

    def __init__(self, m_specs: Any, mesh: Any):
        self.mesh = mesh
        self.specs = m_specs
        self.active = axis_size(mesh, DATA) > 1

    def _each(self, fn, tree: Any) -> Any:
        if not self.active:
            return tree
        return tree_map(lambda t, spec: fn(t, to_placements(spec, self.mesh))
                        if DATA in spec else t, tree, self.specs)

    def shard(self, tree: Any) -> Any:
        return self._each(lambda t, pl: distribute_tensor(
            t, self.mesh, pl, src_data_rank=None).to_local(), tree)

    def gather(self, tree: Any) -> Any:
        return self._each(lambda t, pl: DTensor.from_local(
            t, self.mesh, pl, run_check=False).full_tensor(), tree)
