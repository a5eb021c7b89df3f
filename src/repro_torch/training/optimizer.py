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
rule on a mesh (each rank keeps its ``data`` slice of every moment of its
``model`` shard) and ``AdamW.update_zero1`` is the update over it: the
global-norm clip reads the whole gradient (a ``model``-sharded leaf's sum
of squares summed over the ``model`` ranks), each rank updates its slice of
``m``, ``v`` and the parameter, and the ranks all-gather the parameter over
``data``, which gives the unsharded update's bits (every other op is
elementwise; over ``model`` the norm's sums run in another order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import DATA, MODEL, P, axis_size, spec_dim
from repro_torch.distributed.tensor_parallel import gather_dim, shard_dim
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
        (all-reduced over the batch axes) and ``params`` are this rank's
        ``model`` shards, whole over ``data``; returns the new parameters in
        the same layout and the new sliced state, the bits ``update`` gives
        on a ``model`` axis of one."""
        step = state.step + 1
        m, v = self._moments(state, zero.shard(self._clipped(grads, zero.whole_squares)))
        local = tree_map(self._param_update(step), zero.shard(params), m, v)
        return zero.gather(local), AdamState(step=step, m=m, v=v)

    def _clipped(self, grads: Params,
                 whole: Optional[Callable[[list], list]] = None) -> Params:
        """The gradients in f32, scaled down to a global norm of
        ``grad_clip`` where it is exceeded; ``whole`` takes the leaves' sums
        of squares to the whole tensors' (a sharded step's)."""
        g32 = tree_map(lambda g: g.float(), grads)
        if self.grad_clip is None:
            return g32
        squares = [torch.sum(torch.square(g)) for g in tree_leaves(g32)]
        gnorm = torch.sqrt(sum(whole(squares) if whole else squares))
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
    tree (moments, gradients or parameters, in the moment specs' tree) of
    this rank's ``model`` shards, whole over ``data``, to its ``data``
    slices, and ``gather`` takes the slices back (an all-gather over
    ``data``), along the dim each moment's spec names ``data``
    (``tensor_parallel.shard_dim`` / ``gather_dim``): that dim is one the
    spec leaves whole over ``model``, so the slice of the shard is the slice
    of the whole.  On a mesh whose ``data`` has size 1 both are the
    identity.  ``whole_squares`` sums the ``model``-sharded leaves' sums of
    squares over ``model`` (one all-reduce)."""

    def __init__(self, m_specs: Any, mesh: Any):
        self.specs = m_specs
        self.active = axis_size(mesh, DATA) > 1
        self.group = mesh.get_group(DATA) if self.active else None
        self.model_group = mesh.get_group(MODEL) if axis_size(mesh, MODEL) > 1 else None

    def whole_squares(self, squares: list) -> list:
        """Per leaf (the moment specs' order) its sum of squares over the
        whole tensor, from this rank's shard's."""
        if self.model_group is None:
            return squares
        split = [i for i, spec in enumerate(tree_leaves(self.specs)) if MODEL in spec]
        summed = torch.stack([squares[i] for i in split])
        dist.all_reduce(summed, group=self.model_group)
        out = list(squares)
        for i, s in zip(split, summed.unbind()):
            out[i] = s
        return out

    def _each(self, fn, tree: Any) -> Any:
        if not self.active:
            return tree

        def one(t, spec):
            dim = spec_dim(spec, DATA)
            return t if dim is None else fn(t, dim, self.group)

        return tree_map(one, tree, self.specs)

    def shard(self, tree: Any) -> Any:
        return self._each(shard_dim, tree)

    def gather(self, tree: Any) -> Any:
        return self._each(gather_dim, tree)
