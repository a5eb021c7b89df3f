"""The ``model`` axis's operators and the parameters' local shards (a port
addition: the reference gets tensor parallelism from XLA's partitioner).

The residual stream is whole on every rank of the ``model`` group, and so
is its gradient.  A column-parallel weight (heads, FFN width, vocab) reads
it through ``copy_to_model`` (identity forward; the backward all-reduces
the ranks' partial input gradients); a row-parallel product's partial sums
meet in ``reduce_from_model`` (all-reduce forward; identity backward).  A
tensor whose last dim (head_dim) is split over the ranks is made whole by
``gather_last_dim`` (all-gather forward; the backward keeps this rank's
slice of the whole gradient), and cut back to this rank's slice by its
adjoint ``split_last_dim`` (slice forward; all-gather backward).

Every operator goes through ``torch.distributed`` on the group it is given
(so a fake group in the dry run counts its bytes).  On a group of one rank,
or with no group, each returns its input's values and issues nothing.

``shard_params`` / ``gather_params`` take a full parameter tree to this
rank's ``model`` shards and back, along the dim each leaf's spec names
``model`` (``sharding.spec_dim``, the dim of ``to_placements``' ``Shard``;
the specs' other axes are not applied: FSDP over ``data`` is not run).
``shard_dim`` cuts and ``gather_dim`` all-gathers (``dist.all_gather``) one
tensor; ZeRO-1 uses both over ``data``.  DTensor's ``full_tensor`` is not
used: its functional all-gather broke the heap of a gloo rank on the CPU
(``double free or corruption``) and segfaulted on CUDA tensors over gloo.
The models import this module and ``sharding`` imports the models, so the
parameter functions import ``sharding`` when they are called.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.training.tree import tree_map


def group_size(group: Any) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Any) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group: Any, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather_last(x: torch.Tensor, group: Any) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


def _my_slice(x: torch.Tensor, group: Any) -> torch.Tensor:
    n = x.shape[-1] // dist.get_world_size(group)
    return x.narrow(-1, dist.get_rank(group) * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.group), None


class _SplitLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _my_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group), None


def copy_to_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` whole on every rank, read by a column-parallel product."""
    return x if group_size(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum over the ranks of their partial ``x``."""
    return x if group_size(group) == 1 else _ReduceFromModel.apply(x, group)


def gather_last_dim(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Every rank's slice of the last dim, in rank order."""
    return x if group_size(group) == 1 else _GatherLastDim.apply(x, group)


def split_last_dim(x: torch.Tensor, group: Any) -> torch.Tensor:
    """This rank's slice of the last dim of a whole ``x``."""
    return x if group_size(group) == 1 else _SplitLastDim.apply(x, group)


def all_max(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The elementwise max over the ranks (no gradient)."""
    return x.detach() if group_size(group) == 1 else _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def shard_count(local: int, full: int, group: Any) -> int:
    """The number of ranks a dim of ``full`` whose local size is ``local`` is
    split over: the group's size where ``local`` is its share, 1 where the
    dim is whole (replicated), else an error."""
    m = group_size(group)
    if local * m == full:
        return m
    if local == full:
        return 1
    raise ValueError(f"a local dim of {local} is neither whole ({full}) nor a 1/{m} share")


# --------------------------------------------------------------------------- #
# Shards of whole tensors
# --------------------------------------------------------------------------- #
def shard_dim(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """This rank's equal part of ``t`` along ``dim`` (rank order)."""
    n = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n).contiguous()


def gather_dim(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's part along ``dim``, in rank order (an all-gather)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _each_model_shard(fn, tree: Any, specs: Any, mesh: Any) -> Any:
    """``fn(leaf, dim, model group)`` on every leaf whose spec names
    ``model`` on ``dim``; the others as they are.  The identity where the
    mesh's ``model`` dim has size 1."""
    from repro_torch.distributed.sharding import MODEL, axis_size, spec_dim

    if axis_size(mesh, MODEL) == 1:
        return tree
    group = mesh.get_group(MODEL)

    def one(t, spec):
        dim = spec_dim(spec, MODEL)
        return t if dim is None else fn(t, dim, group)

    return tree_map(one, tree, specs)


def shard_params(params: Any, specs: Any, mesh: Any) -> Any:
    """This rank's ``model`` shard of every leaf of the full tree
    ``params`` (nothing is communicated)."""
    return _each_model_shard(shard_dim, params, specs, mesh)


def gather_params(local: Any, specs: Any, mesh: Any) -> Any:
    """The full tree from every rank's ``model`` shards (an all-gather over
    ``model``: every rank calls it)."""
    return _each_model_shard(gather_dim, local, specs, mesh)
