"""Training step factory: loss, gradients, optimizer update, metrics.

The reference's ``training/train_step.py``.  The batch's keys select the
forward: ``tokens`` (with ``embeds`` before them for a VLM), ``labels`` and
an optional ``mask``, or for the encoder-decoder ``frames`` and
``dec_tokens``; its values may be tensors or arrays and land on the
parameters' device.  The MoE aux (load-balancing) loss is folded in with a
coefficient of 0.01, normalised by the layer count.

Gradients come from ``torch.autograd.grad`` on detached copies of the
parameters that require grad, so a step leaves its inputs as they were, as
the reference's pure step does.

``make_sharded_train_step`` is the step over a ``(pod, data, model)``
mesh, the counterpart of the reference's ``jax.jit(step,
in_shardings=...)``: each rank runs its shard of the batch over ``("pod",
"data")`` (``sharding.data_specs``); the dense ``dp`` archs run the
``model`` axis tensor parallel on their ``param_specs`` shards
(``tensor_parallel``, the models' ``model_group``); the loss is the whole
batch's, the gradients are summed over ``data`` and then over ``pod`` (the
pod axis is plain data parallelism, as the reference's step is) and the
update is ``AdamW.update_zero1`` (moments sliced by ``opt_specs``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding, tensor_parallel
from repro_torch.models import encdec, lm, registry
from repro_torch.training.optimizer import AdamState, AdamW, Zero1, opt_specs
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

AUX_COEF = 0.01


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _forward(params: Any, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
             model_group: Any = None):
    """(logits, aux) of the family's training forward (tensor parallel over
    ``model_group`` where given: the dense families)."""
    if cfg.family == "encdec":
        return encdec.forward(params, cfg, batch["frames"], batch["dec_tokens"])
    return lm.forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"),
                      model_group=model_group)


def loss_fn(params: Any, cfg: ArchConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    batch = _on(batch, params["embed"]["table"].device)
    logits, aux = _forward(params, cfg, batch)
    ce = lm.cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + AUX_COEF * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "aux": aux}


def _grads(params: Any, objective) -> Tuple[Any, Any]:
    """``objective(params)`` -> (loss, parts), and the gradients of its
    loss in the parameters' tree and dtypes (zeros where a parameter took
    no part), from detached copies that require grad."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, parts = objective(tree_unflatten(params, live))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return (loss.detach(), parts), tree_unflatten(params, grads)


def value_and_grad(params: Any, cfg: ArchConfig, batch: Dict[str, Any]):
    """``((loss, parts), grads)`` of ``loss_fn``: grads in the parameters'
    tree and dtypes (zeros where a parameter took no part)."""
    (loss, parts), grads = _grads(params, lambda p: loss_fn(p, cfg, batch))
    return (loss, {k: v.detach() for k, v in parts.items()}), grads


def make_train_step(cfg: ArchConfig, opt: AdamW):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)."""

    def train_step(params, opt_state: AdamState, batch):
        (loss, parts), grads = value_and_grad(params, cfg, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **parts, "step": opt_state.step}

    return train_step


def make_grad_accum_step(cfg: ArchConfig, opt: AdamW, accum: int):
    """Microbatched variant: splits the batch on axis 0 into ``accum``
    chunks and sums their gradients in f32 (the reference's ``lax.scan``),
    trading activation memory for steps."""

    def step(params, opt_state: AdamState, batch):
        batch = _on(batch, params["embed"]["table"].device)
        micro = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        l_acc = torch.zeros((), dtype=torch.float32, device=params["embed"]["table"].device)
        for i in range(accum):
            (loss, _), g = value_and_grad(params, cfg, {k: v[i] for k, v in micro.items()})
            g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
            l_acc = l_acc + loss
        grads = tree_map(lambda g: g / accum, g_acc)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": l_acc / accum, "step": opt_state.step}

    return step


# the families whose train step runs a model axis, and their parameters'
# layout (A11d-1); the others run the data and pod axes only (A11d-2)
TENSOR_PARALLEL_FAMILIES = ("dense", "vlm")


def runs_model_axis(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s train step runs tensor parallel over ``model``."""
    return cfg.family in TENSOR_PARALLEL_FAMILIES and cfg.param_partition == "dp"


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    over a mesh (see the module docstring).  ``params`` are this rank's
    ``model`` shards (``shard_params``; the whole tree on a ``model`` axis
    of one) and so are the returned ones; ``opt_state`` holds this rank's
    moment slices (``init``, ``shard_state``); ``gather_params`` and
    ``gather_state`` give the whole trees (collectives: every rank calls
    them).

    The loss is ``lm.cross_entropy`` of the whole batch: each rank's masked
    NLL sum and mask count are summed over ``data`` and ``pod`` before the
    division, and each rank differentiates its own sum over the global
    count, so the summed gradients are the whole batch's.  Over ``model``
    the ranks compute the same loss from the vocab-sharded logits
    (``lm.nll_sums(model_group=...)``); a leaf their specs replicate gets
    the same gradient on each with no collective of its own.  The MoE
    load-balancing loss is each rank's own tokens' and the ranks' mean
    (ROADMAP C12: the reference's is the global batch's).  A batch the
    batch axes do not divide is run whole on every rank, with no sum.  With
    one rank on every axis this is ``make_train_step``'s arithmetic, bit
    for bit.

    The dense ``dp`` families (``runs_model_axis``) take the model group
    down on any ``model`` size; the other families, and any arch on a
    ``model`` or ``pod`` axis over one, raise (ROADMAP A11d-2)."""

    def __init__(self, cfg: ArchConfig, opt: AdamW, mesh: Any):
        axes = sharding.mesh_axes(mesh)
        tensor_parallel = runs_model_axis(cfg)
        wide = {a: axes[a] for a in (sharding.MODEL, sharding.POD) if axes.get(a, 1) > 1}
        if wide and not tensor_parallel:
            raise ValueError(
                f"make_sharded_train_step: {cfg.name} ({cfg.family}, {cfg.param_partition}) on "
                f"{wide}: the model and pod axes run for the dense dp families; the MoE, SSM, "
                "hybrid and encoder-decoder families and FSDP are ROADMAP item A11d-2")
        self.cfg, self.opt, self.mesh = cfg, opt, mesh
        self.group = mesh.get_group(sharding.DATA)
        self.pod_group = (mesh.get_group(sharding.POD) if axes.get(sharding.POD, 1) > 1
                          else None)
        self.model_group = (mesh.get_group(sharding.MODEL)
                            if tensor_parallel and sharding.MODEL in axes else None)
        self.ranks = dist.get_world_size(self.group) * axes.get(sharding.POD, 1)
        self.rank = (dist.get_rank(self.group) if self.pod_group is None else
                     dist.get_rank(self.pod_group) * dist.get_world_size(self.group)
                     + dist.get_rank(self.group))
        shapes = registry.get_model(cfg).init(cfg, device="meta")
        self.param_specs = sharding.param_specs(cfg, shapes, mesh)
        self.opt_specs = opt_specs(self.param_specs, shapes, mesh)
        self.zero = Zero1(self.opt_specs.m, mesh)

    def shard_params(self, params: Any) -> Any:
        """This rank's ``model`` shards of the whole tree ``params``."""
        return tensor_parallel.shard_params(params, self.param_specs, self.mesh)

    def gather_params(self, params: Any) -> Any:
        return tensor_parallel.gather_params(params, self.param_specs, self.mesh)

    def init(self, params: Any) -> AdamState:
        """The sliced state of this rank's shards ``params``."""
        state = self.opt.init(params)
        return AdamState(step=state.step, m=self.zero.shard(state.m),
                         v=self.zero.shard(state.v))

    def shard_state(self, state: AdamState) -> AdamState:
        """This rank's slices of the whole state."""
        return AdamState(step=state.step, m=self.zero.shard(self.shard_params(state.m)),
                         v=self.zero.shard(self.shard_params(state.v)))

    def gather_state(self, state: AdamState) -> AdamState:
        return AdamState(step=state.step, m=self.gather_params(self.zero.gather(state.m)),
                         v=self.gather_params(self.zero.gather(state.v)))

    def _all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the batch axes: ``data``, then ``pod``."""
        dist.all_reduce(t, group=self.group)
        if self.pod_group is not None:
            dist.all_reduce(t, group=self.pod_group)
        return t

    def _local(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows of every batch leaf, or None where the batch
        stays whole."""
        n = next(iter(batch.values())).shape[0]
        specs = sharding.data_specs(self.cfg, batch, n, self.mesh)
        if self.ranks == 1 or any(spec[0] is None for spec in specs.values()):
            return None
        rows = n // self.ranks
        return {k: v[self.rank * rows:(self.rank + 1) * rows] for k, v in batch.items()}

    def __call__(self, params: Any, opt_state: AdamState, batch: Dict[str, Any]):
        cfg, group = self.cfg, self.model_group
        batch = _on(batch, params["embed"]["table"].device)
        local = self._local(batch)
        if local is None and self.ranks > 1 and group is None:
            # every rank runs the whole batch
            (loss, parts), grads = value_and_grad(params, cfg, batch)
        else:
            # the batch whole on this rank (one batch rank, or a model group
            # running a batch the batch axes do not divide): no sums over them
            whole = local is None
            local = batch if whole else local
            ranks = 1 if whole else self.ranks

            def objective(p):
                logits, aux = _forward(p, cfg, local, group)
                total, n = lm.nll_sums(logits, local["labels"], local.get("mask"), group)
                count = n if whole else self._all_sum(n)
                count = count.clamp_min(1.0)
                share = total / count + AUX_COEF * aux / (max(cfg.n_layers, 1) * ranks)
                return share, {"total": total.detach(), "count": count, "aux": aux.detach()}

            (_, parts), grads = _grads(params, objective)
            if not whole:
                grads = tree_map(self._all_sum, grads)
            total = parts["total"] if whole else self._all_sum(parts["total"])
            aux = parts["aux"] if whole else self._all_sum(parts["aux"]) / ranks
            ce = total / parts["count"]
            loss = ce + AUX_COEF * aux / max(cfg.n_layers, 1)
            parts = {"ce": ce, "aux": aux}
        params, opt_state = self.opt.update_zero1(grads, opt_state, params, self.zero)
        return params, opt_state, {"loss": loss, **parts, "step": opt_state.step}


def make_sharded_train_step(cfg: ArchConfig, opt: AdamW, mesh: Any) -> ShardedTrainStep:
    """The train step over ``mesh`` (a ``DeviceMesh`` with ``data`` and
    ``model`` dims and optionally ``pod``; see ``ShardedTrainStep``)."""
    return ShardedTrainStep(cfg, opt, mesh)
