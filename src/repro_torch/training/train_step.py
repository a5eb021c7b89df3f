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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm
from repro_torch.training.optimizer import AdamState, AdamW
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

AUX_COEF = 0.01


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_fn(params: Any, cfg: ArchConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    batch = _on(batch, params["embed"]["table"].device)
    if cfg.family == "encdec":
        logits, aux = encdec.forward(params, cfg, batch["frames"], batch["dec_tokens"])
    else:
        logits, aux = lm.forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"))
    ce = lm.cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + AUX_COEF * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(params: Any, cfg: ArchConfig, batch: Dict[str, Any]):
    """``((loss, parts), grads)`` of ``loss_fn``: grads in the parameters'
    tree and dtypes (zeros where a parameter took no part)."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    parts = {k: v.detach() for k, v in parts.items()}
    return (loss.detach(), parts), tree_unflatten(params, grads)


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
