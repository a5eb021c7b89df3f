"""Weights (and optimizer state) between the JAX package's tree and the
port's.

``from_jax_params`` takes the reference's parameters as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, api.init(key, cfg))``) and
returns the port's tree.  The reference stacks each layer weight over the
layers for ``lax.scan`` (``lm.init``, ``common.init_stacked``); the port
keeps one dict per layer, so this unstacks them (an encoder-decoder's
``encoder`` and ``decoder`` stacks alike).  Layouts inside a layer are
the same in both packages, and so are dtypes: every leaf takes the
config's ``param_dtype`` but the SSD's ``A_log``, ``D_skip`` and ``dt_bias``
and the MoE router, which stay f32 as the reference keeps them.  The expert
stacks ``[E, D, F]`` of an MoE layer unstack like any other leaf.

``to_jax_params`` is its inverse: the port's tree as numpy in the
reference's layout, each period position's layers stacked on a leading
axis (bf16 and f16 leaves widened to f32, exactly: numpy has no bf16 type
here; ``to_numpy`` takes one leaf to the host so).  Leaf order is then the
reference's (``training.tree``), which the checkpoint format numbers its
leaves by; ``training.fault`` converts an ``AdamState``'s moments, which
have the parameters' tree, with the same two functions.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import block_kinds
from repro_torch.models.common import Params, resolve_device, resolve_dtype
from repro_torch.models import ssm

# leaves the reference keeps in f32 whatever the param_dtype
F32_LEAVES = (*ssm.F32_LEAVES, "router")


def to_numpy(x: Any) -> np.ndarray:
    """A leaf as host numpy: a tensor is copied off its device, a bf16 or
    f16 tensor widened to f32 (exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _tensor(a: Any, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype
    )


def _map(tree: Dict[str, Any], fn) -> Dict[str, Any]:
    """``fn(name, leaf)`` over a nested dict's leaves."""
    return {k: _map(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in tree.items()}


def from_jax_params(cfg: ArchConfig, params_np: Dict[str, Any], device=None,
                    dtype=None) -> Params:
    """The port's parameters for ``cfg`` from the reference's numpy tree.
    ``dtype`` defaults to the config's ``param_dtype``; the SSD's f32 leaves
    and the MoE router stay f32."""
    device = resolve_device(device)
    dtype = dtype or resolve_dtype(cfg.param_dtype)

    def leaf(name, a, i=None):
        a = a if i is None else a[i]
        return _tensor(a, device, torch.float32 if name in F32_LEAVES else dtype)

    def unstack(tree, n):
        return [_map(tree, lambda k, a, i=i: leaf(k, a, i)) for i in range(n)]

    if cfg.family == "encdec":
        return {
            "embed": _map(params_np["embed"], leaf),
            "dec_pos": leaf("dec_pos", params_np["dec_pos"]),
            "encoder": unstack(params_np["encoder"], cfg.n_encoder_layers),
            "enc_norm": _map(params_np["enc_norm"], leaf),
            "decoder": unstack(params_np["decoder"], cfg.n_layers),
            "dec_norm": _map(params_np["dec_norm"], leaf),
        }
    stacks = params_np["layers"]  # one stack per layer kind of a period
    period = len(stacks)
    per_layer = [
        _map(stacks[i % period], lambda k, a, i=i: leaf(k, a, i // period))
        for i in range(cfg.n_layers)
    ]
    return {
        "embed": _map(params_np["embed"], leaf),
        "layers": per_layer,
        "final_norm": _map(params_np["final_norm"], leaf),
    }


def _stack(layers) -> Dict[str, Any]:
    """One dict of ``[len(layers), ...]`` arrays from per-layer dicts."""
    first = layers[0]
    return {k: _stack([lp[k] for lp in layers]) if isinstance(first[k], dict)
            else np.stack([to_numpy(lp[k]) for lp in layers]) for k in first}


def to_jax_params(cfg: ArchConfig, params: Params) -> Dict[str, Any]:
    """The reference's numpy tree of the port's parameters for ``cfg``
    (``from_jax_params``' inverse)."""
    def plain(tree):
        return _map(tree, lambda k, t: to_numpy(t))

    if cfg.family == "encdec":
        return {
            "embed": plain(params["embed"]),
            "dec_pos": to_numpy(params["dec_pos"]),
            "encoder": _stack(params["encoder"]),
            "enc_norm": plain(params["enc_norm"]),
            "decoder": _stack(params["decoder"]),
            "dec_norm": plain(params["dec_norm"]),
        }
    period = len(block_kinds(cfg))
    return {
        "embed": plain(params["embed"]),
        "layers": [_stack(params["layers"][j::period]) for j in range(period)],
        "final_norm": plain(params["final_norm"]),
    }
