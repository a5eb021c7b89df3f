"""Weights from the JAX package's parameter tree.

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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Params, resolve_device, resolve_dtype
from repro_torch.models import ssm

# leaves the reference keeps in f32 whatever the param_dtype
F32_LEAVES = (*ssm.F32_LEAVES, "router")


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
