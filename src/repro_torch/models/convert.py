"""Weights from the JAX package's parameter tree.

``from_jax_params`` takes the reference's parameters as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, api.init(key, cfg))``) and
returns the port's tree.  The reference stacks each layer weight over the
layers for ``lax.scan`` (``lm.init``, ``common.init_stacked``); the port
keeps one dict per layer, so this unstacks them.  Layouts inside a layer are
the same in both packages.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Params, resolve_device, resolve_dtype
from repro_torch.models.registry import get_model


def _tensor(a: Any, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype
    )


def _map(tree: Dict[str, Any], fn) -> Dict[str, Any]:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def from_jax_params(cfg: ArchConfig, params_np: Dict[str, Any], device=None,
                    dtype=None) -> Params:
    """The port's parameters for ``cfg`` from the reference's numpy tree.
    ``dtype`` defaults to the config's ``param_dtype``."""
    get_model(cfg)  # raises for families the port does not carry
    device = resolve_device(device)
    dtype = dtype or resolve_dtype(cfg.param_dtype)
    stacks = params_np["layers"]
    if len(stacks) != 1:
        raise ValueError(f"expected one layer kind, got {len(stacks)}")
    stacked = stacks[0]
    per_layer = [
        _map(stacked, lambda a, i=i: _tensor(a[i], device, dtype))
        for i in range(cfg.n_layers)
    ]
    return {
        "embed": _map(params_np["embed"], lambda a: _tensor(a, device, dtype)),
        "layers": per_layer,
        "final_norm": _map(params_np["final_norm"], lambda a: _tensor(a, device, dtype)),
    }
