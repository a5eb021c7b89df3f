"""Shared model utilities: dtype policy, parameter init and numerics.

Parameters are nested dicts of tensors with the JAX package's layouts
(dense weights stored ``[in, out...]``), one dict per layer; forward passes
are plain functions of ``(params, config, inputs)``.  Every random draw takes
an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, Any]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name) -> torch.dtype:
    if isinstance(name, str):
        return _DTYPES[name]
    return name


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for another device;
    with no device given and no CUDA, it raises instead of running on the
    CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")


# --------------------------------------------------------------------------- #
# Parameter initialisation
# --------------------------------------------------------------------------- #
def seeded_generator(seed: int, device: torch.device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``; None on ``meta``,
    where tensors have shapes and no values, so there is nothing to draw."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype, device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Lecun-normal init (stddev = 1/sqrt(fan_in)); fan_in defaults to the
    first dimension."""
    fan_in = int(fan_in if fan_in is not None else shape[0])
    std = 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype, device) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


# --------------------------------------------------------------------------- #
# Numerics
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in f32 with the population variance, cast back to ``x``'s
    dtype (the reference's ``layer_norm``)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x_gate) * x_up


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``:
    no threshold, unlike ``torch.nn.functional.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))
