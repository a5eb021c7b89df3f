"""Mamba2 (SSD, state-space duality) mixer layer: the sequence mixer of
``mamba2-1.3b``.

The stored context state of an SSM layer is a :class:`MambaState` — (conv
tail, SSD state) — O(1) in the context's length.  The prefill's scan is
``ops.ssd_chunked`` (the CUDA kernel on the card); the decode step is plain
PyTorch on every device, as the reference's is plain jnp.

This is the port of the reference's ``models/ssm.py``, with its names and
layouts; ``forward`` and ``decode`` return the new state, as the
reference's do, and the callers write it into the model state.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import Params

# the SSD's leaves kept in f32 whatever the config's param_dtype
F32_LEAVES = ("A_log", "D_skip", "dt_bias")


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, d_conv-1, conv_dim] — tail of pre-conv activations
    ssd: torch.Tensor  # [B, H, P, S] f32      — SSD recurrent state


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.n_ssm_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, H, conv_dim


def init_mamba_state(cfg: ArchConfig, batch: int, device, dtype=None) -> MambaState:
    s, d_in, H, conv_dim = _dims(cfg)
    dtype = dtype or common.resolve_dtype(cfg.dtype)
    return MambaState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        ssd=torch.zeros((batch, H, s.head_dim, s.d_state), dtype=torch.float32, device=device),
    )


def init_mamba(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    s, d_in, H, conv_dim = _dims(cfg)
    pdtype = common.resolve_dtype(cfg.param_dtype)
    D = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # the input projection as three tensors (z | xBC | dt), the
        # reference's layout
        "in_proj_z": common.dense_init(gen, (D, d_in), pdtype, device, fan_in=D),
        "in_proj_x": common.dense_init(gen, (D, conv_dim), pdtype, device, fan_in=D),
        "in_proj_dt": common.dense_init(gen, (D, H), pdtype, device, fan_in=D),
        "conv_w": common.dense_init(gen, (s.d_conv, conv_dim), pdtype, device,
                                    fan_in=s.d_conv),
        "conv_b": torch.zeros((conv_dim,), dtype=pdtype, device=device),
        # A = -exp(A_log); A starts in [1, 16] as in the Mamba2 reference
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D_skip": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), math.log(math.expm1(1e-2)), **f32),  # softplus^-1
        "norm_w": torch.ones((d_in,), dtype=pdtype, device=device),
        "out_proj": common.dense_init(gen, (d_in, D), pdtype, device, fan_in=d_in),
    }


def _in_proj(p: Params, x: torch.Tensor):
    dt_ = x.dtype
    return x @ p["in_proj_z"].to(dt_), x @ p["in_proj_x"].to(dt_), x @ p["in_proj_dt"].to(dt_)


def _causal_conv(
    p: Params, cfg: ArchConfig, xBC: torch.Tensor, conv_init: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence axis with an optional carried
    tail (so a suffix prefill is exact across the reuse boundary).

    xBC: [B, S, conv_dim] -> (conv_out [B, S, conv_dim], new tail)."""
    s = cfg.ssm
    B, S, Cd = xBC.shape
    if conv_init is None:
        conv_init = torch.zeros((B, s.d_conv - 1, Cd), dtype=xBC.dtype, device=xBC.device)
    padded = torch.cat([conv_init.to(xBC.dtype), xBC], dim=1)
    w = p["conv_w"].float()
    out = torch.zeros((B, S, Cd), dtype=torch.float32, device=xBC.device)
    for i in range(s.d_conv):
        out = out + padded[:, i : i + S].float() * w[i]
    out = out + p["conv_b"].float()
    new_tail = padded[:, S:][:, -(s.d_conv - 1):]
    return torch.nn.functional.silu(out).to(xBC.dtype), new_tail


def _ssd_inputs(cfg: ArchConfig, conv_out: torch.Tensor, dt_raw: torch.Tensor, p: Params):
    """The scan's operands from the conv output, each contiguous (the kernel
    takes only contiguous tensors; ``x_in``, B and C are slices of one
    row)."""
    s, d_in, H, _ = _dims(cfg)
    B, S, _ = conv_out.shape
    gs = s.n_groups * s.d_state
    x_in = conv_out[..., :d_in].reshape(B, S, H, s.head_dim).contiguous()
    Bmat = conv_out[..., d_in : d_in + gs].reshape(B, S, s.n_groups, s.d_state).contiguous()
    Cmat = conv_out[..., d_in + gs :].reshape(B, S, s.n_groups, s.d_state).contiguous()
    dt = common.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return x_in, dt, A, Bmat, Cmat


def _gated_out(p: Params, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    _, d_in, _, _ = _dims(cfg)
    y = y.reshape(y.shape[0], -1, d_in)
    y = common.rms_norm(y * torch.nn.functional.silu(z.to(y.dtype)), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype)


# --------------------------------------------------------------------------- #
# Full-sequence or suffix prefill
# --------------------------------------------------------------------------- #
def forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, S, D]
    state: Optional[MambaState] = None,  # carried state (reuse / two-phase prefill)
) -> Tuple[torch.Tensor, MambaState]:
    s = cfg.ssm
    z, xBC, dt_raw = _in_proj(p, x)
    conv_out, conv_tail = _causal_conv(p, cfg, xBC, state.conv if state is not None else None)
    x_in, dt, A, Bmat, Cmat = _ssd_inputs(cfg, conv_out, dt_raw, p)
    y, ssd_state = ops.ssd_chunked(
        x_in, dt, A, Bmat, Cmat, chunk=s.chunk,
        initial_state=state.ssd if state is not None else None,
    )
    y = y + p["D_skip"][None, None, :, None] * x_in.float()
    out = _gated_out(p, cfg, y.to(x.dtype), z)
    return out, MambaState(conv=conv_tail, ssd=ssd_state)


# --------------------------------------------------------------------------- #
# O(1) decode step
# --------------------------------------------------------------------------- #
def decode(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, 1, D]
    state: MambaState,
) -> Tuple[torch.Tensor, MambaState]:
    z, xBC, dt_raw = _in_proj(p, x)
    window = torch.cat([state.conv.to(xBC.dtype), xBC], dim=1)  # [B, d_conv, Cd]
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    conv_out = conv_out + p["conv_b"].float()
    conv_out = torch.nn.functional.silu(conv_out)[:, None, :].to(xBC.dtype)  # [B, 1, Cd]
    new_tail = window[:, 1:]

    x_in, dt, A, Bmat, Cmat = _ssd_inputs(cfg, conv_out, dt_raw, p)
    y_t, ssd_state = ops.ssd_decode(state.ssd, x_in[:, 0], dt[:, 0], A, Bmat[:, 0], Cmat[:, 0])
    y_t = y_t.float() + p["D_skip"][None, :, None] * x_in[:, 0].float()
    out = _gated_out(p, cfg, y_t[:, None].to(x.dtype), z)
    return out, MambaState(conv=new_tail, ssd=ssd_state)
