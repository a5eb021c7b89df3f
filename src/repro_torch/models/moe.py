"""Mixture-of-experts FFN with sort-based capacity dispatch.

The reference's ``models/moe.py``: each token's router picks its ``top_k``
experts (f32 router product, softmax, top-k, renormalised weights); the
(token, expert) pairs are sorted stably by expert, each pair's position in
its expert's group is its slot, and a pair whose position reaches the
capacity ``C`` is dropped.  The kept pairs are scattered into a static
``[E, C, D]`` block, the expert SwiGLU runs as three batched products over
it, and each token sums its kept pairs' weighted outputs.

``C`` depends on the launch's token count ``T`` (``expert_capacity``), and
padding tokens route like any other: callers hand in the same padded
launches as the reference, so the same pairs drop.

The combine runs in a fixed order with no atomics: each token's pairs are
gathered in expert order (the order the reference's scatter-add visits
them) and added one by one, so two launches on the same inputs give the
same bits on the card.

Expert-parallel sharding (the reference's ``_ep_spec``) is not ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import Params


def init_moe(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    """Router ``[D, E]`` (f32, as the reference keeps it) and the expert
    stacks ``w_gate``/``w_up`` ``[E, D, F]`` and ``w_down`` ``[E, F, D]``."""
    assert cfg.moe is not None
    pdtype = common.resolve_dtype(cfg.param_dtype)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": common.dense_init(gen, (D, E), torch.float32, device, fan_in=D),
        "w_gate": common.dense_init(gen, (E, D, F), pdtype, device, fan_in=D),
        "w_up": common.dense_init(gen, (E, D, F), pdtype, device, fan_in=D),
        "w_down": common.dense_init(gen, (E, F, D), pdtype, device, fan_in=F),
    }


def expert_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for a launch of ``n_tokens`` tokens: ``T·k/E`` times
    the capacity factor, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


class Dispatch(NamedTuple):
    """The routing of one launch of ``T`` tokens; pair arrays are in sorted
    (expert, token) order, ``T·k`` long."""

    probs: torch.Tensor  # [T, E] f32 router softmax
    top_i: torch.Tensor  # [T, k] int64 chosen experts, by descending weight
    expert: torch.Tensor  # [T·k] expert of each pair
    token: torch.Tensor  # [T·k] token of each pair
    weight: torch.Tensor  # [T·k] f32 weight of each pair
    keep: torch.Tensor  # [T·k] bool: the pair's position in its expert < C
    slot: torch.Tensor  # [T·k] row of [E·C + 1] (dropped pairs: the overflow row E·C)
    capacity: int  # C


def dispatch(p: Params, cfg: ArchConfig, xf: torch.Tensor) -> Dispatch:
    """Route the tokens ``xf [T, D]``: the reference's router, top-k, stable
    sort by expert and capacity rule (``src/repro/models/moe.py:84-104``)."""
    m = cfg.moe
    T = xf.shape[0]
    E, k = m.n_experts, m.top_k
    C = expert_capacity(T, cfg)
    logits = xf.float() @ p["router"].float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    e_flat = top_i.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    t_s = order // k  # pair t*k + j belongs to token t
    w_s = top_p.reshape(-1)[order]
    first = torch.searchsorted(e_s, e_s, side="left")
    pos_in_e = torch.arange(T * k, device=xf.device) - first
    keep = pos_in_e < C
    slot = torch.where(keep, e_s * C + pos_in_e, torch.full_like(e_s, E * C))
    return Dispatch(probs, top_i, e_s, t_s, w_s, keep, slot, C)


def aux_loss(d: Dispatch, cfg: ArchConfig) -> torch.Tensor:
    """The switch load-balancing loss ``E * sum_e(frac_e * mean_prob_e)``
    (1.0 at perfect balance)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    # one-hot counts by comparison: no host sync on the card (bincount has one)
    one_hot = d.top_i[:, :, None] == torch.arange(E, device=d.top_i.device)
    frac = one_hot.float().sum(dim=1).mean(dim=0) / k
    return E * torch.sum(frac * d.probs.mean(dim=0))


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss, a f32 scalar)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    xf = x.reshape(T, D)
    d = dispatch(p, cfg, xf)
    C = d.capacity

    # dispatch: dropped pairs all land on the overflow row, which no output reads
    xs = torch.zeros(E * C + 1, D, dtype=x.dtype, device=x.device)
    xs[d.slot] = xf[d.token]
    xe = xs[: E * C].view(E, C, D)

    # expert SwiGLU, batched over E
    dt = x.dtype
    g = torch.bmm(xe, p["w_gate"].to(dt))
    u = torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(common.swiglu(g, u), p["w_down"].to(dt))

    # combine: each token's pairs in expert order, added one at a time
    ys = torch.cat([ye.reshape(E * C, D), torch.zeros(1, D, dtype=dt, device=x.device)])
    contrib = ys[d.slot] * (d.weight * d.keep).to(dt)[:, None]
    by_token = torch.argsort(d.token * E + d.expert)  # unique keys: (token, expert) order
    contrib = contrib[by_token].view(T, k, D)
    out = torch.zeros(T, D, dtype=dt, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out.view(B, S, D), aux_loss(d, cfg)
