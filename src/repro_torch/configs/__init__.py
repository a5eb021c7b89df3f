"""Config registry of the port: the dense archs its slice serves.

``llama-7b`` is the paper's own model; ``qwen2-1.5b`` adds QKV bias, GQA and
tied embeddings.  The other archs of the reference's registry come with
their model families (ROADMAP queue A item 12)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import llama_7b, qwen2_1_5b
from repro_torch.configs.base import ArchConfig

CONFIGS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (llama_7b, qwen2_1_5b)
}


def get_config(name: str) -> ArchConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A small same-family config for CPU tests: keeps GQA ratios and biases
    while shrinking every dimension (the reference's ``reduced_config``,
    restricted to the dense family)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} archs are not ported yet (ROADMAP queue A item 12)"
        )
    small = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=512,
        head_dim=16,
        max_seq_len=256,
        param_partition="dp",
        remat="none",
        param_dtype="float32",
        dtype="float32",
    )
    if cfg.sliding_window:
        small["sliding_window"] = 16
    small["name"] = cfg.name + "-smoke"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
