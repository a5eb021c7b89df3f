"""Config registry of the port: every arch of the JAX package.

``llama-7b`` is the paper's own model; ``qwen2-1.5b`` and ``qwen2-0.5b`` add
QKV bias, GQA and tied embeddings; ``mistral-nemo-12b`` is GQA with a head
width apart from d_model / n_heads; ``granite-34b`` is MQA with a GELU MLP;
``mamba2-1.3b`` is the attention-free SSM family; ``olmoe-1b-7b`` the MoE
family, ``mixtral-8x22b`` the MoE family with sliding-window attention over
a ring-buffer cache, and ``jamba-1.5-large-398b`` the hybrid family (Mamba,
attention and MoE layers in one 8-layer period); ``internvl2-1b`` is the
VLM family (image embeddings before the text) and ``whisper-tiny`` the
encoder-decoder family (LayerNorm, GELU, cross-attention).

``ASSIGNED`` holds the ten architectures of the reference's assigned matrix
(its dry-run rows), ``EXTRA`` the paper's own model; ``CONFIGS`` is both.
``SHAPES`` and ``cell_is_runnable`` give the matrix's input shapes."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
    granite_34b,
    internvl2_1b,
    jamba_1_5_large_398b,
    llama_7b,
    mamba2_1_3b,
    mistral_nemo_12b,
    mixtral_8x22b,
    olmoe_1b_7b,
    qwen2_0_5b,
    qwen2_1_5b,
    whisper_tiny,
)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, cell_is_runnable  # noqa: F401

# the ten assigned architectures (the dry-run matrix's rows)
ASSIGNED: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (granite_34b, mistral_nemo_12b, qwen2_1_5b, qwen2_0_5b, whisper_tiny,
              internvl2_1b, jamba_1_5_large_398b, olmoe_1b_7b, mixtral_8x22b, mamba2_1_3b)
}
# not part of the assigned matrix: the paper's own model
EXTRA: Dict[str, ArchConfig] = {llama_7b.CONFIG.name: llama_7b.CONFIG}

CONFIGS: Dict[str, ArchConfig] = {**ASSIGNED, **EXTRA}


def get_config(name: str) -> ArchConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A small same-family config for CPU tests: keeps GQA ratios, biases,
    the MoE routing, a sliding window (of 16), the SSD layout, a hybrid
    arch's whole period (one period of layers), an encoder (two layers over
    32 frames, 64 decoder positions) and image positions (8) while shrinking
    every dimension (the reference's ``reduced_config``)."""
    small = dict(
        n_layers=len(cfg.hybrid_period) if cfg.hybrid_period else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        head_dim=16,
        max_seq_len=256,
        param_partition="dp",
        remat="none",
        param_dtype="float32",
        dtype="float32",
    )
    if cfg.moe is not None:
        # capacity_factor >= n_experts / top_k drops no token, so reuse and
        # recompute agree exactly in the CPU tests
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), capacity_factor=4.0
        )
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.family == "encdec":
        small["n_encoder_layers"] = 2
        small["encoder_seq_len"] = 32
        small["decoder_seq_len"] = 64
    if cfg.frontend_tokens:
        small["frontend_tokens"] = 8
    if cfg.sliding_window:
        small["sliding_window"] = 16
    small["name"] = cfg.name + "-smoke"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
