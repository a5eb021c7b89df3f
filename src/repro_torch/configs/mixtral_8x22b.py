"""mixtral-8x22b — Mixtral-8x22B [arXiv:2401.04088; hf].

8 experts, top-2, MoE on every layer; sliding-window attention with a
window of 4,096 (the Mistral-lineage default).  The decode cache is a ring
of ``min(max_len, 4096)`` rows per layer, and a stored context holds
``min(L, 4096)`` rows per layer, whatever its length ``L``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,  # per-expert FFN width
    vocab=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    max_seq_len=65_536,
    param_partition="fsdp",
    remat="dots",
)
