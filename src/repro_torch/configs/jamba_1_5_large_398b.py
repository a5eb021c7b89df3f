"""jamba-1.5-large-398b — AI21 Jamba-1.5-Large [arXiv:2403.19887; hf].

Hybrid Mamba and attention at a 1:7 interleave (one attention layer per
8-layer period), MoE (16 experts, top-2) on every other layer, no positional
embedding (the Mamba layers carry position).  The Mamba layers run in the
SSD (Mamba-2) formulation: d_inner 16,384, 128 SSD heads of width 128,
d_state 16, one group.

A stored context holds 9 attention layers' K/V, which grows with its length,
plus each of the 63 Mamba layers' (conv, SSD) state, which does not: the
paper's stored size gains a term independent of the context's length.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,  # 9 periods x 8 layers
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    rope_theta=None,  # no positional embedding
    moe=MoEConfig(n_experts=16, top_k=2, every=2, offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=128, n_groups=1, chunk=256),
    hybrid_period=("m", "m", "m", "m", "a", "m", "m", "m"),
    max_seq_len=262_144,
    param_partition="fsdp",
    remat="dots",
)
