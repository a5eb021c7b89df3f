"""olmoe-1b-7b — OLMoE-1B-7B [arXiv:2409.02060; hf].

64 experts, top-8, MoE on every layer; about 1.3B active of 6.9B total
parameters.  The KV cache is that of a 16-layer MHA decoder (hd 128):
128 KiB a token.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert FFN width
    vocab=50304,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=8),
    param_partition="dp",
)
