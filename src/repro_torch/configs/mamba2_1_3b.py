"""mamba2-1.3b — Mamba2-1.3B [arXiv:2405.21060].

Attention-free SSD (state-space duality).  d_inner = 2*d_model = 4096,
head_dim 64 => 64 SSD heads, d_state=128, chunk 256, no separate MLP
(d_ff=0): each block is norm + SSD mixer.

The stored context state is (conv tail, SSD state) per layer: O(1) in
context length, so reuse stores the same bytes whatever the context's
length.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=32,  # unused (attention-free); kept for API uniformity
    n_kv_heads=32,
    d_ff=0,
    vocab=50280,
    rope_theta=None,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    tie_embeddings=True,
    max_seq_len=1_048_576,
    param_partition="dp",
)
