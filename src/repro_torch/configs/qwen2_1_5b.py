"""qwen2-1.5b — Qwen2-1.5B [arXiv:2407.10671]. GQA (kv=2) with QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    param_partition="dp",
)
