"""internvl2-1b — InternVL2-1B [arXiv:2404.16821].

InternViT-300M and a Qwen2-0.5B backbone.  The vision frontend is a stub:
a request carries precomputed patch embeddings (``frontend_tokens``
positions), which the LM puts before the text tokens.  The image's
positions are the reusable context.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend="vision",
    frontend_tokens=256,
    param_partition="dp",
)
