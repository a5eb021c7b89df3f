"""granite-34b — IBM Granite Code 34B [arXiv:2405.04324].

A Llama-style attention stack with MQA (one KV head): a token's stored KV
is 48x smaller than under MHA, which cuts the paper's break-even reuse
count.  The 34B model derives from GPTBigCode, so its MLP is the
two-matrix GELU form with biases; the implemented model holds
33,965,070,336 parameters (63.26 GiB in bf16).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,  # MQA
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    rope_theta=10_000.0,
    mlp_type="gelu",
    tie_embeddings=False,
    param_partition="fsdp",
    remat="dots",
)
