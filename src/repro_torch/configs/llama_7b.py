"""llama-7b — the paper's own evaluation model (Llama-7B on 4xV100).

Used by the cost-model validation tests and the Fig-2 reproduction
benchmarks: 32 layers x 32 heads x 128 head_dim, MHA => KV bytes/token =
2*32*32*128*2 = 524,288 B; a 10K-token context stores ~5.2 GB, matching the
paper's number exactly.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
    rope_theta=10_000.0,
    param_partition="dp",
)
