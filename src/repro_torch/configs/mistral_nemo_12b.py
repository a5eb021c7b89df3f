"""mistral-nemo-12b — Mistral-Nemo-Base-2407 [hf:mistralai/Mistral-Nemo-Base-2407].

128k-context dense GQA model; head_dim=128 is explicit (d_model/n_heads=160
does NOT hold: Nemo decouples head width from d_model, so H·hd = 4096 while
d_model = 5120).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    param_partition="fsdp",
    remat="dots",
)
