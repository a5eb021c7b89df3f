"""whisper-tiny — [arXiv:2212.04356].

Encoder-decoder.  The mel conv frontend is a stub: a request carries
precomputed frame embeddings.  LayerNorm and GELU, sinusoidal encoder
positions, learned decoder positions, tied embeddings.  The reusable
context is the audio's decoder cross-attention KV (``models.encdec``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder depth
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    rope_theta=None,
    norm_type="layernorm",
    mlp_type="gelu",
    abs_pos_embed=True,
    tie_embeddings=True,
    frontend="audio",
    encoder_seq_len=1500,
    decoder_seq_len=448,
    param_partition="dp",
)
