"""Architecture + shape configuration system.

Every architecture is expressed as an :class:`ArchConfig`.

Design notes
------------
* ``ArchConfig`` is a frozen dataclass so configs are hashable.
* ``head_dim`` may differ from ``d_model // n_heads`` (e.g. Mistral-Nemo uses
  head_dim=128 with d_model=5120, 32 heads).
* ``padded_vocab`` rounds the embedding table up to a multiple of 128 (the
  reference's layout, kept so parameter counts and weights match).
* ``hybrid_period`` describes one repeated period of layer kinds for hybrid
  stacks (Jamba): the model scans over periods and unrolls within a period.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

VOCAB_PAD_MULTIPLE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for MoE / hybrid architectures."""

    n_experts: int
    top_k: int
    # MoE replaces the dense MLP on layers where ``layer_idx % every == offset``.
    every: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings for SSM and hybrid architectures."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A complete, exact architecture description from the public literature."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- attention details -------------------------------------------------
    head_dim: Optional[int] = None  # default: d_model // n_heads
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10_000.0  # None => no rotary embedding
    sliding_window: Optional[int] = None  # SWA window (Mixtral)

    # --- family-specific ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # One repeated period of layer kinds, e.g. Jamba:
    #   ("m", "m", "m", "m", "a", "m", "m", "m")  (attention at index 4)
    hybrid_period: Optional[Tuple[str, ...]] = None
    n_encoder_layers: int = 0  # enc-dec (Whisper): encoder depth
    encoder_seq_len: int = 1500  # Whisper: fixed 30 s => 1500 frames
    decoder_seq_len: int = 448  # Whisper: max decoder positions

    # --- frontend stubs (audio / vlm) — per spec the modality frontend is a
    # stub: input_specs() provides precomputed frame/patch embeddings. -------
    frontend: Optional[str] = None  # "audio" | "vision"
    frontend_tokens: int = 0  # number of stub embedding positions (vision)

    # --- misc ---------------------------------------------------------------
    tie_embeddings: bool = False
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm" (Whisper)
    mlp_type: str = "swiglu"  # "swiglu" | "gelu" (Whisper)
    abs_pos_embed: bool = False  # sinusoidal absolute positions (Whisper)
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"  # activation dtype
    max_seq_len: int = 32_768

    # --- distribution policy ------------------------------------------------
    # "dp"    : params replicated over data axis (small models)
    # "fsdp"  : params additionally sharded over the data axis (big models)
    param_partition: str = "dp"
    # remat policy for the scanned layer body: none | dots | full
    remat: str = "none"
    # Fully unroll the scan over layers (used by the dry-run's depth
    # calibration: XLA cost_analysis counts a while-loop body ONCE, so the
    # roofline pipeline compiles unrolled 1- and 2-period variants and
    # extrapolates the linear-in-depth term; see benchmarks/roofline.py).
    scan_unroll: bool = False

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, VOCAB_PAD_MULTIPLE)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def n_attn_layers(self) -> int:
        """Number of self-attention layers in the decoder stack."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            assert self.hybrid_period is not None
            per = sum(1 for k in self.hybrid_period if k == "a")
            return per * (self.n_layers // len(self.hybrid_period))
        return self.n_layers

    @property
    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            assert self.hybrid_period is not None
            per = sum(1 for k in self.hybrid_period if k == "m")
            return per * (self.n_layers // len(self.hybrid_period))
        return 0

    @property
    def supports_long_context(self) -> bool:
        """True if the arch can decode with a 500k context sub-quadratically
        and with bounded per-layer state (SSM, hybrid, or SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    # --- parameter counting (used by the cost model & roofline) ---------- #
    def param_count(self) -> int:
        """Exact parameter count of the implemented model (including biases,
        norms and the padded embedding table)."""
        from repro_torch.models.registry import count_params  # late import, no cycle

        return count_params(self)

    def kv_bytes_per_token(self, kv_dtype_bytes: int = 2) -> int:
        """Bytes of *stored context state* per context token (the paper's
        ``S_storage(L) / L``).  For attention layers this is the classic
        2 * n_kv * head_dim * bytes; SSM layers contribute zero per-token
        bytes (their state is O(1), accounted separately)."""
        per_attn = 2 * self.n_kv_heads * self.resolved_head_dim * kv_dtype_bytes
        n_attn = self.n_attn_layers
        if self.family == "encdec":
            # decoder self-attn KV + decoder cross-attn KV over the encoder
            # output are both per-context-token state.
            n_attn = self.n_layers * 2
        return per_attn * n_attn

    def fixed_state_bytes(self, dtype_bytes: int = 2) -> int:
        """O(1)-in-L stored state: SSD state + conv state for SSM layers."""
        if self.ssm is None or self.n_ssm_layers == 0:
            return 0
        s = self.ssm
        d_in = s.d_inner(self.d_model)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        ssd = s.n_ssm_heads(self.d_model) * s.head_dim * s.d_state
        conv = (s.d_conv - 1) * conv_dim
        return self.n_ssm_layers * (ssd + conv) * dtype_bytes




@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    # the KV caches length-sharded over the mesh's ``model`` axis, attention
    # through the KV-sharded route (the reference's layout for its
    # long-context cells, under ``REPRO_ATTN_KV_SHARD=1``)
    kv_shard: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1, kv_shard=True),
}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell of the matrix, and why not
    if not: ``long_500k`` needs sub-quadratic context handling, so a pure
    full-attention arch skips it; SSM, hybrid and sliding-window archs run
    it (the reference's rule)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            f"{cfg.name} is a pure full-attention arch: a 524288-token dense KV "
            "decode is quadratic-cost/unbounded-KV"
        )
    return True, ""
