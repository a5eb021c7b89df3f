"""Analytical performance model: T_prefill / T_decode / KV-load times.

The paper treats T_prefill(L) and T_decode(L) as measured black boxes; to make
the cost model predictive for arbitrary (arch, hardware) pairs we derive them
from a two-term roofline:

  t = max( FLOPs / (devices * peak_flops * mfu),
           bytes  / (devices * hbm_bw   * membw_eff) )

The port's default hardware is one H100 (``h100``); the paper's own machine
is ``V100_X4_HF`` (the launcher's ``--platform paper``), with ``V100_X4``
and ``V100_X1_PAPER`` beside it for the simulator's comparisons, and a
caller that needs another passes its own ``HardwareSpec``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pricing import GB, StorageTier


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    devices: int
    peak_flops: float  # per device, FLOP/s at serving dtype
    hbm_bw: float  # per device, bytes/s
    hbm_bytes: float  # per device
    link_bw: float  # per-device interconnect, bytes/s (ICI/NVLink)
    host_read_bw: float = 32 * GB  # PCIe to one host
    hosts: int = 1  # hosts the instance spans (parallel storage mounts)
    mfu: float = 0.40  # achievable fraction of peak in prefill/training
    membw_eff: float = 0.70  # achievable fraction of HBM bandwidth in decode


def h100(gpus: int = 1) -> HardwareSpec:
    """NVIDIA H100 SXM 80 GB, from NVIDIA's H100 data sheet: 989 TFLOP/s
    dense bf16, 3.35 TB/s HBM3, 80 GB, NVLink 900 GB/s total (450 GB/s each
    way), PCIe Gen5 x16 (64 GB/s each way) to the host.  ``mfu`` and
    ``membw_eff`` are this model's assumptions, not measurements."""
    return HardwareSpec(
        name=f"H100-SXM-{gpus}",
        devices=gpus,
        peak_flops=989e12,
        hbm_bw=3.35e12,
        hbm_bytes=80 * GB,
        link_bw=450e9,
        host_read_bw=64 * GB,
        hosts=1,
        mfu=0.40,
        membw_eff=0.70,
    )


# A p3.8xlarge's 4x V100 16 GB at this model's default efficiencies (NVIDIA's
# V100 data sheet: 125 TFLOP/s fp16 tensor core, 900 GB/s HBM2, 150 GB/s
# NVLink).
V100_X4 = HardwareSpec(
    name="V100x4",
    devices=4,
    peak_flops=125e12,  # fp16 tensor core peak
    hbm_bw=900e9,
    hbm_bytes=16 * GB,
    link_bw=150e9,  # NVLink
    hosts=1,
    mfu=0.40,
    membw_eff=0.70,
)

# One V100 of the paper's pipeline, calibrated like ``V100_X4_HF`` below
# (mfu 0.18 puts T_prefill(10K) at the ~7 s of the paper's footnote 2).
V100_X1_PAPER = HardwareSpec(
    name="V100x1-HF",
    devices=1,
    peak_flops=125e12,
    hbm_bw=900e9,
    hbm_bytes=16 * GB,
    link_bw=150e9,
    hosts=1,
    mfu=0.18,
    membw_eff=0.45,
)

# The paper's measured pipeline: Llama-7B under HuggingFace *naive* model
# parallelism on a p3.8xlarge (4x V100 16 GB, NVIDIA's V100 data sheet: 125
# TFLOP/s fp16 tensor core, 900 GB/s HBM2, 150 GB/s NVLink) — layers are
# spread across the 4 GPUs and run sequentially, so throughput ~= one V100 at
# low utilisation while the whole instance is billed.  mfu=0.18 calibrates
# T_prefill(10K) to the ~7 s implied by the paper's footnote 2 ($3/h / 3600
# * T = $0.0058 => T ~= 7 s); the effective per-instance mfu is 0.18/4
# because only one of the 4 billed GPUs computes at a time.  The launcher's
# ``--platform paper`` models this machine.
V100_X4_HF = HardwareSpec(
    name="V100x4-HF-MP",
    devices=4,
    peak_flops=125e12,
    hbm_bw=900e9,
    hbm_bytes=16 * GB,
    link_bw=150e9,
    hosts=1,
    mfu=0.18 / 4,  # sequential layer placement: 1-of-4 GPUs active
    membw_eff=0.45 / 4,
)


@dataclasses.dataclass(frozen=True)
class PerfModel:
    hw: HardwareSpec

    # ----------------------------------------------------------------- #
    # FLOP / byte accounting
    # ----------------------------------------------------------------- #
    def prefill_flops(self, cfg: ArchConfig, L: int) -> float:
        """2*N_active*L matmul FLOPs + quadratic attention score/value FLOPs
        (windowed for SWA archs)."""
        from repro_torch.models.registry import count_active_params

        n_active = count_active_params(cfg)
        flops = 2.0 * n_active * L
        # attention: 2 * (QK^T + PV) = 4 * H * hd * L * L_att per layer
        if cfg.n_attn_layers:
            l_att = min(L, cfg.sliding_window) if cfg.sliding_window else L
            flops += 4.0 * cfg.n_attn_layers * cfg.n_heads * cfg.resolved_head_dim * L * (
                l_att / 2.0 if l_att == L else l_att
            )
        return flops

    def decode_flops_per_token(self, cfg: ArchConfig, context_len: int) -> float:
        from repro_torch.models.registry import count_active_params

        flops = 2.0 * count_active_params(cfg)
        if cfg.n_attn_layers:
            l_att = (
                min(context_len, cfg.sliding_window)
                if cfg.sliding_window
                else context_len
            )
            flops += 4.0 * cfg.n_attn_layers * cfg.n_heads * cfg.resolved_head_dim * l_att
        return flops

    def decode_bytes_per_token(
        self, cfg: ArchConfig, context_len: int, dtype_bytes: int = 2
    ) -> float:
        """HBM traffic per decoded token: all active params + the KV cache."""
        from repro_torch.models.registry import count_active_params

        param_bytes = count_active_params(cfg) * dtype_bytes
        l_att = (
            min(context_len, cfg.sliding_window) if cfg.sliding_window else context_len
        )
        kv = cfg.kv_bytes_per_token(dtype_bytes) * l_att + cfg.fixed_state_bytes(dtype_bytes)
        return param_bytes + kv

    # ----------------------------------------------------------------- #
    # Times (seconds) — the paper's T_prefill / T_decode
    # ----------------------------------------------------------------- #
    def _prefill_roofline(
        self, cfg: ArchConfig, flops: float, total_tokens: int
    ) -> float:
        """max(comp, mem) for one prefill launch: parameters stream from HBM
        once per launch regardless of how many requests' tokens it carries."""
        hw = self.hw
        comp = flops / (hw.devices * hw.peak_flops * hw.mfu)
        from repro_torch.models.registry import count_active_params

        bytes_ = (
            count_active_params(cfg) * 2 + cfg.kv_bytes_per_token(2) * total_tokens
        )
        mem = bytes_ / (hw.devices * hw.hbm_bw * hw.membw_eff)
        return max(comp, mem)

    def t_prefill(self, cfg: ArchConfig, L: int, batch: int = 1) -> float:
        if L <= 0:
            return 0.0
        return self._prefill_roofline(
            cfg, self.prefill_flops(cfg, L) * batch, L * batch
        )

    def t_prefill_packed(self, cfg: ArchConfig, lens) -> float:
        """One packed ragged prefill over several requests' token runs.

        vs ``sum(t_prefill(L) for L in lens)``: FLOPs are additive (each
        segment still pays its own attention quadratic), but the roofline
        applies ONCE — parameters stream from HBM once for the whole packed
        sequence instead of once per request, and the launch takes
        max(comp, mem) of the totals rather than a sum of per-request maxes.
        Small-segment admission bursts are parameter-read-bound, so this is
        where batched admission's measured throughput win comes from.
        A single segment delegates to ``t_prefill(L)`` — exact equality is a
        contract (admit_batch=1 golden parity), not a numeric coincidence.
        """
        lens = [int(L) for L in lens if L > 0]
        if not lens:
            return 0.0
        if len(lens) == 1:
            return self.t_prefill(cfg, lens[0])
        return self._prefill_roofline(
            cfg, sum(self.prefill_flops(cfg, L) for L in lens), sum(lens)
        )

    def t_prefill_fused(self, cfg: ArchConfig, L_total: int, n_recompute: int) -> float:
        """One fused selective-recompute prefill launch (CacheBlend-style):
        reused chunk KV for ``L_total - n_recompute`` tokens is preloaded and
        only ``n_recompute`` tokens flow through the layer stack, each
        attending the full assembled buffer.

        vs ``t_prefill(L_total)``: matmul FLOPs scale with the recompute
        tokens only, attention FLOPs with ``n_recompute * L_total`` instead
        of the full quadratic, while the memory side is unchanged (parameters
        stream once, the whole assembled KV still moves through HBM) — so a
        small r turns a compute-bound long-context prefill into a
        parameter/KV-read-bound launch.  At ``n_recompute == L_total`` this
        delegates to ``t_prefill`` — exact equality is a contract (the r=1.0
        anchor's pricing analogue), not a numeric coincidence.
        """
        if L_total <= 0 or n_recompute <= 0:
            return 0.0
        n_recompute = min(int(n_recompute), int(L_total))
        if n_recompute == L_total:
            return self.t_prefill(cfg, L_total)
        from repro_torch.models.registry import count_active_params

        flops = 2.0 * count_active_params(cfg) * n_recompute
        if cfg.n_attn_layers:
            l_att = min(L_total, cfg.sliding_window) if cfg.sliding_window else L_total
            flops += 4.0 * cfg.n_attn_layers * cfg.n_heads * cfg.resolved_head_dim * (
                n_recompute * (l_att / 2.0 if l_att == L_total else l_att)
            )
        return self._prefill_roofline(cfg, flops, L_total)

    def t_decode(
        self, cfg: ArchConfig, L_out: int, context_len: int, batch: int = 1
    ) -> float:
        """Total time to emit ``L_out`` tokens (sequential steps; ``batch``
        sequences decoded together amortise the parameter reads)."""
        if L_out <= 0:
            return 0.0
        hw = self.hw
        # per step: params read once for the whole batch, KV per sequence
        from repro_torch.models.registry import count_active_params

        param_bytes = count_active_params(cfg) * 2
        l_att = (
            min(context_len, cfg.sliding_window) if cfg.sliding_window else context_len
        )
        kv_bytes = (
            cfg.kv_bytes_per_token(2) * l_att + cfg.fixed_state_bytes(2)
        ) * batch
        mem = (param_bytes + kv_bytes) / (hw.devices * hw.hbm_bw * hw.membw_eff)
        comp = (
            self.decode_flops_per_token(cfg, context_len)
            * batch
            / (hw.devices * hw.peak_flops * hw.mfu)
        )
        return L_out * max(comp, mem)

    def t_decode_paged(self, cfg: ArchConfig, lens) -> float:
        """One paged batched decode step over slots with live context lengths
        ``lens`` (the block-table layout of ``kernels/paged_decode.py``).

        vs ``t_decode(cfg, 1, max(lens), batch=n)`` — the dense slotted
        cache's pricing, where every slot is billed the longest slot's HBM
        stream: the paged kernel reads exactly each slot's live blocks, so
        the KV term prices ``sum(lens)`` and the parameter read still streams
        once per step for the whole batch.  Mixed-length batches get strictly
        cheaper; a UNIFORM batch delegates to ``t_decode`` — exact equality
        there is a contract (the dense/paged golden replay), not a numeric
        coincidence, mirroring ``t_prefill_packed``'s single-segment
        delegation.
        """
        lens = [int(L) for L in lens if L > 0]
        if not lens:
            return 0.0
        if len(set(lens)) == 1:
            return self.t_decode(cfg, 1, lens[0], batch=len(lens))
        hw = self.hw
        from repro_torch.models.registry import count_active_params

        param_bytes = count_active_params(cfg) * 2
        kv_bytes = 0.0
        comp_flops = 0.0
        for L in lens:
            l_att = min(L, cfg.sliding_window) if cfg.sliding_window else L
            kv_bytes += cfg.kv_bytes_per_token(2) * l_att + cfg.fixed_state_bytes(2)
            comp_flops += self.decode_flops_per_token(cfg, L)
        mem = (param_bytes + kv_bytes) / (hw.devices * hw.hbm_bw * hw.membw_eff)
        comp = comp_flops / (hw.devices * hw.peak_flops * hw.mfu)
        return max(comp, mem)

    def decode_kv_bytes(self, cfg: ArchConfig, L: int) -> float:
        """Per-slot HBM bytes one decode step streams for a live context of
        ``L`` tokens — the KV term of ``t_decode_paged``'s sum, so the engine
        can bill each slot of a shared step by its own live-block traffic
        instead of an equal split."""
        l_att = min(L, cfg.sliding_window) if cfg.sliding_window else L
        return cfg.kv_bytes_per_token(2) * l_att + cfg.fixed_state_bytes(2)

    def _chunk_flops(self, cfg: ArchConfig, n_new: int, L_end: int) -> float:
        """FLOPs of one prefill chunk: ``n_new`` tokens at positions
        ``[L_end - n_new, L_end)``, each attending its full causal prefix
        (the token at position p reads p+1 KV rows)."""
        from repro_torch.models.registry import count_active_params

        flops = 2.0 * count_active_params(cfg) * n_new
        if cfg.n_attn_layers:
            rows = n_new * (L_end - n_new) + n_new * (n_new + 1) / 2.0
            flops += (
                4.0 * cfg.n_attn_layers * cfg.n_heads * cfg.resolved_head_dim * rows
            )
        return flops

    def t_step_unified(self, cfg: ArchConfig, decode_lens, chunks) -> float:
        """One unified continuous-batching step: decode rows with live
        context lengths ``decode_lens`` and prefill chunks ``chunks`` (each
        ``(n_new, L_end)``: ``n_new`` tokens ending at total length
        ``L_end``) in one launch over the block pool
        (``kernels/chunked_prefill.py``).

        FLOPs and KV bytes add up across rows; the parameters stream from
        HBM once for the whole launch.  With no chunks this delegates to
        ``t_decode_paged``: the unified engine's decode-only steps price
        exactly as the paged path's, the golden-parity anchor.
        """
        decode_lens = [int(L) for L in decode_lens if L > 0]
        chunks = [(int(n), int(L)) for n, L in chunks if n > 0]
        if not chunks:
            return self.t_decode_paged(cfg, decode_lens)
        hw = self.hw
        from repro_torch.models.registry import count_active_params

        param_bytes = count_active_params(cfg) * 2
        flops = 0.0
        kv_bytes = 0.0
        for L in decode_lens:
            flops += self.decode_flops_per_token(cfg, L)
            kv_bytes += self.decode_kv_bytes(cfg, L)
        for n, L_end in chunks:
            flops += self._chunk_flops(cfg, n, L_end)
            kv_bytes += cfg.kv_bytes_per_token(2) * L_end
        mem = (param_bytes + kv_bytes) / (hw.devices * hw.hbm_bw * hw.membw_eff)
        comp = flops / (hw.devices * hw.peak_flops * hw.mfu)
        return max(comp, mem)

    def step_unified_shares(self, cfg: ArchConfig, decode_lens, chunks):
        """Per-row shares of one unified step's cost: each row's standalone
        launch cost under the same roofline, normalised.  Returns
        ``(decode_shares, chunk_shares)`` aligned with the inputs; they sum
        to 1, so billing ``share * step_s`` per row conserves the launch's
        dollars exactly."""
        w_dec = [self.t_decode(cfg, 1, int(L), batch=1) for L in decode_lens]
        hw = self.hw
        from repro_torch.models.registry import count_active_params

        param_bytes = count_active_params(cfg) * 2
        w_chk = []
        for n, L_end in chunks:
            comp = self._chunk_flops(cfg, int(n), int(L_end)) / (
                hw.devices * hw.peak_flops * hw.mfu
            )
            mem = (param_bytes + cfg.kv_bytes_per_token(2) * int(L_end)) / (
                hw.devices * hw.hbm_bw * hw.membw_eff
            )
            w_chk.append(max(comp, mem))
        total = sum(w_dec) + sum(w_chk)
        if total <= 0.0:
            n = max(len(w_dec) + len(w_chk), 1)
            return [1.0 / n] * len(w_dec), [1.0 / n] * len(w_chk)
        return [w / total for w in w_dec], [w / total for w in w_chk]

    # ----------------------------------------------------------------- #
    # KV movement (the paper's transmission delay)
    # ----------------------------------------------------------------- #
    def kv_load_time(self, nbytes: float, tier: StorageTier) -> float:
        """Storage -> host -> device, per-host-parallel mounts (DESIGN.md §3)."""
        storage = nbytes / (tier.read_bw_gbps * GB * self.hw.hosts)
        pcie = nbytes / (self.hw.host_read_bw * self.hw.hosts)
        return tier.latency_s + storage + pcie

    def kv_store_time(self, nbytes: float, tier: StorageTier) -> float:
        storage = nbytes / (tier.write_bw_gbps * GB * self.hw.hosts)
        pcie = nbytes / (self.hw.host_read_bw * self.hw.hosts)
        return tier.latency_s + storage + pcie
