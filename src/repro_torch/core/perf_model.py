"""Analytical performance model: T_prefill / T_decode / KV-load times.

The paper treats T_prefill(L) and T_decode(L) as measured black boxes; to make
the cost model predictive for arbitrary (arch, hardware) pairs we derive them
from a two-term roofline:

  t = max( FLOPs / (devices * peak_flops * mfu),
           bytes  / (devices * hbm_bw   * membw_eff) )

The port's default hardware is one H100 (``h100``); a caller that needs
another machine passes its own ``HardwareSpec``.
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
