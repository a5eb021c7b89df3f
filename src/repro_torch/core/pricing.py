"""Cloud pricing catalogs (the paper's cost-model inputs).

The storage tiers are the paper's AWS catalog (EBS io2 at $0.125/GB-month
with 4 GB/s provisioned throughput [paper §2], plus the beyond-paper tiers).
The compute price is the port's own target: one NVIDIA H100 SXM
(``h100_pricing``).

All prices are USD; times are hours unless suffixed ``_s``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

HOURS_PER_MONTH = 730.0
# Cloud pricing uses decimal GB (the paper: a 10K-token Llama-7B context =
# 2*32*32*128*10240*2 B = 5.24e9 B, quoted as "5.2 GB").
GB = 1e9


@dataclasses.dataclass(frozen=True)
class StorageTier:
    """A storage service a KV cache can live in."""

    name: str
    cost_per_gb_month: float
    read_bw_gbps: float  # sustained GB/s available to one reader
    write_bw_gbps: float
    latency_s: float  # first-byte latency
    # Fee to provision extra throughput above the baseline (the paper's
    # C_transmission knob); $/ (GB/s) / hour.  0 for locally mounted EBS at
    # the paper's (infrequent) IO rates.
    provisioned_bw_cost_per_gbps_hour: float = 0.0
    per_gb_transfer_fee: float = 0.0  # e.g. S3 egress-like fees

    @property
    def cost_per_gb_hour(self) -> float:
        return self.cost_per_gb_month / HOURS_PER_MONTH


@dataclasses.dataclass(frozen=True)
class ComputePrice:
    name: str
    cost_per_device_hour: float
    devices: int  # devices in the serving instance

    @property
    def cost_per_hour(self) -> float:
        return self.cost_per_device_hour * self.devices


@dataclasses.dataclass(frozen=True)
class Pricing:
    compute: ComputePrice
    tiers: Dict[str, StorageTier]
    default_tier: str = "io2"

    def tier(self, name: Optional[str] = None) -> StorageTier:
        return self.tiers[name or self.default_tier]


# --------------------------------------------------------------------------- #
# The paper's catalog (AWS, 2024 pricing as cited)
# --------------------------------------------------------------------------- #
IO2 = StorageTier(
    name="io2",
    cost_per_gb_month=0.125,  # [Amazon EBS pricing, paper ref 1]
    read_bw_gbps=4.0,  # io2 Block Express, highest tier (paper §2)
    write_bw_gbps=4.0,
    latency_s=0.001,
)
GP3 = StorageTier(
    name="gp3",
    cost_per_gb_month=0.08,
    read_bw_gbps=1.0,
    write_bw_gbps=1.0,
    latency_s=0.002,
    provisioned_bw_cost_per_gbps_hour=0.040 / HOURS_PER_MONTH * 1024,  # $0.040/MBps-month
)
S3_STANDARD = StorageTier(
    name="s3",
    cost_per_gb_month=0.023,
    read_bw_gbps=0.78,  # ~100 Gbit instance NIC shared, conservative single-stream
    write_bw_gbps=0.78,
    latency_s=0.05,
    per_gb_transfer_fee=0.0,  # same-region
)
HOST_DRAM = StorageTier(
    # Host memory of the serving instance itself: priced as the marginal
    # DRAM cost share; effectively PCIe-bandwidth "storage" (beyond-paper tier).
    name="host_dram",
    cost_per_gb_month=2.0,
    read_bw_gbps=32.0,  # PCIe gen4 x16 effective
    write_bw_gbps=32.0,
    latency_s=1e-5,
)
LOCAL_NVME = StorageTier(
    # Instance-store NVMe (i4i-class): bundled with the instance, priced at
    # the marginal $/GB share of the instance-store premium.  The hierarchy's
    # spill tier between host DRAM and provisioned cloud block storage.
    name="local_nvme",
    cost_per_gb_month=0.054,
    read_bw_gbps=7.0,
    write_bw_gbps=5.0,
    latency_s=1e-4,
)
PEER_DRAM = StorageTier(
    # DRAM of a peer serving instance reached over the datacenter network
    # (the "Can I Buy Your KV Cache?" setting): DRAM-priced capacity behind a
    # 100 GbE NIC; RpcBackend adds per-call RPC round trips on top.
    name="peer_dram",
    cost_per_gb_month=2.0,
    read_bw_gbps=12.5,
    write_bw_gbps=12.5,
    latency_s=2e-4,
)

_ALL_TIERS = {
    "io2": IO2, "gp3": GP3, "s3": S3_STANDARD, "host_dram": HOST_DRAM,
    "local_nvme": LOCAL_NVME, "peer_dram": PEER_DRAM,
}


# --------------------------------------------------------------------------- #
# NVIDIA H100 catalog (the port's target platform)
# --------------------------------------------------------------------------- #
# AWS EC2 on-demand list price of p5.48xlarge (8x H100 SXM 80 GB), us-east-1,
# 2024: $98.32/h, i.e. $12.29 per GPU-hour.
H100_COST_PER_DEVICE_HOUR = 98.32 / 8


def h100_pricing(gpus: int = 1) -> Pricing:
    """``gpus`` H100s billed at the p5 per-GPU rate, over the paper's tiers."""
    return Pricing(
        compute=ComputePrice(
            name=f"H100-SXM-{gpus}", cost_per_device_hour=H100_COST_PER_DEVICE_HOUR,
            devices=gpus,
        ),
        tiers=dict(_ALL_TIERS),
        default_tier="io2",
    )
