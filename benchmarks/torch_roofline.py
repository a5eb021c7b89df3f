"""Roofline terms of the port's dry-run records (the counterpart of
``benchmarks/roofline.py``, over ``artifacts/dryrun_torch/``).

Per (arch x shape x mesh) cell, from the record's per-device numbers
(``repro_torch.launch.dryrun``):

  compute_term    = flops / peak FLOP/s
  memory_term     = bytes_accessed / HBM rate
  collective_term = collective bytes / link rate

with one H100 SXM's data-sheet figures (``core.perf_model.h100``: 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink each way).  It also
reports ``model_flops`` (6·N_active·D for a train step, 2·N_active·D for
prefill and decode, ``registry.count_active_params``), the usefulness ratio
``model_flops / (flops x devices)`` and the roofline fraction
``(model_flops / devices / peak) / dominant term``.  No depth calibration:
the port's records count every layer (see the dry run's docstring).  The
collective term covers only what the port runs, every collective in the
record's ``total``: the model and pod groups' bytes of a dense ``dp`` arch's
train cell are part of it (``model_tensor_parallel`` and
``pod_gradient_sync`` break them out); a record's null entries (the other
families' train cells, tensor-parallel prefill and decode: ROADMAP A11d-2
and tensor-parallel serving) add nothing.

    PYTHONPATH=src python -m benchmarks.torch_roofline [--mesh pod16x16] [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.perf_model import h100
from repro_torch.launch.dryrun import ARTIFACT_DIR
from repro_torch.models.registry import count_active_params

HW = h100()
DEVICES = {"pod16x16": 256, "pod2x16x16": 512}


def model_flops(arch: str, shape_name: str) -> float:
    """Ideal model FLOPs of the whole step (all devices)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = count_active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * (
            cfg.decoder_seq_len if cfg.family == "encdec" else shape.seq_len)
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * (
            shape.seq_len if cfg.family != "encdec" else shape.seq_len + cfg.decoder_seq_len)
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def collective_bytes(rec: dict) -> float:
    """The record's measured collective bytes (its null entries, collectives
    the port does not run, count nothing)."""
    return float(rec["collectives"]["total"])


def analyze_cell(rec: dict, devices: int) -> Optional[dict]:
    if not rec.get("ok"):
        return None
    flops_dev, bytes_dev = rec["flops"], rec["bytes_accessed"]
    terms = {"compute": flops_dev / HW.peak_flops, "memory": bytes_dev / HW.hbm_bw,
             "collective": collective_bytes(rec) / HW.link_bw}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    dominant = max(terms.values())
    mem = rec["memory"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"], "kind": rec["kind"],
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"], "bottleneck": bottleneck,
        "model_flops": mf, "flops_total": flops_dev * devices,
        "useful_ratio": mf / max(flops_dev * devices, 1e-30),
        "roofline_fraction": mf / devices / HW.peak_flops / max(dominant, 1e-30),
        "device_bytes": mem["argument_bytes"] + mem["temp_bytes"],
        "fits": mem["argument_bytes"] + mem["temp_bytes"] <= HW.hbm_bytes,
        "not_run": sorted(k for k, v in rec["collectives"].items() if v is None),
        "collective_mix": {k: v for k, v in rec["collectives"].items() if k != "total" and v},
    }


def load_all(mesh: str = "pod16x16", art: Path = ARTIFACT_DIR) -> List[dict]:
    out = []
    for f in sorted(Path(art).glob(f"*__{mesh}.json")):
        cell = analyze_cell(json.loads(f.read_text()), DEVICES[mesh])
        if cell:
            out.append(cell)
    return out


def markdown_table(cells: List[dict]) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | bottleneck | "
            "useful FLOP ratio | roofline frac | GB a device | fits 80 GB |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['compute_s']:.3e} | {c['memory_s']:.3e} | "
            f"{c['collective_s']:.3e} | {c['bottleneck']} | {c['useful_ratio']:.2f} | "
            f"{c['roofline_fraction']:.3f} | {c['device_bytes'] / 1e9:.1f} | "
            f"{'yes' if c['fits'] else 'no'} |")
    return "\n".join(rows)


def run(art: Path = ARTIFACT_DIR) -> List[str]:
    """CSV lines, one a cell of one pod: the dominant term in microseconds,
    the roofline fraction and the bottleneck."""
    lines = []
    for c in load_all("pod16x16", art):
        us = max(c["compute_s"], c["memory_s"], c["collective_s"]) * 1e6
        lines.append(f"torch-roofline/{c['arch']}/{c['shape']},{us:.2f},"
                     f"frac={c['roofline_fraction']:.3f};bottleneck={c['bottleneck']}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="roofline terms of the port's dry-run records")
    ap.add_argument("--mesh", default="pod16x16", choices=sorted(DEVICES))
    ap.add_argument("--dir", default=str(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    cells = load_all(args.mesh, Path(args.dir))
    print(markdown_table(cells))
    worst = sorted(cells, key=lambda c: c["roofline_fraction"])[:5]
    print("\nworst roofline fractions:")
    for c in worst:
        print(f"  {c['arch']} {c['shape']}: {c['roofline_fraction']:.3f} ({c['bottleneck']})")
    over = [c for c in cells if not c["fits"]]
    print(f"cells over {HW.hbm_bytes / 1e9:.0f} GB a device: {len(over)}")
    for c in over:
        print(f"  {c['arch']} {c['shape']}: {c['device_bytes'] / 1e9:.1f} GB")


if __name__ == "__main__":
    main()
