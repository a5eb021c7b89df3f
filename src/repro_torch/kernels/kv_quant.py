"""Int8 KV quantisation and dequantisation: the CUDA kernels and their plain
versions.

The port's counterparts of the Pallas kernels ``kv_quant`` and
``kv_dequant`` (``src/repro/kernels/kv_quant.py``), the int8 storage tier's
hot path: symmetric per-row int8 over the trailing channel axis (head_dim),
one f32 scale per row.  The kernels are ``csrc/kv_quant.cu`` and
``csrc/kv_dequant.cu`` (their headers say what bounds them and how their
design answers that); ``kv_quant_plain`` and ``kv_dequant_plain`` are the
same functions in plain PyTorch, and the kernels give their bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._checks import dtype_code, require

QUANT, DEQUANT = "kv_quant", "kv_dequant"


def kv_quant_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (``ref.kv_quant_ref``)."""
    return ref.kv_quant_ref(x)


def kv_dequant_plain(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``ref.kv_dequant_ref``)."""
    return ref.kv_dequant_ref(q, scale, dtype)


def _rows(t: torch.Tensor, kernel: str) -> Tuple[int, int]:
    require(t.dim() >= 1 and t.shape[-1] >= 1, kernel, f"shape {tuple(t.shape)} has no channels")
    hd = t.shape[-1]
    return t.numel() // hd, hd


def kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., hd]`` (f32 or bf16, contiguous, on the card) -> ``(q int8
    [..., hd], scale f32 [..., 1])``.  Launches the CUDA kernel; raises on
    anything it does not take (there is no fallback)."""
    require(x.is_cuda, QUANT, "x must be a CUDA tensor")
    require(x.is_contiguous(), QUANT, "x must be contiguous")
    code = dtype_code(QUANT, x)
    rows, hd = _rows(x, QUANT)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(tuple(x.shape[:-1]) + (1,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    launch = build.launcher(QUANT)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = launch(x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, hd, code, stream)
    build.check(status, QUANT)
    kv_quant.launches += 1
    return q, scale


def kv_dequant(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """``q int8 [..., hd]`` and ``scale f32 [..., 1]`` (contiguous, on the
    card) -> ``q * scale`` as ``dtype`` (f32 or bf16).  Launches the CUDA
    kernel; raises on anything it does not take (there is no fallback)."""
    require(q.is_cuda, DEQUANT, "q must be a CUDA tensor")
    require(q.dtype == torch.int8 and scale.dtype == torch.float32, DEQUANT,
            f"q must be int8 and scale float32, got {q.dtype} and {scale.dtype}")
    require(scale.shape == tuple(q.shape[:-1]) + (1,), DEQUANT,
            f"scale shape {tuple(scale.shape)} does not match q {tuple(q.shape)}")
    require(scale.device == q.device, DEQUANT, f"scale is on {scale.device}, q on {q.device}")
    require(q.is_contiguous() and scale.is_contiguous(), DEQUANT, "q and scale must be contiguous")
    rows, hd = _rows(q, DEQUANT)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    code = dtype_code(DEQUANT, out)
    if rows == 0:
        return out
    launch = build.launcher(DEQUANT)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, hd, code, stream)
    build.check(status, DEQUANT)
    kv_dequant.launches += 1
    return out


kv_quant.launches = 0
kv_dequant.launches = 0
