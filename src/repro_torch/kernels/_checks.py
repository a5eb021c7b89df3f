"""Argument checks shared by the CUDA kernel wrappers: the kernels take only
contiguous, 16-byte-aligned CUDA tensors of the types they were built for."""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES

HEAD_DIMS = (32, 64, 128, 256)


def require(cond: bool, kernel: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {what}")


def dtype_code(kernel: str, t: torch.Tensor) -> int:
    name = str(t.dtype).removeprefix("torch.")
    require(name in DTYPE_CODES, kernel, f"dtype {t.dtype} not supported (float32, bfloat16)")
    return DTYPE_CODES[name]


def cuda_operands(kernel: str, device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        require(t.device == device, kernel, f"{name} is on {t.device}, expected {device}")
        require(t.is_contiguous(), kernel, f"{name} must be contiguous")
        require(t.data_ptr() % 16 == 0, kernel, f"{name} must be 16-byte aligned")


def int32(kernel: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        require(t.dtype == torch.int32, kernel, f"{name} must be int32, got {t.dtype}")
