"""Argument checks shared by the CUDA kernel wrappers (the kernels take only
contiguous, 16-byte-aligned CUDA tensors of the types they were built for),
and the split scratch of the attention kernels that split their kv tiles."""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.kernels.build import DTYPE_CODES

MAX_HEAD_DIM = 256  # every kernel takes any head_dim in [1, MAX_HEAD_DIM]


def require(cond: bool, kernel: str, what: Union[str, Callable[[], str]]) -> None:
    """Raise ``ValueError`` unless ``cond``; ``what`` (or what it returns,
    formatted only on failure) says why."""
    if not cond:
        raise ValueError(f"{kernel}: {what() if callable(what) else what}")


_DTYPES = {getattr(torch, name): code for name, code in DTYPE_CODES.items()}


def dtype_code(kernel: str, t: torch.Tensor) -> int:
    code = _DTYPES.get(t.dtype)
    require(code is not None, kernel, lambda: f"dtype {t.dtype} not supported (float32, bfloat16)")
    return code


def cuda_operands(kernel: str, device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        require(t.device == device, kernel, lambda: f"{name} is on {t.device}, expected {device}")
        require(t.is_contiguous(), kernel, lambda: f"{name} must be contiguous")
        require(t.data_ptr() % 16 == 0, kernel, lambda: f"{name} must be 16-byte aligned")


def int32(kernel: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        require(t.dtype == torch.int32, kernel, lambda: f"{name} must be int32, got {t.dtype}")


def split_scratch(splits: int, out: torch.Tensor):
    """The f32 scratch of a launch that splits its kv tiles into ``splits``
    parts across blocks, as one buffer and the addresses of its two
    parts: the partial (m, l) pairs ``[splits, *out.shape[:-1], 2]`` and,
    16-byte aligned after them, the partial accumulators ``[splits,
    *out.shape]``.  ``(None, 0, 0)`` when ``splits`` is 1.  The caller keeps
    the buffer until the launch is enqueued; the caching allocator then
    reuses its memory only in stream order."""
    if splits <= 1:
        return None, 0, 0
    rows = splits * out.numel() // out.shape[-1]
    acc_at = -(-2 * rows // 4) * 4  # floats before the accumulators
    buf = torch.empty(acc_at + splits * out.numel(), dtype=torch.float32, device=out.device)
    return buf, buf.data_ptr() + 4 * acc_at, buf.data_ptr()
