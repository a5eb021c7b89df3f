"""KV-cache compression for the storage/transfer tier (int8, per-(token,head)),
and the byte accounting of stored context-state trees.

The paper names KV compression as open design space; the reference
implements one point, ported here: symmetric int8 over the channel axis
(2x smaller stored KV => 2x cheaper storage and 2x faster loads), through
the ``kv_quant`` / ``kv_dequant`` kernels (``kernels/kv_quant.py``).  A leaf
is quantised where it lies: a device tensor by the CUDA kernel, so only the
int8 rows and their scales cross to the host; a host array by the plain
version.  Decompression runs on the device it is given and returns that
device's form.

The port keeps bf16 on the host as its ``uint16`` bit pattern
(``paged.to_host``), so a KV leaf is a floating tensor or array of ndim >= 2
*or* a ``uint16`` host array of ndim >= 2; ``orig_dtype`` is the reference's
string (``"bfloat16"``, ``"float32"``).  Small int leaves (``pos``) pass
through.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kvcache.paged import to_host
from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class CompressedArray:
    q: np.ndarray  # int8 [..., hd]
    scale: np.ndarray  # f32   [..., 1]
    orig_dtype: str

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes


def tree_leaves(tree: Any) -> Iterator[Any]:
    """Leaves of a tuple/list/dict/NamedTuple tree, ``None`` skipped — the
    same leaf order as ``jax.tree_util.tree_leaves`` on these containers."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tree_leaves(x)
    else:
        yield tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, keeping its containers (and
    NamedTuple types); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def _is_kv_leaf(x) -> bool:
    # KV tensors are >=2D floating arrays (bf16 on the host as uint16); tiny
    # int/pos leaves pass through.
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and x.dim() >= 2
    if not hasattr(x, "dtype") or np.ndim(x) < 2:
        return False
    return np.issubdtype(x.dtype, np.floating) or x.dtype == np.uint16


def _as_tensor(x) -> torch.Tensor:
    """A KV leaf as a contiguous tensor where it lies (a host uint16 array as
    its bf16 pattern)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf_nbytes(x) -> int:
    return x.nbytes if isinstance(x, CompressedArray) else np.asarray(x).nbytes


def compress_tree(tree: Any) -> Any:
    """Quantise every KV-like leaf of a context-state tree to int8; the
    result lives on the host (``CompressedArray`` leaves of numpy arrays)."""

    def leaf(x):
        if not _is_kv_leaf(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        t = _as_tensor(x)
        q, s = ops.kv_quant(t)
        return CompressedArray(
            q=q.cpu().numpy(), scale=s.cpu().numpy(),
            orig_dtype=str(t.dtype).removeprefix("torch."),
        )

    return tree_map(leaf, tree)


def decompress_tree(tree: Any, device=None) -> Any:
    """Dequantise every ``CompressedArray`` leaf on ``device`` (the card
    unless the caller asks for another): device tensors of the original
    dtype on the card, host arrays on the CPU (bf16 as its ``uint16``
    pattern), as the leaf was stored."""
    dev = resolve_device(device)

    def leaf(x):
        if not isinstance(x, CompressedArray):
            return x
        out = ops.kv_dequant(
            torch.from_numpy(x.q).to(dev), torch.from_numpy(x.scale).to(dev),
            getattr(torch, x.orig_dtype),
        )
        return out if out.is_cuda else to_host(out)

    return tree_map(leaf, tree)


def to_host_tree(tree: Any) -> Any:
    """A tree with every tensor leaf copied to the host (``paged.to_host``)."""
    return tree_map(lambda x: to_host(x) if isinstance(x, torch.Tensor) else x, tree)


def tree_nbytes(tree: Any) -> int:
    return int(sum(_leaf_nbytes(leaf) for leaf in tree_leaves(tree)))


def max_abs_error_bound(x: torch.Tensor) -> torch.Tensor:
    """Per-row worst-case quantisation error: scale/2 (tested property)."""
    _, s = ops.kv_quant(x)
    return (s / 2.0)[..., 0]
