"""Byte accounting for stored context-state trees.

The port carries only ``tree_nbytes`` over host (numpy) artifacts, which the
tiered store bills storage and transfer by.  The int8 storage tier
(``compress_tree`` / ``decompress_tree`` over the ``kv_quant`` kernels) is
ROADMAP queue A item 3; until it lands, both raise, and so does
``EngineConfig(compress_tier=...)``.
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np


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


def tree_nbytes(tree: Any) -> int:
    return int(sum(np.asarray(leaf).nbytes for leaf in tree_leaves(tree)))


def compress_tree(tree: Any) -> Any:
    raise NotImplementedError(
        "the int8 storage tier is not ported yet (ROADMAP queue A item 3)"
    )


def decompress_tree(tree: Any) -> Any:
    raise NotImplementedError(
        "the int8 storage tier is not ported yet (ROADMAP queue A item 3)"
    )
