"""Nested parameter trees (dicts, lists, tuples and named tuples of tensors
or arrays) walked in the JAX package's leaf order: a dict's values by
sorted key, a sequence's in order, ``None`` an empty subtree (as
``jax.tree_util`` flattens them).  The checkpoint's ``leaf_i`` numbering
and the optimizer's sums follow this order."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def tree_leaves(tree: Any) -> List[Any]:
    return list(_walk(tree))


def _walk(tree: Any) -> Iterator[Any]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced by ``leaves``, in order."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _rebuild(like: Any, it: Iterator[Any]) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: new[k] for k in like}  # keep the tree's own key order
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, it) for v in like]
        if isinstance(like, list):
            return items
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree has") from None


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(x) != len(leaves[0]) for x in leaves):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def structure(tree: Any) -> str:
    """A short description of the tree's nodes (the manifest's ``treedef``;
    neither package reads it back)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(structure(v) for v in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"
