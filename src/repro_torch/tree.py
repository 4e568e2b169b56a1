"""Nested dicts of tensors (the port's parameter and state trees), walked
in JAX's order.

``jax.tree_util`` flattens a dict by its keys in sorted order, depth
first. The reference's global norm sums its leaves in that order and its
checkpoints name them by their paths in it (``params/layers/attn/wq``),
so the port walks its trees the same way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def flatten(tree: Dict[str, Any], prefix: Path = ()
            ) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs: dict keys sorted, depth first."""
    out: List[Tuple[Path, Any]] = []
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            out.extend(flatten(node, prefix + (key,)))
        else:
            out.append((prefix + (key,), node))
    return out


def leaves(tree: Dict[str, Any]) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(pairs) -> Dict[str, Any]:
    """The tree of (path, leaf) pairs (the inverse of :func:`flatten`)."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def map_leaves(fn: Callable[..., Any], tree: Dict[str, Any],
               *rest: Dict[str, Any]) -> Dict[str, Any]:
    """``fn`` over the leaves of `tree` and of trees of the same shape."""
    return {k: (map_leaves(fn, v, *(r[k] for r in rest))
                if isinstance(v, dict) else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}
