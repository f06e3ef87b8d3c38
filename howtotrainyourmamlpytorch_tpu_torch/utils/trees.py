"""Helpers over dict trees: nested ``dict``s with tensor leaves.

The JAX package holds parameters as pytrees, and ``jax.tree`` flattens a
dict by sorted keys. Every helper here walks in that same order, so a leaf's
position in a flattened port tree (its place in the fused update's leaf
table, the order of a per-tensor lr vector) is its position in the JAX
package's flattened tree. An empty dict is a subtree with no leaves; any
value that is not a dict is a leaf.
"""

from typing import Any, Callable, Iterator, List, Tuple

import torch

Path = Tuple[str, ...]


def _walk(tree, prefix: Path) -> Iterator[Tuple[Path, Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def tree_flatten(tree) -> Tuple[List[Any], List[Path]]:
    """-> (leaves, key paths), both in sorted-key (JAX) order."""
    pairs = list(_walk(tree, ()))
    return [leaf for _, leaf in pairs], [path for path, _ in pairs]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, ())]


def tree_unflatten(paths: List[Path], leaves: List[Any]):
    """Inverse of :func:`tree_flatten` (empty subtrees are not restored)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest`` (looked up by key,
    so the other trees may hold their keys in any insertion order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_scalars_like(tree, value: float, dtype=torch.float32, device=None):
    """A tree of ``tree``'s structure whose leaves are 0-d tensors: one
    learnable per-tensor hyperparameter per leaf (LSLR; reference
    ``few_shot_learning_system.py:94-107``)."""
    return tree_map(
        lambda p: torch.tensor(value, dtype=dtype, device=device if device is not None else p.device),
        tree,
    )
