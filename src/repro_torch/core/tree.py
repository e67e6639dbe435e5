"""Nested-dict parameter trees in the reference's flatten order.

JAX flattens a dict by sorted keys, so leaf order here is sorted-key
depth-first order; arena words, parity tables and fault streams depend on
it.  A tree is a dict whose values are trees or leaves (tensors, arrays or
`Spec`s)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

__all__ = ["paths", "leaves", "unflatten", "map_tree"]

Path = Tuple[str, ...]


def _walk(tree: Any, prefix: Path) -> Iterator[Tuple[Path, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def paths(tree: Any) -> List[Path]:
    return [p for p, _ in _walk(tree, ())]


def leaves(tree: Any) -> List[Any]:
    return [x for _, x in _walk(tree, ())]


def unflatten(tree_paths: Sequence[Path], values: Sequence[Any]) -> Any:
    """Rebuild the nested dict from `paths` order and leaf values."""
    if len(tree_paths) == 1 and tree_paths[0] == ():
        return values[0]
    out: dict = {}
    for path, v in zip(tree_paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def map_tree(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply `fn` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
