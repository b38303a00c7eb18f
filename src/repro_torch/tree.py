"""Trees of tensors as the JAX package's ``jax.tree`` sees them.

The port keeps the JAX package's state trees: nested dicts, lists and tuples
with tensors (or numpy arrays) at the leaves.  These helpers visit the
leaves in JAX's order: dict keys sorted, sequences in order, and ``None`` an
empty subtree that holds no leaf.  That order is the one
:func:`repro_torch.store.delta.flatten_payload` gives the store's path keys.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _walk(tree: Any, path: Tuple[str, ...]) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in _walk(tree, ())]


def tree_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``('/'-joined path, leaf)`` of every leaf, in JAX's order; the paths
    are the store's keys."""
    return [("/".join(p), leaf) for p, leaf in _walk(tree, ())]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    """A tree of ``structure``'s shape holding ``leaves`` (in JAX's order)."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(structure)
