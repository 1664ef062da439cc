"""Trees of tensors in JAX's leaf order.

The reference keeps parameters, optimizer state and wire payloads as JAX
pytrees, and several protocol facts are defined by the *position* of a leaf
in ``jax.tree.leaves`` order: error-feedback residuals are keyed by leaf
index (``repro/core/transport.py``), and the pruned first-layer weight
gradients are shipped as ``{leaf_index: grad}`` (``repro/core/node.py``).
So the port flattens in exactly that order:

* dict keys are sorted; tuples and lists go in order;
* ``None`` is an empty subtree, not a leaf;
* anything else (a tensor, a number, a dataclass) is a leaf.

``torch.utils._pytree`` keeps dict insertion order, which differs.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


class _Leaf:
    """Placeholder for one leaf inside a tree definition."""

    def __repr__(self):
        return "*"


LEAF = _Leaf()


def _flatten(tree, leaves: List[Any]):
    if tree is None:
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        return (type(tree), None,
                tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return LEAF


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in JAX's order; ``tree_unflatten(treedef,
    leaves)`` rebuilds the tree (dicts with sorted keys)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node is LEAF:
            return next(it)
        kind, keys, children = node
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        return kind(build(c) for c in children)

    out = build(treedef)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and every tree of
    ``rest``, which must have the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
