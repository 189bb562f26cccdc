"""Nested dicts of tensors as the port's pytrees: the few ``jax.tree``
operations the port needs, with dict keys taken in sorted order as
``jax.tree.leaves`` takes them, so leaf numbering (checkpoint keys,
spill-record checksums) is the JAX package's."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order, as ``jax.tree.leaves`` flattens dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves):
    """Nested dicts shaped like ``template`` holding ``leaves`` in the
    order ``tree_leaves(template)`` lists them."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_leaves_with_path(tree, path=()) -> list:
    """(path tuple, leaf) pairs in ``tree_leaves`` order; lists and
    tuples are walked by index, as ``jax.tree_util`` walks them."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]
