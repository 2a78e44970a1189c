"""Nested dict/list/tuple trees of tensors, walked in ``jax.tree_util``'s
order (dict keys sorted, ``None`` an empty subtree): the order in which
the JAX package flattens a parameter tree, so the optimizer's leaves, the
compression's leaves and a checkpoint's keys line up with the
reference's. A leaf's path is a tuple of ``k=<dict key>`` and
``i=<index>`` parts: the checkpoint's key parts."""
from __future__ import annotations


def walk(tree, path=()):
    """(path, leaf) pairs of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (f"k={k}",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from walk(x, path + (f"i={i}",))
    else:
        yield path, tree


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return [x for _, x in walk(tree)]


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, keeping the structure: ``jax.tree_util.tree_map_with_path``
    with the paths ``walk`` gives."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (f"k={k}",))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, *(r[i] for r in rest),
                                             path=path + (f"i={i}",))
                          for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure: ``jax.tree.map``."""
    return tree_map_with_path(lambda _p, *x: fn(*x), tree, *rest)


def unflatten(tree, flat):
    """A tree shaped like ``tree`` holding ``flat`` (``leaves`` order)."""
    it = iter(flat)
    out = tree_map(lambda _x: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
