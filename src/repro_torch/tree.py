"""Nested dicts of tensors as trees: the port's counterpart of ``jax.tree``
for the LM's parameter, gradient and optimizer-moment trees.

Leaves are visited in sorted key order at every level, as ``jax.tree``
orders a dict's keys, so a reduction over ``leaves`` adds in the
reference's order.
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping


def map(fn: Callable, tree: Mapping, *rest: Mapping) -> dict:  # noqa: A001
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which have its keys; the leaves are visited in ``leaves``' order."""
    return {k: map(fn, tree[k], *(r[k] for r in rest))
            if isinstance(tree[k], Mapping)
            else fn(tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def leaves(tree: Mapping) -> Iterator:
    """The leaves in ``jax.tree.leaves`` order (sorted keys)."""
    for k in sorted(tree):
        x = tree[k]
        yield from (leaves(x) if isinstance(x, Mapping) else (x,))
