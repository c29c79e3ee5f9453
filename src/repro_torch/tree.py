"""Parameter trees (nested dicts of tensors): the few ``jax.tree``
operations the port's LM and training code need."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of ``trees``, matched by the first tree's
    keys (not by the dicts' order); a leaf is anything but a dict."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts and lists, in order."""
    if isinstance(tree, (dict, list)):
        items = tree.values() if isinstance(tree, dict) else tree
        return [x for v in items for x in tree_leaves(v)]
    return [tree]
