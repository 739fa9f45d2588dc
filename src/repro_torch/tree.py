"""Nested-dict parameter trees (the port's stand-in for JAX pytrees).

Parameters are plain nested dicts of tensors.  Leaf order is the JAX
treedef order — dict keys sorted at every level — because that order is
the wire layout of the flat gossip buffer (`core/gossip.FlatLayout`).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def paths(tree: dict, prefix: tuple = ()) -> Iterator[tuple]:
    """(key path, leaf) pairs in sorted-key (JAX treedef) order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from paths(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """fn over matching leaves of trees with the same structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest))
                if isinstance(v, dict) else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def get(tree: dict, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def from_paths(items) -> dict:
    """Inverse of `paths`: [(path, leaf)] -> nested dict."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out
