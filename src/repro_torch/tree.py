"""Parameter trees (the port's stand-in for JAX pytrees).

A tree is nested dicts, lists and tuples whose leaves are tensors (or any
other object: a NamedTuple is a leaf here).  Leaf order is the JAX
treedef order — dict keys sorted at every level, list and tuple children
in index order with the integer index as the path key — because that
order is the wire layout of the flat gossip buffer
(`core/gossip.FlatLayout`), the checkpoint keys (`layers/0/ln`) and the
partition's path strings.  xLSTM keeps its differently shaped layers in a
Python list (`models/ssm.py`) and its decode cache in a list of tuples.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def is_node(x) -> bool:
    """A dict, list or tuple (not a NamedTuple): a node with children."""
    return isinstance(x, (dict, list)) or (
        isinstance(x, tuple) and not hasattr(x, "_fields"))


def _children(node) -> list:
    """(key, child) pairs of a node in JAX treedef order: a dict's keys
    sorted, a sequence's indices ascending."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def paths(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """(key path, leaf) pairs in JAX treedef order."""
    for key, val in _children(tree):
        if is_node(val):
            yield from paths(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def leaves(tree) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """fn over matching leaves of trees with the same structure; a list
    stays a list and a tuple a tuple."""
    if isinstance(tree, dict):
        return {k: (tree_map(fn, v, *(r[k] for r in rest)) if is_node(v)
                    else fn(v, *(r[k] for r in rest)))
                for k, v in tree.items()}
    return type(tree)(
        tree_map(fn, v, *(r[i] for r in rest)) if is_node(v)
        else fn(v, *(r[i] for r in rest)) for i, v in enumerate(tree))


def get(tree, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _lists(node):
    """Nested dicts -> the same with each dict whose keys are exactly 0 ..
    n-1 turned into a list in index order.  A dict of other int keys (a
    list pruned to some of its entries by `partition.split`) stays a dict:
    its sorted keys keep the list's order."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    keys = list(out)
    if keys and all(type(k) is int for k in keys) and \
            sorted(keys) == list(range(len(keys))):
        return [out[i] for i in range(len(keys))]
    return out


def from_paths(items):
    """Inverse of `paths`: [(path, leaf)] -> nested dicts, with lists
    where a node's keys are the integers 0 .. n-1 (a tuple comes back as a
    list)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _lists(out)
