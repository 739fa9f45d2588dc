"""Partial-model partition: shared `u` vs personal `v` (paper §3.1).

Port of `repro/core/partition.py`.  A mask is a tree of bools with the
params' structure (True = shared/u; dicts and lists, `repro_torch.tree`).
Where the reference keeps None placeholders at the other side's leaves,
the port drops them: `split` returns two pruned trees and `merge` joins
them again.
"""
from __future__ import annotations

import itertools
from typing import Callable

from .. import tree


def path_str(path: tuple) -> str:
    """'layers/0/ln': dict keys and list indices joined by '/', as the
    reference's path_str writes a jax key path."""
    return "/".join(str(p) for p in path)


def build_mask(params: dict, shared_pred: Callable[[str], bool]) -> dict:
    """True leaves = shared (u); False = personal (v)."""
    return tree.from_paths((p, bool(shared_pred(path_str(p))))
                           for p, _ in tree.paths(params))


def classifier_personal(path: str) -> bool:
    """Paper's split: linear classifier (+ final norm) personal, rest
    shared."""
    personal = ("classifier" in path or "lm_head" in path
                or "final_norm" in path or "dec_norm" in path)
    return not personal


def split(params: dict, mask: dict) -> tuple:
    """-> (u_tree, v_tree), each holding only its own side's leaves."""
    u, v = [], []
    for path, leaf in tree.paths(params):
        (u if tree.get(mask, path) else v).append((path, leaf))
    return tree.from_paths(u), tree.from_paths(v)


def merge(u: dict, v: dict) -> dict:
    """Join two disjoint pruned trees (the inverse of `split`)."""
    return tree.from_paths(itertools.chain(tree.paths(u), tree.paths(v)))


def where(mask: dict, a: dict, b: dict) -> dict:
    """Per-leaf select of two full trees: mask ? a : b."""
    return tree.tree_map(lambda shared, x, y: x if shared else y, mask, a, b)


def count_params(params: dict, mask: dict | None = None,
                 shared: bool = True) -> int:
    if mask is None:
        return sum(x.numel() for x in tree.leaves(params))
    return sum(leaf.numel() for path, leaf in tree.paths(params)
               if tree.get(mask, path) == shared)
