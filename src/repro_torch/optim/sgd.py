"""Minimal functional SGD with momentum / weight decay (paper's optimizer).

Port of `repro/optim/sgd.py`: SGD(lr=0.1, momentum 0.9, weight decay
5e-4) with an exponential per-round lr scale, on tensors or trees of
tensors (`repro_torch.tree`) — not `torch.optim` — plus the reference's
`exp_decay_schedule` and `clip_by_global_norm`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import tree


def _map(fn, x, *rest):
    if tree.is_node(x):
        return tree.tree_map(fn, x, *rest)
    return fn(x, *rest)


class SGDState(NamedTuple):
    momentum: Any


class SGD(NamedTuple):
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

    def init(self, params) -> SGDState:
        return SGDState(_map(torch.zeros_like, params))

    def update(self, grads, state: SGDState, params, lr_scale=1.0):
        """Returns (new_params, new_state)."""
        if self.weight_decay:
            # frozen leaves carry scalar placeholder grads (shape differs
            # from the param's): no decay there
            grads = _map(lambda g, p: g + self.weight_decay * p
                         if g.shape == p.shape else g, grads, params)
        if self.momentum:
            # keep the momentum dtype: the push-sum de-bias promotes grads
            m = _map(lambda mo, g: (self.momentum * mo + g).to(mo.dtype),
                     state.momentum, grads)
            d = _map(lambda g, mo: g + self.momentum * mo, grads, m) \
                if self.nesterov else m
        else:
            m, d = state.momentum, grads
        step = self.lr * lr_scale
        new_params = _map(lambda p, u: (p - step * u).to(p.dtype), params, d)
        return new_params, SGDState(m)


def exp_decay_schedule(base: float, decay: float):
    """lr(t) = base * decay**t (the paper's 0.99x exponential decay)."""
    def sched(t):
        return base * decay ** t
    return sched


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled so their joint L2 norm is at most max_norm, the
    norm before clipping as a 0-d tensor)."""
    leaves = tree.leaves(grads) if tree.is_node(grads) else [grads]
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: g * scale, grads), norm
