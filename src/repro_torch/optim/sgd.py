"""Minimal functional SGD with momentum / weight decay (paper's optimizer).

Port of `repro/optim/sgd.py`: SGD(lr=0.1, momentum 0.9, weight decay
5e-4) with an exponential per-round lr scale, on tensors or nested dicts
of tensors — not `torch.optim`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from .. import tree


def _map(fn, x, *rest):
    if isinstance(x, dict):
        return tree.tree_map(fn, x, *rest)
    return fn(x, *rest)


class SGDState(NamedTuple):
    momentum: Any


class SGD(NamedTuple):
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

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
