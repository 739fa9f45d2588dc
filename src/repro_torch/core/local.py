"""Shared local-SGD machinery (port of `repro/core/local.py`).

The reference writes the local steps per client and vmaps the round; the
port writes the client axis out: every step takes all m clients' gradients
at once with `torch.func.vmap(torch.func.grad_and_value(...))`, and the
optimizer update runs on the stacked (m, ...) tensors — elementwise, so it
is each client's own update.  `scan` over the steps is a Python loop.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from . import partition


def step_batch(batches: dict, k: int) -> dict:
    """Step k of per-client batches with leaves (m, K, B, ...)."""
    return {name: leaf[:, k] for name, leaf in batches.items()}


def n_steps(batches: dict) -> int:
    return next(iter(batches.values())).shape[1]


def flat_view_loss(loss_fn: Callable, layout) -> Callable:
    """Wrap a tree-form loss into one over a client's flat shared row:
    (flat_row, personal_i, batch) -> loss.  The row is unraveled into leaf
    views only at the loss_fn boundary."""
    def wrapped(flat_row, personal_i, batch):
        shared = layout.unravel_row(flat_row)
        return loss_fn(partition.merge(shared, personal_i), batch)

    return wrapped


def sgd_steps(loss_fn: Callable, opt, params, opt_state, batches: dict,
              lr_scale, extra: tuple = ()):
    """Run K SGD steps on stacked params of m clients.

    loss_fn(p, batch, *extra) is one client's loss; batches leaves are
    (m, K, B, ...) and each `extra` tensor is (m, ...) per-client data held
    fixed (not differentiated).  -> (params, opt_state, (m,) mean loss)."""
    value_and_grads = vmap(grad_and_value(loss_fn))
    losses = []
    for k in range(n_steps(batches)):
        g, loss = value_and_grads(params, step_batch(batches, k), *extra)
        params, opt_state = opt.update(g, opt_state, params, lr_scale)
        losses.append(loss)
    return params, opt_state, torch.stack(losses, dim=1).mean(dim=1)
