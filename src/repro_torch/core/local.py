"""Shared local-SGD machinery (port of `repro/core/local.py`).

As in the reference, `sgd_steps` and `masked_grads` are one client's
functions: batches lead with the step axis (K, B, ...), and a round runs
them under `torch.func.vmap` over the stacked client axis.  The resident
u-steps write the client axis out instead (`step_batch`, `n_steps` take
stacked (m, K, B, ...) batches): each step takes all m clients' gradients
with `vmap(grad_and_value(...))` and updates the stacked buffer.  `scan`
over the steps is a Python loop.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value

from .. import tree
from ..optim import SGDState
from . import partition


def step_batch(batches: dict, k: int) -> dict:
    """Step k of stacked batches with leaves (m, K, B, ...)."""
    return {name: leaf[:, k] for name, leaf in batches.items()}


def n_steps(batches: dict) -> int:
    return next(iter(batches.values())).shape[1]


def flat_view_loss(loss_fn: Callable, layout, shard=None) -> Callable:
    """Wrap a tree-form loss into one over a client's flat shared row:
    (flat_row, personal_i, batch) -> loss.  The row is unraveled into leaf
    views only at the loss_fn boundary; `shard` (a tensor-parallel
    rank's `launch.tp.Executor.shard_row`) then takes the rank's shard of
    each leaf."""
    def wrapped(flat_row, personal_i, batch):
        shared = layout.unravel_row(flat_row)
        if shard is not None:
            shared = shard(shared)
        return loss_fn(partition.merge(shared, personal_i), batch)

    return wrapped


def blend_(gate, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """gate * new + (1 - gate) * old in new's dtype: a step gate of 1
    takes the step, 0 keeps `old`.  Rounded as the reference's expression
    (each product, then the sum); where all three are f32 and `new` is
    not `old` the result is written into `new`'s storage, which must be a
    fresh tensor of the step (an optimizer output; SGD without momentum
    hands the old momentum back as the new one, hence the identity test),
    so a step over an LM's parameters holds no second and third copy of
    them."""
    f32 = torch.float32
    if new is not old and new.dtype == old.dtype == f32 \
            and torch.as_tensor(gate).dtype == f32:
        return new.mul_(gate).add_((1.0 - gate) * old)
    return (gate * new + (1.0 - gate) * old).to(new.dtype)


def masked_grads(grads: dict, mask: dict, keep_shared: bool) -> dict:
    """One client's gradients with the other part's leaves zeroed: inactive
    leaves become SCALAR zeros, so SGD leaves the parameter unchanged, adds
    no weight decay there, and keeps that part's momentum a scalar
    placeholder."""
    return tree.tree_map(
        lambda g, shared: g if shared == keep_shared
        else torch.zeros((), dtype=g.dtype, device=g.device), grads, mask)


def sgd_steps(loss_fn: Callable, opt, params, opt_state, batches: dict,
              lr_scale, step_gate=None, grad_filter=None, extra: tuple = ()):
    """K SGD steps of ONE client (vmap it over the clients) on a params
    tree (dict).  batches leaves are (K, B, ...); loss_fn(p, batch,
    *extra), with `extra` held fixed (not differentiated).
    grad_filter(grads, params) -> grads runs before the update (e.g. part
    masking); step_gate (K,) in {0, 1} gates whole steps, an off step
    leaving params and momentum unchanged.  -> (params, opt_state, mean
    loss)."""
    value_and_grad = grad_and_value(loss_fn)
    losses = []
    for k in range(next(iter(batches.values())).shape[0]):
        g, loss = value_and_grad(params, {n: a[k] for n, a in
                                          batches.items()}, *extra)
        if grad_filter is not None:
            g = grad_filter(g, params)
        p2, s2 = opt.update(g, opt_state, params, lr_scale)
        if step_gate is not None:
            gate = step_gate[k]

            def sel(new, old):
                return tree.tree_map(lambda a, b: (gate * a + (1.0 - gate)
                                                   * b).to(a.dtype), new, old)
            p2, s2 = sel(p2, params), SGDState(sel(s2.momentum,
                                                   opt_state.momentum))
        params, opt_state = p2, s2
        losses.append(loss)
    if not losses:
        return params, opt_state, torch.full((), float("nan"))
    return params, opt_state, torch.stack(losses).mean()
