"""Rematerialization of a block's activations (the reference's
`jax.checkpoint` of each block under `cfg.remat`).

`call(block, *args)` runs block(*args) through a `torch.autograd.Function`
that saves only the block's inputs: the activations and the block's
parameter leaves, passed in as explicit inputs so that they get their
gradients.  Its backward recomputes the block through `torch.func.vjp`,
so a block's intermediate activations live only inside its own forward
and backward.  `torch.utils.checkpoint` does not run under the rounds'
`vmap(grad_and_value(...))` (saved-tensor hooks are refused under
`torch.func.grad`, and its reentrant form lacks a `setup_context`); this
Function has one and `generate_vmap_rule = True`, so it runs under
`vmap`, `grad` and both, and its gradients are those of the plain block
bit for bit (the backward replays the same operations).

Only the training route rematerializes (`enabled`: cfg.remat and route
"plain"): prefill and decode keep their activations-free forwards, as the
reference's `build_prefill_step` / `build_decode_step` set remat False,
and the ctypes kernel route never runs under the Function.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree


def enabled(cfg, route: str) -> bool:
    """Rematerialize the blocks of this forward: the config asks for it
    and the forward is the training route."""
    return bool(cfg.remat) and route == "plain"


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *tensors):
        return run(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        diff = [i for i, t in enumerate(tensors) if t.is_floating_point()]

        def replay(*xs):
            full = list(tensors)
            for i, x in zip(diff, xs):
                full[i] = x
            return ctx.run(*full)

        out, vjp_fn = torch.func.vjp(replay, *(tensors[i] for i in diff))
        got = vjp_fn(grads if isinstance(out, tuple) else grads[0])
        result = [None] * len(tensors)
        for i, g in zip(diff, got):
            result[i] = g
        return (None, *result)


def call(block: Callable, *args):
    """block(*args), its activations rematerialized in the backward.
    Each argument is a tensor, a tree (dicts and lists) of tensors, or
    anything else (a config, a route name), which passes through as is.
    The block returns a tensor or a tuple of tensors."""
    tensors, rebuild = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            rebuild.append(("tensor", len(tensors)))
            tensors.append(a)
        elif isinstance(a, (dict, list)):
            items = list(tree.paths(a))
            rebuild.append(("tree", [(p, len(tensors) + i)
                                     for i, (p, _) in enumerate(items)]))
            tensors += [leaf for _, leaf in items]
        else:
            rebuild.append(("const", a))

    def run(*ts):
        given = []
        for kind, what in rebuild:
            if kind == "tensor":
                given.append(ts[what])
            elif kind == "tree":
                given.append(tree.from_paths((p, ts[i]) for p, i in what))
            else:
                given.append(what)
        return block(*given)

    return _Remat.apply(run, *tensors)


def maybe(on: bool, block: Callable, *args):
    """`call(block, *args)` when `on`, else block(*args)."""
    return call(block, *args) if on else block(*args)
