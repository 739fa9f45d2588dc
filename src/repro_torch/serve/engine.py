"""Batched personalized inference over a ServingState (port of
`repro/serve/engine.py`).

A serve batch mixes many users: request r carries a user id uid[r] and an
input x[r].  The engine computes trunk features once for the whole batch
(the consensus shared representation is one model), then applies each
request's personal classifier through `ops.head_gather_matmul` — the CUDA
kernel on a GPU — with f32 accumulate.

`serve_naive` keeps the baseline shape of this path: every request runs
its user's full model.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from .. import tree
from ..device import resolve_device
from ..kernels import ops
from ..models import cnn


def serve_logits(sstate, uid: torch.Tensor, x: torch.Tensor,
                 model_cfg: cnn.CNNConfig, force: str = "auto",
                 block_n: int | None = None) -> torch.Tensor:
    """Mixed-user batched CNN serve: (B,) uid + (B, H, W, C) x -> (B, n)
    f32 logits.  Features run once through the consensus trunk; the
    per-request head is the fused gather + matmul."""
    h = cnn.features(sstate.trunk, x, model_cfg)
    head = sstate.personal["classifier"]
    return ops.head_gather_matmul(uid.to(torch.int32), h, head["w"],
                                  head["b"], force=force, block_n=block_n)


def make_cnn_server(sstate, model_cfg: cnn.CNNConfig, force: str = "auto",
                    block_n: int | None = None, device="cuda"):
    """-> serve(uid, x) -> (B, n) f32 logits, closed over the serving state
    moved to `device` once.  Inputs are moved to that device per call
    (a no-op when they already lie there); no autograd graph is built."""
    dev = resolve_device(device)
    resident = sstate.to(dev)

    @torch.no_grad()
    def serve(uid, x):
        return serve_logits(resident, uid.to(dev), x.to(dev), model_cfg,
                            force=force, block_n=block_n)

    return serve


def serve_naive(models: dict, uid: torch.Tensor, x: torch.Tensor,
                model_cfg: cnn.CNNConfig) -> torch.Tensor:
    """Baseline: stacked (m, ...) full personalized models; every request
    gathers its user's whole parameter tree and runs its own forward — no
    feature sharing, no fused head."""
    u = uid.long()
    per_request = tree.tree_map(lambda a: a[u], models)

    def one(p, xr):
        return cnn.logits_fn(p, xr[None], model_cfg)[0]

    with torch.no_grad():
        return vmap(one)(per_request, x)
