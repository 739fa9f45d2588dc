"""DFedPGP's rounds (Algorithm 1 of arXiv:2405.17876), one client at a
time.

Each round, every participating client i:
  1. pins z = u_i / mu_i, its de-biased shared part;
  2. takes k_v SGD steps on its personal part v_i at the pinned z;
  3. takes k_u SGD steps on its shared row u_i, each gradient taken at
     z = u_i / mu_i and applied to the biased row;
then the participants' rows and push-sum weights mix over the round's
pull table restricted to them: u_i <- sum_j w_ij u_j, mu_i <- sum_j w_ij
mu_j.  SGD keeps momentum and decays weights (on the row it steps, u_i or
v_i); the learning rate falls by `decay` each round.  A restricted row
keeps the weight its dropped edges carried, spread over the edges that
survive in proportion to their weights; rows of clients that sit out a
round keep every value.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class Hyper(NamedTuple):
    lr: float
    momentum: float
    wd: float
    decay: float
    k_v: int
    k_u: int


class Round(NamedTuple):
    idx: np.ndarray               # (m, k) in-neighbors, self first
    w: np.ndarray                 # (m, k) pull weights
    active: Optional[np.ndarray]  # sorted participants, None: all
    batches: dict                 # {'v': {name: (n, k_v, ...)}, 'u': ...}


def induced(idx: np.ndarray, w: np.ndarray, active: np.ndarray):
    """The table on the participants in their compact ids: -> (cidx, cw)
    (n, k).  A dropped edge points at the row itself with weight 0."""
    m, k = idx.shape
    n = len(active)
    pos = np.full(m, -1)
    pos[active] = np.arange(n)
    gidx, gw = idx[active], w[active].astype(np.float32)
    cpos = pos[gidx]
    alive = (cpos >= 0) & (gw > 0)
    cidx = np.where(alive, cpos, np.arange(n)[:, None])
    kept = np.where(alive, gw, np.float32(0))
    scale = gw.sum(axis=1, dtype=np.float32) / kept.sum(axis=1,
                                                         dtype=np.float32)
    return cidx, (kept * scale[:, None]).astype(np.float32)


def _mix(x: torch.Tensor, src: torch.Tensor, cw: torch.Tensor):
    """sum_j cw[:, j] * x[src[:, j]], the neighbors added in j order."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    out = cw[:, 0].reshape(shape) * x[src[:, 0]]
    for j in range(1, src.shape[1]):
        out = out + cw[:, j].reshape(shape) * x[src[:, j]]
    return out


def rounds(params0: dict, shared: set, loss: Callable, feed: list,
           hyper: Hyper, after_round: Optional[Callable] = None):
    """Run the rounds of `feed` from the stacked leaves `params0` ({path:
    (m, ...)}, stepped in place).  loss(params of one client, its
    batch) -> scalar.  after_round(t, params, momentum, active ids) is
    called after each round.  -> (params, momentum, mu, losses), losses
    [[mean loss_v, mean loss_u]] per round over its participants."""
    params = dict(params0)
    mom = {p: torch.zeros_like(t) for p, t in params.items()}
    m = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    mu = torch.ones(m, dtype=torch.float32, device=dev)
    personal = [p for p in params if p not in shared]
    losses = []
    for t, rnd in enumerate(feed):
        act = np.arange(m) if rnd.active is None else rnd.active
        lr = hyper.lr * torch.tensor(hyper.decay, dtype=torch.float32) ** t
        lr = lr.to(dev)
        per_v, per_u = [], []
        for c, i in enumerate(act.tolist()):
            z0 = {p: params[p][i] / mu[i] for p in shared}
            v = {p: params[p][i] for p in personal}
            lv, lu = [], []
            for k in range(hyper.k_v):
                b = {n: a[c, k] for n, a in rnd.batches["v"].items()}
                x = {p: a.detach().requires_grad_(True) for p, a in v.items()}
                val = loss({**z0, **x}, b)
                grads = torch.autograd.grad(val, list(x.values()))
                with torch.no_grad():
                    for (p, a), g in zip(v.items(), grads):
                        mom[p][i] = hyper.momentum * mom[p][i] + (
                            g + hyper.wd * a)
                        v[p] = a - lr * mom[p][i]
                lv.append(val.detach())
            for p in personal:
                params[p][i] = v[p]
            for k in range(hyper.k_u):
                b = {n: a[c, k] for n, a in rnd.batches["u"].items()}
                z = {p: (params[p][i] / mu[i]).requires_grad_(True)
                     for p in shared}
                val = loss({**z, **v}, b)
                grads = torch.autograd.grad(val, list(z.values()))
                with torch.no_grad():
                    for p, g in zip(z, grads):
                        mom[p][i] = hyper.momentum * mom[p][i] + (
                            g + hyper.wd * params[p][i])
                        params[p][i] = params[p][i] - lr * mom[p][i]
                lu.append(val.detach())
            nan = torch.full((), float("nan"), device=dev)
            per_v.append(torch.stack(lv).mean() if lv else nan)
            per_u.append(torch.stack(lu).mean() if lu else nan)
        losses.append([float(torch.stack(per_v).mean()),
                       float(torch.stack(per_u).mean())])
        if rnd.active is None:
            cidx, cw = rnd.idx, rnd.w
        else:
            cidx, cw = induced(rnd.idx, rnd.w, act)
        rows = torch.as_tensor(act, dtype=torch.long, device=dev)
        src = rows[torch.as_tensor(cidx, dtype=torch.long, device=dev)]
        cw = torch.as_tensor(cw, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for p in shared:
                params[p][rows] = _mix(params[p], src, cw)
            mu[rows] = _mix(mu, src, cw)
        if after_round is not None:
            after_round(t, params, mom, act)
    return params, mom, mu, losses
