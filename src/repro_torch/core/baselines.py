"""Every baseline the paper compares against (Table 1), on one round engine.

Port of `repro/core/baselines.py`.

CFL methods (FedAvg, FedPer, FedRep, FedBABU, Ditto): a virtual server
averages over a sampled client subset (ratio 0.1 in the paper), as masked
means over the stacked client axis.  Every client steps and the round then
keeps the sampled ones (`_select`), as the reference does.

DFL methods (DFedAvgM, OSGP, Dis-PFL, DFedAvgM-P): gossip over the round's
mixing pattern through `gossip.mix_tree`, which mixes all of a tree's f32
leaves in one flat buffer (one `gossip_gather` launch on a GPU).  OSGP is
directed push-sum on the FULL model (DFedPGP without partial
personalization); DFedAvgM-P is the ablation row of Table 4.

Every algorithm exposes: init(stacked, device=) -> state;
round_fn(state, ctx, batches, step_gate=None) -> (state, metrics);
eval_params(state) -> stacked personalized models.  ctx is the round's
SparseTopology (or dense (m, m) matrix) for the DFL methods and the (m,)
f32 sampled-client indicator for the CFL methods (`sample` draws one from
a `torch.Generator`; the reference's `jax.random` draw cannot be replayed,
so a parity run hands the reference's in).  batches leaves are (m, K, B,
...); `step_gate` (m, K) in {0, 1} gates local steps per client
(computation heterogeneity, Table 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from .. import tree
from ..device import resolve_device
from ..optim import SGD, SGDState
from . import gossip, local, partition


class SimpleState(NamedTuple):
    params: dict
    opt: SGDState
    round: torch.Tensor    # 0-d int32
    extra: Any = None      # FedAvg: the global model; FedPartial: its u part


def _lr(decay: float, rnd: torch.Tensor) -> torch.Tensor:
    return torch.tensor(decay, dtype=torch.float32,
                        device=rnd.device) ** rnd.to(torch.float32)


def _gate(step_gate, batches: dict) -> torch.Tensor:
    if step_gate is not None:
        return step_gate
    leaf = next(iter(batches.values()))
    return torch.ones(leaf.shape[:2], dtype=torch.float32,
                      device=leaf.device)


def _zeros_like(params: dict) -> SGDState:
    return SGDState(tree.tree_map(torch.zeros_like, params))


def _to(params: dict, device) -> dict:
    return tree.tree_map(lambda a: a.to(device), params)


def _round0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _mean_sampled(stacked: dict, sampled: torch.Tensor) -> dict:
    """Weighted mean over clients with indicator `sampled` (m,)."""
    w = sampled / torch.clamp(sampled.sum(), min=1.0)
    return tree.tree_map(
        lambda a: torch.tensordot(w.to(a.dtype), a, dims=1), stacked)


def _bcast(glob: dict, m: int) -> dict:
    return tree.tree_map(lambda a: a.expand((m,) + tuple(a.shape)), glob)


def _select(cond: torch.Tensor, a: dict, b: dict) -> dict:
    """Per-client select: cond ? a_i : b_i."""
    def sel(x, y):
        c = cond.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return c * x + (1 - c) * y
    return tree.tree_map(sel, a, b)


def _sampled_loss(loss: torch.Tensor, sampled: torch.Tensor):
    return (loss * sampled).sum() / torch.clamp(sampled.sum(), min=1.0)


def sample(generator: torch.Generator, m: int, ratio: float,
           device="cpu") -> torch.Tensor:
    """(m,) f32 indicator of max(int(ratio * m), 1) uniformly sampled
    clients, drawn on the generator's (CPU) device and moved to `device`."""
    n_s = max(int(ratio * m), 1)
    out = torch.zeros((m,), dtype=torch.float32)
    out[torch.randperm(m, generator=generator)[:n_s]] = 1.0
    return out.to(device)


def _vmapped_steps(loss_fn, opt: SGD, lr, grad_filter=None):
    """One client's `local.sgd_steps` over (params, opt, batches, gate),
    ready for vmap."""
    def fn(p, s, b, g):
        return local.sgd_steps(loss_fn, opt, p, s, b, lr, step_gate=g,
                               grad_filter=grad_filter)
    return vmap(fn)


# ---------------------------------------------------------------------------
# Local — no communication
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LocalOnly:
    loss_fn: Callable
    opt: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    lr_decay: float = 0.99

    def init(self, stacked: dict, device="cuda") -> SimpleState:
        dev = resolve_device(device)
        params = _to(stacked, dev)
        return SimpleState(params, _zeros_like(params), _round0(dev))

    def round_fn(self, state: SimpleState, _unused, batches: dict,
                 step_gate=None):
        lr = _lr(self.lr_decay, state.round)
        params, opt, loss = _vmapped_steps(self.loss_fn, self.opt, lr)(
            state.params, state.opt, batches, _gate(step_gate, batches))
        return SimpleState(params, opt, state.round + 1), {
            "loss": loss.mean()}

    def eval_params(self, state: SimpleState) -> dict:
        return state.params


# ---------------------------------------------------------------------------
# FedAvg — full-model server averaging over sampled clients
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FedAvg:
    loss_fn: Callable
    sample_ratio: float = 0.1
    opt: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    lr_decay: float = 0.99

    def init(self, stacked: dict, device="cuda") -> SimpleState:
        dev = resolve_device(device)
        params = _to(stacked, dev)
        glob = tree.tree_map(lambda a: a[0], params)
        return SimpleState(params, _zeros_like(params), _round0(dev),
                           extra=glob)

    def round_fn(self, state: SimpleState, sampled: torch.Tensor,
                 batches: dict, step_gate=None):
        m = sampled.shape[0]
        lr = _lr(self.lr_decay, state.round)
        params, opt, loss = _vmapped_steps(self.loss_fn, self.opt, lr)(
            _bcast(state.extra, m), state.opt, batches,
            _gate(step_gate, batches))
        params = _select(sampled, params, state.params)
        opt = SGDState(_select(sampled, opt.momentum, state.opt.momentum))
        glob = _mean_sampled(params, sampled)
        return SimpleState(params, opt, state.round + 1, extra=glob), {
            "loss": _sampled_loss(loss, sampled)}

    def eval_params(self, state: SimpleState) -> dict:
        return state.params


# ---------------------------------------------------------------------------
# FedPer / FedRep / FedBABU — partial personalization with a server
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FedPartial:
    """mode='per'  : joint update of u and v each step (FedPer).
    mode='rep'  : head steps first (body fixed), then body steps (head fixed).
    mode='babu' : only u trained, v frozen at init (FedBABU; fine-tune at eval
    is provided by `finetune`)."""
    loss_fn: Callable
    mask: Any
    mode: str = "per"
    sample_ratio: float = 0.1
    k_head: int = 2
    opt: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    lr_decay: float = 0.99

    def init(self, stacked: dict, device="cuda") -> SimpleState:
        dev = resolve_device(device)
        params = _to(stacked, dev)
        glob_u = partition.split(tree.tree_map(lambda a: a[0], params),
                                 self.mask)[0]
        return SimpleState(params, _zeros_like(params), _round0(dev),
                           extra=glob_u)

    def _local(self, params, opt, batches, lr, gate):
        if self.mode == "per":
            return local.sgd_steps(self.loss_fn, self.opt, params, opt,
                                   batches, lr, step_gate=gate)
        if self.mode == "babu":
            return local.sgd_steps(
                self.loss_fn, self.opt, params, opt, batches, lr,
                step_gate=gate,
                grad_filter=lambda g, p: local.masked_grads(g, self.mask,
                                                            True))
        # FedRep: head steps on the first k_head batch slices, then body
        kh = self.k_head
        params, opt, l1 = local.sgd_steps(
            self.loss_fn, self.opt, params, opt,
            {k: a[:kh] for k, a in batches.items()}, lr,
            step_gate=gate[:kh],
            grad_filter=lambda g, p: local.masked_grads(g, self.mask, False))
        params, opt, l2 = local.sgd_steps(
            self.loss_fn, self.opt, params, opt,
            {k: a[kh:] for k, a in batches.items()}, lr,
            step_gate=gate[kh:],
            grad_filter=lambda g, p: local.masked_grads(g, self.mask, True))
        return params, opt, 0.5 * (l1 + l2)

    def round_fn(self, state: SimpleState, sampled: torch.Tensor,
                 batches: dict, step_gate=None):
        m = sampled.shape[0]
        lr = _lr(self.lr_decay, state.round)
        # pull the global shared part; keep the personal part local
        merged = partition.merge(_bcast(state.extra, m),
                                 partition.split(state.params, self.mask)[1])
        params, opt, loss = vmap(
            lambda p, s, b, g: self._local(p, s, b, lr, g))(
                merged, state.opt, batches, _gate(step_gate, batches))
        params = _select(sampled, params, state.params)
        opt = SGDState(_select(sampled, opt.momentum, state.opt.momentum))
        glob_u = partition.split(_mean_sampled(params, sampled),
                                 self.mask)[0]
        return SimpleState(params, opt, state.round + 1, extra=glob_u), {
            "loss": _sampled_loss(loss, sampled)}

    def finetune(self, state: SimpleState, batches: dict,
                 steps: int = 5) -> dict:
        """FedBABU eval-time fine-tune of the whole model on the first
        `steps` batch slices."""
        lr = _lr(self.lr_decay, state.round)
        b = {k: a[:, :steps] for k, a in batches.items()}
        params, _, _ = _vmapped_steps(self.loss_fn, self.opt, lr)(
            state.params, state.opt, b, _gate(None, b))
        return params

    def eval_params(self, state: SimpleState) -> dict:
        return state.params


# ---------------------------------------------------------------------------
# Ditto — global FedAvg model + proximal personal models
# ---------------------------------------------------------------------------
class DittoState(NamedTuple):
    personal: dict
    glob_stacked: dict
    opt_p: SGDState
    opt_g: SGDState
    glob: dict
    round: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Ditto:
    loss_fn: Callable
    lam: float = 0.75
    sample_ratio: float = 0.1
    opt: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    lr_decay: float = 0.99

    def init(self, stacked: dict, device="cuda") -> DittoState:
        dev = resolve_device(device)
        params = _to(stacked, dev)
        glob = tree.tree_map(lambda a: a[0], params)
        return DittoState(params, params, _zeros_like(params),
                          _zeros_like(params), glob, _round0(dev))

    def round_fn(self, state: DittoState, sampled: torch.Tensor,
                 batches: dict, step_gate=None):
        m = sampled.shape[0]
        lr = _lr(self.lr_decay, state.round)
        gate = _gate(step_gate, batches)
        glob_b = _bcast(state.glob, m)

        # global-model local training (plain empirical risk)
        gp, og, _ = _vmapped_steps(self.loss_fn, self.opt, lr)(
            glob_b, state.opt_g, batches, gate)
        gp = _select(sampled, gp, state.glob_stacked)
        og = SGDState(_select(sampled, og.momentum, state.opt_g.momentum))
        glob = _mean_sampled(gp, sampled)

        # personal training with a proximal pull toward the (old) global
        def prox_loss(p, batch, ref):
            sq = tree.tree_map(lambda a, b: torch.sum(torch.square(a - b)),
                               p, ref)
            return self.loss_fn(p, batch) + 0.5 * self.lam * sum(
                tree.leaves(sq))

        def client(p, s, b, r, g):
            return local.sgd_steps(prox_loss, self.opt, p, s, b, lr,
                                   step_gate=g, extra=(r,))

        pp, op, pl = vmap(client)(state.personal, state.opt_p, batches,
                                  glob_b, gate)
        pp = _select(sampled, pp, state.personal)
        op = SGDState(_select(sampled, op.momentum, state.opt_p.momentum))
        return DittoState(pp, gp, op, og, glob, state.round + 1), {
            "loss": _sampled_loss(pl, sampled)}

    def eval_params(self, state: DittoState) -> dict:
        return state.personal


# ---------------------------------------------------------------------------
# DFedAvgM (undirected gossip + momentum) and its partial ablation (-P)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DFedAvgM:
    loss_fn: Callable
    partial_mask: Any = None      # None = full model gossip; mask = "-P" row
    opt: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    lr_decay: float = 0.99

    def init(self, stacked: dict, device="cuda") -> SimpleState:
        dev = resolve_device(device)
        params = _to(stacked, dev)
        return SimpleState(params, _zeros_like(params), _round0(dev))

    def round_fn(self, state: SimpleState, P, batches: dict,
                 step_gate=None):
        lr = _lr(self.lr_decay, state.round)
        params, opt, loss = _vmapped_steps(self.loss_fn, self.opt, lr)(
            state.params, state.opt, batches, _gate(step_gate, batches))
        if self.partial_mask is None:
            params = gossip.mix_tree(P, params)
        else:
            u, v = partition.split(params, self.partial_mask)
            params = partition.merge(gossip.mix_tree(P, u), v)
        return SimpleState(params, opt, state.round + 1), {
            "loss": loss.mean()}

    def eval_params(self, state: SimpleState) -> dict:
        return state.params


# ---------------------------------------------------------------------------
# OSGP — directed push-sum gossip of the FULL model
# ---------------------------------------------------------------------------
class OSGPState(NamedTuple):
    params: dict
    mu: torch.Tensor       # (m,) f32 push-sum weights
    opt: SGDState
    round: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OSGP:
    loss_fn: Callable
    opt: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    lr_decay: float = 0.99

    def init(self, stacked: dict, device="cuda") -> OSGPState:
        dev = resolve_device(device)
        params = _to(stacked, dev)
        m = tree.leaves(params)[0].shape[0]
        return OSGPState(params, torch.ones((m,), dtype=torch.float32,
                                            device=dev),
                         _zeros_like(params), _round0(dev))

    def _client(self, p, mu_i, s, b, gt, lr):
        """One client's K steps, each gradient taken at the de-biased
        z = p / mu and applied to the biased p."""
        value_and_grad = grad_and_value(self.loss_fn)
        losses = []
        for k in range(next(iter(b.values())).shape[0]):
            z = tree.tree_map(lambda a: a / mu_i, p)
            g, loss = value_and_grad(z, {n: a[k] for n, a in b.items()})
            p2, s2 = self.opt.update(g, s, p, lr)
            gk = gt[k]

            def blend(new, old):
                return tree.tree_map(lambda a, bb: gk * a + (1 - gk) * bb,
                                     new, old)
            p, s = blend(p2, p), SGDState(blend(s2.momentum, s.momentum))
            losses.append(loss)
        return p, s, torch.stack(losses).mean()

    def round_fn(self, state: OSGPState, P, batches: dict, step_gate=None):
        lr = _lr(self.lr_decay, state.round)
        params, opt, loss = vmap(
            lambda p, mu_i, s, b, g: self._client(p, mu_i, s, b, g, lr))(
                state.params, state.mu, state.opt, batches,
                _gate(step_gate, batches))
        params = gossip.mix_tree(P, params)
        mu = gossip.mix_any(P, state.mu)
        return OSGPState(params, mu, opt, state.round + 1), {
            "loss": loss.mean()}

    def eval_params(self, state: OSGPState) -> dict:
        mu = state.mu
        return tree.tree_map(
            lambda a: a / mu.reshape((-1,) + (1,) * (a.dim() - 1)).to(
                a.dtype), state.params)


# ---------------------------------------------------------------------------
# Dis-PFL — personalized sparse masks over undirected gossip (static random
# masks, as the reference: its cosine-annealed prune/regrow is a noted
# simplification there)
# ---------------------------------------------------------------------------
class DisPFLState(NamedTuple):
    params: dict
    masks: dict            # per-client binary masks, same shapes as params
    opt: SGDState
    round: torch.Tensor


# seed of the mask generator when none is given (the reference's
# PRNGKey(7); the draws themselves differ)
DISPFL_MASK_SEED = 7


@dataclasses.dataclass(frozen=True)
class DisPFL:
    loss_fn: Callable
    sparsity: float = 0.5
    opt: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    lr_decay: float = 0.99

    def init_masks(self, generator: torch.Generator, stacked: dict) -> dict:
        """Per-client random binary masks at the target sparsity, drawn on
        the generator's (CPU) device leaf by leaf in sorted-key order.  A
        STACKED leaf of ndim <= 2 (biases, norms: (m, C)) stays dense, as in
        the reference."""
        out = []
        for path, a in tree.paths(stacked):
            if a.dim() <= 2:
                out.append((path, torch.ones_like(a)))
            else:
                u = torch.rand(a.shape, generator=generator)
                out.append((path, (u > self.sparsity).to(a.dtype).to(
                    a.device)))
        return tree.from_paths(out)

    def init(self, stacked: dict, device="cuda", masks: Optional[dict] = None,
             generator: Optional[torch.Generator] = None) -> DisPFLState:
        """masks: injected per-client masks (e.g. the reference's draw);
        otherwise drawn from `generator` (default: a CPU generator seeded
        DISPFL_MASK_SEED, so every device draws the same masks)."""
        dev = resolve_device(device)
        stacked = _to(stacked, dev)
        if masks is None:
            masks = self.init_masks(
                generator or torch.Generator().manual_seed(DISPFL_MASK_SEED),
                stacked)
        masks = tree.tree_map(lambda mk, p: torch.as_tensor(mk).to(
            device=dev, dtype=p.dtype), masks, stacked)
        params = tree.tree_map(lambda p, mk: p * mk, stacked, masks)
        return DisPFLState(params, masks, _zeros_like(stacked), _round0(dev))

    def round_fn(self, state: DisPFLState, P, batches: dict,
                 step_gate=None):
        lr = _lr(self.lr_decay, state.round)

        def client(p, msk, s, b, g):
            def filt(gr, _p):
                return tree.tree_map(lambda gg, mm: gg * mm, gr, msk)
            return local.sgd_steps(self.loss_fn, self.opt, p, s, b, lr,
                                   step_gate=g, grad_filter=filt)

        params, opt, loss = vmap(client)(state.params, state.masks,
                                         state.opt, batches,
                                         _gate(step_gate, batches))
        # masked aggregation: average only where neighbours have weights.
        # Both contractions ride one mix_tree call (one gather launch)
        mixed = gossip.mix_tree(P, {
            "num": tree.tree_map(lambda a, mk: a * mk, params, state.masks),
            "den": state.masks})

        def agg(a, mk, num, den):
            return torch.where(mk > 0, num / torch.clamp(den, min=1e-8), a)

        params = tree.tree_map(agg, params, state.masks, mixed["num"],
                               mixed["den"])
        return DisPFLState(params, state.masks, opt, state.round + 1), {
            "loss": loss.mean()}

    def eval_params(self, state: DisPFLState) -> dict:
        return state.params
