"""Push-sum primitives over stacked client trees (port of
`repro/core/pushsum.py`).

State per client i: biased shared parameters u_i, push-sum weight mu_i,
de-biased parameters z_i = u_i / mu_i (Algorithm 1 lines 14-18).  Client
states are stacked along a leading axis of size m.  The async runtime
(`hetero.runtime`) reads `total_mass` and `debias_in_flight`;
`mass_split` is the mass ledger of `obs.gauges`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import tree
from . import gossip


class PushSumState(NamedTuple):
    u: Any               # stacked shared params, leaves (m, ...)
    mu: torch.Tensor     # (m,) push-sum bias weights


def _per_client(mu: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return mu.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)


def init_state(u_stacked: dict) -> PushSumState:
    leaf = tree.leaves(u_stacked)[0]
    return PushSumState(u_stacked, torch.ones((leaf.shape[0],),
                                              dtype=torch.float32,
                                              device=leaf.device))


def mix(P, state: PushSumState) -> PushSumState:
    """One push-pull transmission: u <- P u, mu <- P mu, through the one
    dispatch point `gossip.mix_tree` / `gossip.mix_any`."""
    return PushSumState(gossip.mix_tree(P, state.u),
                        gossip.mix_any(P, state.mu))


def debias(state: PushSumState) -> dict:
    """z_i = u_i / mu_i (line 18)."""
    return tree.tree_map(lambda a: a / _per_client(state.mu, a), state.u)


def rebias(z: dict, mu: torch.Tensor) -> dict:
    """u_i = z_i * mu_i (after local updates on de-biased parameters)."""
    return tree.tree_map(lambda a: a * _per_client(mu, a), z)


def debias_in_flight(flat: torch.Tensor, mu: torch.Tensor,
                     mail_flat: torch.Tensor, mail_mu: torch.Tensor):
    """De-bias a resident (m, d_flat) buffer counting the mass in flight:
    z_i = (u_i + mail_u_i) / (mu_i + mail_mu_i), the plain u/mu when
    nothing is in flight.  No epsilon: the async engine keeps every
    client's total mass positive.  -> (z, mu_eff)."""
    mu_eff = mu + mail_mu
    u_eff = flat + mail_flat.to(flat.dtype)
    return u_eff / mu_eff[:, None].to(u_eff.dtype), mu_eff


def total_mass(mu: torch.Tensor, *in_flight_mus) -> torch.Tensor:
    """Conserved push-sum weight: local mu plus every in-flight component
    (0-d f32).  Invariant tick to tick under column-stochastic mixing."""
    tot = torch.sum(mu)
    for extra in in_flight_mus:
        tot = tot + torch.sum(extra)
    return tot


def mass_split(mu: torch.Tensor, active_mask, *in_flight_mus):
    """The conserved total split into (active, dormant, in-flight): dormant
    mu is frozen and mass addressed to dormant clients waits in the
    mailbox inbox, so the three add up to the initial sum of mu."""
    act = torch.as_tensor(active_mask, device=mu.device)
    active = torch.sum(torch.where(act, mu, 0.0))
    dormant = torch.sum(torch.where(act, 0.0, mu))
    flight = torch.zeros((), dtype=mu.dtype, device=mu.device)
    for extra in in_flight_mus:
        flight = flight + torch.sum(extra)
    return active, dormant, flight


def consensus(state: PushSumState) -> dict:
    """De-biased average across clients — the deployment model."""
    return tree.tree_map(lambda a: torch.mean(a, dim=0), debias(state))


def consensus_distance(state: PushSumState) -> torch.Tensor:
    """Mean over clients of the squared distance of the de-biased models
    from their average, summed over the leaves."""
    def dist(a):
        dev = torch.square(a - torch.mean(a, dim=0, keepdim=True))
        # torch sums every axis for dim=(): a (m,) leaf keeps its rows
        per = dev.reshape(dev.shape[0], -1).sum(1) if a.dim() > 1 else dev
        return torch.mean(per)

    return sum(dist(a) for a in tree.leaves(debias(state)))
