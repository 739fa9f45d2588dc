"""Collaboration-graph gauges (port of `repro/obs/graph.py`).

The paper's convergence constant is driven by the connectivity term
Gamma(W) of the directed mixing schedule — a property of the GRAPH, not
of any single client.  This module is the graph's runtime face:

  contraction_estimate   power-iteration estimate of the mixing window's
                         disagreement contraction factor
  edge_mass_flow         per-edge push-sum mass attribution; `moved_mass`
                         is its total
  edge_delta_attribution de-biased received-value attribution per in-edge
  degree_utilization     per-client in/out-degree load
  row_cosine /           resident-buffer similarity gauges
  pairwise_distance
  mailbox_age_hist       per-slot in-flight mass by ticks-to-delivery

Everything above the host helpers is PURE (reads only) and plain torch:
the reference computes these as stock reductions outside any Pallas
kernel, and `P @ x` goes through `gossip.mix_any`.

Randomness: the reference draws its probes and client pairs from
`jax.random`, which torch cannot replay.  The port draws them from
`device.seeded_generator(seed, GRAPH_STREAM, t0)` on the buffer's device,
and every random gauge takes the draw as an argument (`probes=`,
`pairs=`) so a test can inject the reference's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import tree
from ..core.topology import SparseTopology
from ..device import seeded_generator
from . import gauges as _gauges
from . import record as _record

# floor for renormalizing probe vectors: anything at or below f32 noise
# means the window reached exact consensus and the estimate reads ~0
_EPS = 1e-30
# stream of `device.seeded_generator` the snapshot's probes and pairs use
GRAPH_STREAM = 5
# window length for the contraction estimate on APERIODIC (random)
# schedules — periodic kinds use their own period
GRAPH_WINDOW = 4


def _rows(P: SparseTopology) -> torch.Tensor:
    return torch.arange(P.idx.shape[0], device=P.idx.device)[:, None]


# ---------------------------------------------------------------------------
# connectivity: power-iteration contraction estimate
# ---------------------------------------------------------------------------
def draw_probes(generator: torch.Generator, m: int,
                n_probes: int = 4) -> torch.Tensor:
    """(m, n_probes) standard normal f32 probes on the generator's device."""
    return torch.randn((m, n_probes), generator=generator,
                       dtype=torch.float32, device=generator.device)


def contraction_estimate(topos: Sequence[SparseTopology],
                         generator: Optional[torch.Generator] = None,
                         n_probes: int = 4, sweeps: int = 2, *,
                         probes: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Per-application contraction factor of a WINDOW of mixing patterns
    on the disagreement subspace.  Applies every topology of `topos` (in
    order, `sweeps` times) to mean-centered probe vectors, re-centering
    and re-normalizing after each application, and returns the geometric
    mean of the per-application norm ratios, maxed over probes (0-d f32):
    ~0 on the full graph, small on the exponential window, ~cos(pi/m) on
    the ring.  probes: (m, n_probes) starting vectors, drawn from
    `generator` when not given."""
    topos = tuple(topos)
    if not topos:
        raise ValueError("contraction_estimate needs >= 1 topology")
    m = topos[0].idx.shape[0]
    x = probes if probes is not None else \
        draw_probes(generator, m, n_probes)
    x = x.to(device=topos[0].w.device, dtype=torch.float32)
    x = x - torch.mean(x, dim=0, keepdim=True)
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=0), min=_EPS)[None]
    log_rho = torch.zeros((x.shape[1],), dtype=torch.float32,
                          device=x.device)
    for _ in range(int(sweeps)):
        for P in topos:
            x = P @ x
            x = x - torch.mean(x, dim=0, keepdim=True)
            n = torch.linalg.vector_norm(x, dim=0)
            log_rho = log_rho + torch.log(torch.clamp(n, min=_EPS))
            x = x / torch.clamp(n, min=_EPS)[None]
    n_apply = int(sweeps) * len(topos)
    return torch.max(torch.exp(log_rho / n_apply))


# ---------------------------------------------------------------------------
# per-edge attribution
# ---------------------------------------------------------------------------
def edge_mass_flow(P, mu: torch.Tensor,
                   fired: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(m, k) push-sum mass moved along each directed NON-SELF edge:
    flow[i, p] = w[i, p] * mu[idx[i, p]], gated by the senders that
    `fired` (async).  mu is the PRE-mix (sync) / at-fire (async) weight.
    A dense (m, m) P gives the (m, m) flow."""
    if not isinstance(P, SparseTopology):
        m = P.shape[0]
        flow = P.to(torch.float32) * mu.to(torch.float32)[None, :]
        flow = torch.where(torch.eye(m, dtype=torch.bool, device=P.device),
                           0.0, flow)
        if fired is not None:
            flow = flow * fired.to(flow.dtype)[None, :]
        return flow
    idx = P.idx.long()
    flow = P.w * mu.to(torch.float32)[idx]
    flow = torch.where(idx == _rows(P), 0.0, flow)
    if fired is not None:
        flow = flow * fired[idx].to(flow.dtype)
    return flow


def moved_mass(P, mu: torch.Tensor,
               fired: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0-d f32: total push-sum mass that crossed a wire this round."""
    return torch.sum(edge_mass_flow(P, mu, fired))


def edge_delta_attribution(P: SparseTopology, flat: torch.Tensor,
                           mu: torch.Tensor) -> torch.Tensor:
    """(m, k) de-biased received-value attribution per in-edge:
    w[i, p] * ||z_j||, z_j = u_j / mu_j (self edges zero; mu floored at
    _EPS, since a just-fired async client holds (0, 0))."""
    z = flat.to(torch.float32) / torch.clamp(
        mu[:, None].to(torch.float32), min=_EPS)
    znorm = torch.sqrt(torch.sum(torch.square(z), dim=1))
    idx = P.idx.long()
    att = P.w * znorm[idx]
    return torch.where(idx == _rows(P), 0.0, att)


def degree_utilization(P: SparseTopology) -> dict:
    """Per-client degree load of the realized non-self edge set: in- and
    out-degree, and `starved_frac`, the fraction of clients with no
    in-edge."""
    m = P.idx.shape[0]
    idx = P.idx.long()
    real = (P.w > 0) & (idx != _rows(P))
    in_deg = torch.sum(real, dim=1).to(torch.float32)
    out_deg = torch.zeros((m,), dtype=torch.float32,
                          device=idx.device).index_add_(
        0, idx.reshape(-1), real.to(torch.float32).reshape(-1))
    return {
        "in_degree_mean": torch.mean(in_deg),
        "in_degree_min": torch.min(in_deg),
        "out_degree_mean": torch.mean(out_deg),
        "out_degree_max": torch.max(out_deg),
        "starved_frac": torch.mean((in_deg <= 0).to(torch.float32)),
    }


# ---------------------------------------------------------------------------
# resident-buffer similarity
# ---------------------------------------------------------------------------
def draw_pairs(generator: torch.Generator, m: int, n_pairs: int = 64):
    """(i, j) (n_pairs,) int64 client pairs, i != j by construction (the
    j draw skips i), on the generator's device."""
    dev = generator.device
    i = torch.randint(0, m, (n_pairs,), generator=generator, device=dev)
    j_raw = torch.randint(0, max(m - 1, 1), (n_pairs,),
                          generator=generator, device=dev)
    j = torch.where(j_raw >= i, j_raw + 1, j_raw) % m
    return i, j


def row_cosine(flat: torch.Tensor, mu: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               n_pairs: int = 64, *, pairs=None) -> dict:
    """Sampled pairwise cosine similarity of the de-biased shared rows
    z_i = u_i / mu_i over `pairs` (drawn from `generator` when not
    given): mean and min."""
    m = flat.shape[0]
    z = flat.to(torch.float32) / torch.clamp(
        mu[:, None].to(torch.float32), min=_EPS)
    i, j = pairs if pairs is not None else \
        draw_pairs(generator, m, n_pairs)
    zi, zj = z[torch.as_tensor(i, device=z.device).long()], \
        z[torch.as_tensor(j, device=z.device).long()]
    dot = torch.sum(zi * zj, dim=1)
    nn = torch.linalg.vector_norm(zi, dim=1) * \
        torch.linalg.vector_norm(zj, dim=1)
    cos = dot / torch.clamp(nn, min=_EPS)
    return {"row_cos_mean": torch.mean(cos), "row_cos_min": torch.min(cos)}


def pairwise_distance(rows: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      n_pairs: int = 64, prefix: str = "head_dist", *,
                      pairs=None) -> dict:
    """Sampled pairwise L2 distance over per-client rows (m, d): mean and
    max — on the stacked personal heads, how far they have
    specialized."""
    m = rows.shape[0]
    r = rows.to(torch.float32)
    i, j = pairs if pairs is not None else \
        draw_pairs(generator, m, n_pairs)
    i = torch.as_tensor(i, device=r.device).long()
    j = torch.as_tensor(j, device=r.device).long()
    d = torch.sqrt(torch.sum(torch.square(r[i] - r[j]), dim=1))
    return {f"{prefix}_mean": torch.mean(d), f"{prefix}_max": torch.max(d)}


def stack_client_rows(stacked: dict) -> torch.Tensor:
    """A stacked (m, ...) tree (e.g. the personal leaves) -> per-client
    rows (m, d_total) f32, leaves in sorted-key order; None leaves are
    skipped."""
    leaves = [a for a in tree.leaves(stacked) if a is not None]
    if not leaves:
        raise ValueError("stack_client_rows: no non-None leaves")
    m = leaves[0].shape[0]
    return torch.cat([a.reshape(m, -1).to(torch.float32) for a in leaves],
                     dim=1)


# ---------------------------------------------------------------------------
# async: mailbox staleness histogram
# ---------------------------------------------------------------------------
def mailbox_age_hist(slots_mu: torch.Tensor, tick: int) -> dict:
    """Per-slot in-flight mass keyed by ticks-until-delivery: slot
    (tick + delta) mod D holds the mass arriving delta ticks from now,
    delta in [1, D] — fields `mail_age<delta>_mass`."""
    depth = slots_mu.shape[0]
    return {f"mail_age{delta}_mass": torch.sum(
        slots_mu[(int(tick) + delta) % depth])
        for delta in range(1, depth + 1)}


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------
def top_edges(P, attribution, k: int = 8) -> str:
    """Encode the k highest-attribution directed edges as the compact
    string 'j->i:val|...' (sender -> receiver) — records only carry JSON
    scalars, so per-edge data crosses as one string field that
    `report --graph` parses back (`report.parse_edges`)."""
    idx = np.asarray(torch.as_tensor(P.idx).cpu())
    att = np.asarray(torch.as_tensor(attribution).cpu(), np.float64)
    m = idx.shape[0]
    rows = np.arange(m)[:, None]
    att = np.where(idx == rows, 0.0, att)
    flat_order = np.argsort(-att, axis=None)[:max(int(k), 1)]
    parts = []
    for f in flat_order:
        i, p = divmod(int(f), att.shape[1])
        if att[i, p] <= 0.0:
            break
        parts.append(f"{int(idx[i, p])}->{i}:{att[i, p]:.4g}")
    return "|".join(parts)


# ---------------------------------------------------------------------------
# the snapshot + emit function both regimes call
# ---------------------------------------------------------------------------
def _snapshot(flat, mu, personal, P, window, *, probes, pairs) -> tuple:
    """The graph gauges of one snapshot -> (gauge dict of 0-d tensors,
    (m, k) per-edge attribution): contraction over the schedule window,
    moved mass and degree load of P, row similarity and (with personal
    leaves) head distances over the same client pairs."""
    g = {"contraction": contraction_estimate(window, probes=probes),
         "moved_mass": moved_mass(P, mu)}
    g.update(degree_utilization(P))
    g.update(row_cosine(flat, mu, pairs=pairs))
    if tree.leaves(personal):
        g.update(pairwise_distance(stack_client_rows(personal),
                                   pairs=pairs))
    return g, edge_delta_attribution(P, flat, mu)


def emit_graph_record(sink, *, run_id, algo, m, seed, schedule, step, t0,
                      flat, mu, personal, active=None, extra=None,
                      probes=None, pairs=None):
    """Emit one kind="graph" record (schema v2): the window [t0, t0+W) of
    the run's schedule (W = schedule.period, or GRAPH_WINDOW for the
    aperiodic kinds), snapshotted against the CURRENT buffer.  The CPU
    tables move to the buffer's device once per snapshot.

    Under partial participation (`active`: the round's sorted global ids)
    the window is induced on the active set (row renorm, the subgraph the
    sampled round mixed) and the rows are gathered to the compact id
    space.  For the async regime pass the in-flight-aware ledger
    (flat + mail, mu + mail).  `extra` carries regime-specific gauges onto
    the record.  probes / pairs replace the draws from
    `seeded_generator(seed, GRAPH_STREAM, t0)` (tests inject the
    reference's)."""
    dev = flat.device
    W = schedule.period or GRAPH_WINDOW
    # the conserved ledger spans the FULL buffer, before any gather
    mass_total = torch.sum(mu.to(torch.float32))
    if active is not None:
        act = torch.as_tensor(np.asarray(active))
        window = tuple(schedule.induced(int(t0) + i, act, "row").to(dev)
                       for i in range(W))
        take = act.to(dev).long()
        flat, mu = flat.index_select(0, take), mu.index_select(0, take)
        personal = tree.tree_map(lambda a: a.index_select(0, take),
                                 personal)
    else:
        window = tuple(schedule.at(int(t0) + i).to(dev) for i in range(W))
    n = flat.shape[0]
    if probes is None or pairs is None:
        gen = seeded_generator(seed, GRAPH_STREAM, int(t0), dev)
        probes = draw_probes(gen, n) if probes is None else probes
        pairs = draw_pairs(gen, n) if pairs is None else pairs
    g, att = _snapshot(flat, mu, personal, window[0], window,
                      probes=probes, pairs=pairs)
    host = _gauges.to_host({"mass_total": mass_total, **(extra or {}), **g})
    sink.emit(_record.graph_record(
        run=run_id, algo=algo, step=step, m=m,
        n_active=None if active is None else int(len(active)),
        top_edges=top_edges(window[0], att), **host))
