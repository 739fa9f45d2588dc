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

Across the ranks of a client mesh no rank materializes the whole buffer:
`emit_graph_record(ranks=...)` computes row norms, the pairs' dot
products and the personal-head distances where the rows live, sending a
pair the row it lacks point to point (`_snapshot_ranks`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import tree
from ..core.topology import SparseTopology
from ..device import seeded_generator
from ..launch import ranks as _ranks
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
    return _attribution(P, torch.sqrt(torch.sum(torch.square(z), dim=1)))


def _attribution(P: SparseTopology, znorm: torch.Tensor) -> torch.Tensor:
    """w[i, p] * znorm[idx[i, p]], self edges zero."""
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
    given): mean and min.  One pair's rows at a time: the pairs' rows
    stacked would take 64 rows of the buffer (118 GiB of f32 at
    qwen2-0.5b's width)."""
    m = flat.shape[0]
    z = flat.to(torch.float32) / torch.clamp(
        mu[:, None].to(torch.float32), min=_EPS)
    i, j = pairs if pairs is not None else \
        draw_pairs(generator, m, n_pairs)
    i = torch.as_tensor(i, device=z.device).long()
    j = torch.as_tensor(j, device=z.device).long()
    dot = _pair_sums(z, i, j, torch.mul)
    norms = _gauges.l2_norm(z, dim=1)
    cos = dot / torch.clamp(norms[i] * norms[j], min=_EPS)
    return {"row_cos_mean": torch.mean(cos), "row_cos_min": torch.min(cos)}


def _pair_sums(rows: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
               op) -> torch.Tensor:
    """(n_pairs,) sums over the columns of op(rows[i[p]], rows[j[p]]),
    one pair's two rows at a time."""
    return torch.stack([
        torch.sum(op(rows.index_select(0, i[p:p + 1]),
                     rows.index_select(0, j[p:p + 1])))
        for p in range(i.shape[0])])


def pairwise_distance(rows: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      n_pairs: int = 64, prefix: str = "head_dist", *,
                      pairs=None) -> dict:
    """Sampled pairwise L2 distance over per-client rows (m, d): mean and
    max — on the stacked personal heads, how far they have
    specialized.  One pair's rows at a time, as `row_cosine`."""
    m = rows.shape[0]
    r = rows.to(torch.float32)
    i, j = pairs if pairs is not None else \
        draw_pairs(generator, m, n_pairs)
    i = torch.as_tensor(i, device=r.device).long()
    j = torch.as_tensor(j, device=r.device).long()
    d = torch.sqrt(_pair_sums(r, i, j,
                              lambda a, b: torch.square(a - b)))
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


def _personal_row(personal: dict, i: int, groups) -> torch.Tensor:
    """Client i's personal leaves as one f32 row of the rank's share: the
    shards, and the leaves every model rank holds whole on model index 0
    alone (a sum over the model group then counts each term once)."""
    return torch.cat([a[i].reshape(-1).to(torch.float32)
                      for p, a in tree.paths(personal)
                      if a is not None and (groups.first
                                            or p not in groups.replicated)])


def _snapshot_ranks(flat, mu, personal, P, window, ids, ranks, *, probes,
                    pairs) -> tuple:
    """`_snapshot` of a buffer spread over a client mesh: `flat` and
    `personal` are the rank's block (its columns and shards), `mu` the
    gathered mu of the snapshot's rows, whose global rows are `ids` (all
    m, or the round's active clients).  Each rank takes the squared norms
    of its own rows and, for every pair whose first row it owns, the dot
    product and the personal rows' squared distance; where the pair's
    second row lives on another rank, its owner sends it (one row at a
    time, the same transfer list on every rank).  The terms reduce over
    the data group and, where split, the model group."""
    g = ranks.groups
    dev, f32 = flat.device, torch.float32
    lo = g.index * g.n_rows
    ids = [int(x) for x in ids]
    owner = [x // g.n_rows for x in ids]
    mu32 = torch.clamp(mu.to(f32), min=_EPS)
    heads = bool(tree.leaves(personal))
    mine = [c for c in range(len(ids)) if owner[c] == g.index]

    def z_row(c, row=None):
        row = flat[ids[c] - lo] if row is None else row
        return row.to(f32) / mu32[c]

    def head_row(c):
        return _personal_row(personal, ids[c] - lo, g)

    sq = torch.zeros((len(ids),), dtype=f32, device=dev)
    if mine:
        loc = torch.tensor([ids[c] - lo for c in mine], device=dev)
        z = flat.index_select(0, loc).to(f32) / mu32[mine][:, None]
        sq[mine] = torch.sum(torch.square(z), dim=1)
        del z
    pi, pj = (torch.as_tensor(x).tolist() for x in pairs)
    dots = torch.zeros((len(pi),), dtype=f32, device=dev)
    hd2 = torch.zeros_like(dots)

    def pair_terms(p, zj, hj):
        zi = z_row(pi[p])
        dots[p] = torch.sum(zi * zj)
        if heads:
            hd2[p] = torch.sum(torch.square(head_row(pi[p]) - hj))

    for p in range(len(pi)):
        if owner[pi[p]] == g.index and owner[pj[p]] == g.index:
            pair_terms(p, z_row(pj[p]), head_row(pj[p]) if heads else None)
    for r, j in sorted({(owner[i], j) for i, j in zip(pi, pj)
                        if owner[i] != owner[j]}):
        if owner[j] == g.index:
            sends = [(flat[ids[j] - lo].contiguous(), g.peers[r])]
            if heads:
                sends.append((head_row(j), g.peers[r]))
            _ranks.exchange(sends, [])
        elif r == g.index:
            row = torch.empty_like(flat[0])
            recvs = [(row, g.peers[owner[j]])]
            if heads:
                hj = torch.empty_like(head_row(mine[0]))
                recvs.append((hj, g.peers[owner[j]]))
            _ranks.exchange([], recvs)
            zj = z_row(j, row)
            for p in range(len(pi)):
                if pj[p] == j and owner[pi[p]] == g.index:
                    pair_terms(p, zj, hj if heads else None)
    terms = _gauges.sum_columns(_gauges.sum_rows(torch.cat([sq, dots]), g),
                                g)
    znorm = torch.sqrt(terms[:len(ids)])
    i_t = torch.tensor(pi, device=dev)
    j_t = torch.tensor(pj, device=dev)
    cos = terms[len(ids):] / torch.clamp(znorm[i_t] * znorm[j_t], min=_EPS)
    out = {"contraction": contraction_estimate(window, probes=probes),
           "moved_mass": moved_mass(P, mu)}
    out.update(degree_utilization(P))
    out.update({"row_cos_mean": torch.mean(cos),
                "row_cos_min": torch.min(cos)})
    if heads:
        d = torch.sqrt(_gauges.sum_shards(_gauges.sum_rows(hd2, g), g))
        out.update({"head_dist_mean": torch.mean(d),
                    "head_dist_max": torch.max(d)})
    return out, _attribution(P, znorm)


def emit_graph_record(sink, *, run_id, algo, m, seed, schedule, step, t0,
                      flat, mu, personal, active=None, extra=None,
                      probes=None, pairs=None, ranks=None):
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
    reference's).

    ranks: a client-mesh rank's `launch.steps.RankRound` (its `groups`
    and `gather_mu`): flat, mu and personal are then the rank's
    block, every rank of the mesh calls this with the same draws, and
    only rank 0 holds a sink that writes (`_snapshot_ranks`)."""
    dev = flat.device
    W = schedule.period or GRAPH_WINDOW
    if ranks is not None:
        mu = ranks.gather_mu(mu)
    # the conserved ledger spans the FULL buffer, before any gather
    mass_total = torch.sum(mu.to(torch.float32))
    ids = range(mu.shape[0])
    if active is not None:
        act = torch.as_tensor(np.asarray(active))
        window = tuple(schedule.induced(int(t0) + i, act, "row").to(dev)
                       for i in range(W))
        take = act.to(dev).long()
        mu = mu.index_select(0, take)
        ids = act.tolist()
        if ranks is None:
            flat = flat.index_select(0, take)
            personal = tree.tree_map(lambda a: a.index_select(0, take),
                                     personal)
    else:
        window = tuple(schedule.at(int(t0) + i).to(dev) for i in range(W))
    n = mu.shape[0]
    if probes is None or pairs is None:
        gen = seeded_generator(seed, GRAPH_STREAM, int(t0), dev)
        probes = draw_probes(gen, n) if probes is None else probes
        pairs = draw_pairs(gen, n) if pairs is None else pairs
    if ranks is None:
        g, att = _snapshot(flat, mu, personal, window[0], window,
                          probes=probes, pairs=pairs)
    else:
        g, att = _snapshot_ranks(flat, mu, personal, window[0], window, ids,
                                 ranks, probes=probes, pairs=pairs)
    host = _gauges.to_host({"mass_total": mass_total, **(extra or {}), **g})
    sink.emit(_record.graph_record(
        run=run_id, algo=algo, step=step, m=m,
        n_active=None if active is None else int(len(active)),
        top_edges=top_edges(window[0], att), **host))
