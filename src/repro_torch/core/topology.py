"""Communication topologies: time-varying directed graphs.

Port of the parts of `repro/core/topology.py` the port's rounds and ticks
need: the neighbor-indexed `SparseTopology`, the directed kinds (random,
exponential, ring, full), the undirected kind of the DFedAvgM / Dis-PFL
baselines, the dense-degree ceiling, the `TopologySchedule` registry,
for partial participation the `induced_subgraph` of the round's active
clients, for Regime B the schedule's `permutation_offsets`, and for the
async runtime the lazy push form `to_push_sparse`
with its `staleness_self_weight`.  Pull form: every row is
row-stochastic (the undirected tables are doubly stochastic); the push
form is column-stochastic.

The exponential, ring and full tables are deterministic and equal the
reference's table for table.  `random` and `undirected` draw from a
`torch.Generator` seeded from (seed, t): it cannot replay `jax.random`, so
parity runs hand the reference's tables in
(`fl.simulator.run_experiment(topology_at=)`).  The undirected
construction after the draw is the reference's numpy code
(`undirected_from_picks`): from the reference's picks it gives the
reference's tables bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

# Constructors whose neighbor table is O(m^2)-shaped refuse above this m.
MAX_DENSE_M = 4096


def _check_dense_degree(m: int, what: str) -> None:
    if m > MAX_DENSE_M:
        raise ValueError(
            f"{what} builds an O(m^2)-shaped table; m={m} > "
            f"MAX_DENSE_M={MAX_DENSE_M} would allocate "
            f"{m * m * 4 / 2**30:.1f} GiB of neighbor weights.  At scale "
            f"use a sparse-degree kind (random/exponential/ring)")


class SparseTopology(NamedTuple):
    """Neighbor-indexed row-stochastic mixing pattern.

    idx: (m, k) int32 — in-neighbor ids of each client (self included);
         rows with fewer than k in-edges are padded with the row's own id.
    w:   (m, k) float32 — pull weights; padding entries carry weight 0.
    """
    idx: torch.Tensor
    w: torch.Tensor

    @property
    def m(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    def dense(self) -> torch.Tensor:
        """The (m, m) row-stochastic matrix (diagnostics and the no-sparsity
        fallback only); refuses above MAX_DENSE_M."""
        m = self.idx.shape[0]
        _check_dense_degree(m, "SparseTopology.dense()")
        out = torch.zeros((m, m), dtype=self.w.dtype, device=self.w.device)
        return out.index_put_(
            (torch.arange(m, device=self.idx.device)[:, None]
             .expand_as(self.idx), self.idx.long()), self.w, accumulate=True)

    def to(self, device) -> "SparseTopology":
        return SparseTopology(self.idx.to(device), self.w.to(device))

    def __matmul__(self, x):
        """P @ x: out[i] = sum_j w[i,j] * x[idx[i,j]] for x (m,) or
        (m, ...), through `gossip.mix_any` (densified when k >= m)."""
        from . import gossip  # gossip imports this module
        return gossip.mix_any(self, torch.as_tensor(x))


# ---------------------------------------------------------------------------
# directed graphs
# ---------------------------------------------------------------------------
def directed_random(generator: torch.Generator, m: int,
                    n_neighbors: int) -> SparseTopology:
    """Every client pulls from n uniform random in-neighbors plus itself,
    uniform weights 1/(n+1); self first; k = n+1.  Above MAX_DENSE_M the
    neighbors are drawn with replacement (the reference's O(m*n) path)."""
    n = min(n_neighbors, m - 1)
    rows = torch.arange(m)[:, None]
    if m > MAX_DENSE_M:
        draws = torch.randint(0, m - 1, (m, n), generator=generator)
    else:
        # a uniform random permutation of the m-1 peers per row, first n
        draws = torch.rand((m, m - 1), generator=generator).argsort(dim=1)
        draws = draws[:, :n]
    nb = torch.where(draws >= rows, draws + 1, draws)        # skip self
    idx = torch.cat([rows, nb], dim=1).to(torch.int32)
    w = torch.full((m, n + 1), 1.0 / (n + 1), dtype=torch.float32)
    return SparseTopology(idx, w)


def directed_exponential(m: int, round_idx: int) -> SparseTopology:
    """One-peer exponential graph: at round t each client pulls from the
    peer at offset 2^(t mod log2 m); weights (1/2, 1/2); k = 2."""
    if m & (m - 1):
        raise ValueError("exponential graph wants power-of-two m")
    log_m = max(int(math.log2(m)), 1)
    offset = 2 ** (int(round_idx) % log_m)
    rows = torch.arange(m)
    idx = torch.stack([rows, (rows - offset) % m], dim=1).to(torch.int32)
    return SparseTopology(idx, torch.full((m, 2), 0.5, dtype=torch.float32))


def ring(m: int) -> SparseTopology:
    rows = torch.arange(m)
    idx = torch.stack([rows, (rows - 1) % m], dim=1).to(torch.int32)
    return SparseTopology(idx, torch.full((m, 2), 0.5, dtype=torch.float32))


def fully_connected(m: int) -> SparseTopology:
    """Complete graph, uniform 1/m weights; k = m (self first, then the
    m-1 peers in id order).  Raises above MAX_DENSE_M."""
    _check_dense_degree(m, "fully_connected (k = m)")
    rows = torch.arange(m)[:, None]
    others = (torch.arange(m)[None, :] + rows + 1) % m
    idx = torch.cat([rows, others[:, : m - 1]], dim=1).to(torch.int32)
    return SparseTopology(idx, torch.full((m, m), 1.0 / m,
                                          dtype=torch.float32))


# ---------------------------------------------------------------------------
# undirected graphs (the DFedAvgM / Dis-PFL baselines)
# ---------------------------------------------------------------------------
def undirected_from_picks(picks, m: int, n: int) -> SparseTopology:
    """Symmetric doubly-stochastic table from a directed draw: the (m, n+1)
    neighbor ids `picks` (col 0 = self) are symmetrized, each row's degree
    capped at dmax = min(3n, m-1) symmetrically, weighted by
    Metropolis-Hastings and cut to width k = min(dmax+1, m) by
    `np.argpartition`.  The reference's numpy calls in its order: the j
    order of the table is the sum order of the mix.  n is the effective
    degree min(n_neighbors, m-1)."""
    picks = np.asarray(picks)
    A = np.zeros((m, m), bool)
    np.put_along_axis(A, picks, True, axis=1)
    A |= A.T
    np.fill_diagonal(A, False)

    dmax = max(min(3 * n, m - 1), 1)
    pos = A.cumsum(1) - 1                 # rank of each edge within its row
    keep = A & (pos < dmax) & (pos.T < dmax)   # symmetric cap
    deg = keep.sum(1)
    W = np.where(keep,
                 1.0 / (np.maximum(deg[:, None], deg[None, :]) + 1.0), 0.0)
    np.fill_diagonal(W, 1.0 - W.sum(1))

    k = min(dmax + 1, m)
    order = np.argpartition(-W, kth=k - 1, axis=1)[:, :k]
    w = np.take_along_axis(W, order, axis=1)
    idx = np.where(w > 0, order, np.arange(m)[:, None])
    return SparseTopology(torch.from_numpy(idx.astype(np.int32)),
                          torch.from_numpy(w.astype(np.float32)))


def undirected_random(generator: torch.Generator, m: int,
                      n_neighbors: int) -> SparseTopology:
    """The paper's undirected baseline graph: `directed_random`'s picks made
    symmetric with Metropolis-Hastings weights (`undirected_from_picks`);
    k = min(min(3n, m-1) + 1, m), a function of (m, n) alone.  Builds an
    (m, m) host table: refuses above MAX_DENSE_M."""
    _check_dense_degree(m, "undirected_random (dense host-side table)")
    n = min(n_neighbors, m - 1)
    return undirected_from_picks(directed_random(generator, m, n).idx.numpy(),
                                 m, n)


# ---------------------------------------------------------------------------
# the async regime's push form
# ---------------------------------------------------------------------------
def to_push_sparse(P: SparseTopology, self_weight=0.5) -> SparseTopology:
    """Lazy column-stochastic (push) form of a pull pattern: P's edge set,
    re-weighted so each SENDER j keeps `self_weight[j]` of its mass and
    splits the rest uniformly over its non-self out-edges:

        w[i, p] = (1 - self_weight[j]) / outdeg(j),  j = idx[i, p] != i
        w[i, p] = self_weight[i] (+ the rest if outdeg == 0)  at the self
                  edge

    Every column sums to 1, so the push-sum mass is conserved under any
    delay trace (`hetero.mailbox`).  self_weight: a scalar in [0, 1) or a
    per-sender (m,) array (`staleness_self_weight`).  Every row must carry
    a self entry, or the kept share has no slot and its mass is destroyed:
    both conditions raise.  O(m*k) on P's device, the reference's f32
    arithmetic op for op."""
    m = P.idx.shape[0]
    dev = P.idx.device
    sw = torch.broadcast_to(torch.as_tensor(
        self_weight, dtype=torch.float32).to(dev), (m,))
    rows = torch.arange(m, device=dev)[:, None]
    self_edge = P.idx.long() == rows
    has_self = self_edge.any(1)
    if not bool(has_self.all()):
        bad = torch.nonzero(~has_self).flatten()[:5].tolist()
        raise ValueError(
            f"to_push_sparse needs a self entry in every row (rows {bad} "
            f"have none): the sender's kept share would have no slot and "
            f"its mass would be destroyed")
    lo, hi = float(sw.min()), float(sw.max())
    if lo < 0.0 or hi >= 1.0:
        raise ValueError(
            f"self_weight must lie in [0, 1) (a sender keeping >= 1 of its "
            f"mass pushes none); got range [{lo}, {hi}]")
    real = (P.w > 0) & ~self_edge
    outdeg = torch.zeros((m,), dtype=torch.float32, device=dev).index_add_(
        0, P.idx.reshape(-1).long(), real.to(torch.float32).reshape(-1))
    share = (1.0 - sw) / torch.clamp(outdeg, min=1.0)
    w = torch.where(real, share[P.idx.long()], 0.0)
    w_self = sw + (1.0 - sw) * (outdeg <= 0).to(torch.float32)
    # the kept share goes on the REAL self edge; a row whose self edge is
    # only (self, 0) padding splits it evenly over those slots
    real_self = self_edge & (P.w > 0)
    self_slot = torch.where(real_self.any(1, keepdim=True), real_self,
                            self_edge)
    cnt = torch.clamp(self_slot.sum(1, keepdim=True), min=1)
    w = torch.where(self_slot, w_self[:, None] / cnt, w)
    return SparseTopology(P.idx, w.to(torch.float32))


def staleness_self_weight(push_delay, base: float = 0.5) -> torch.Tensor:
    """Stale-mass discounting: the per-sender lazy self share of a sender
    in push-delay class d, 1 - (1 - base) / (1 + d).  A delay-0 sender
    keeps `base`; a slow link pushes 1/(1 + d) as much, so the mass it
    holds in flight stays about constant instead of growing with d.
    -> (m,) f32 on the CPU (or on push_delay's device)."""
    d = torch.as_tensor(push_delay).to(torch.float32)
    return 1.0 - (1.0 - float(base)) / (1.0 + d)


# ---------------------------------------------------------------------------
# partial participation: induced subgraphs
# ---------------------------------------------------------------------------
def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Row sums of an (n, k) table added in column order (the order the
    reference's XLA reduction takes), (n, 1)."""
    out = x[:, :1]
    for j in range(1, x.shape[1]):
        out = out + x[:, j:j + 1]
    return out


def induced_subgraph(P: SparseTopology, active,
                     renorm: str = "row") -> SparseTopology:
    """The subgraph induced by the `active` clients, re-indexed to the
    compact [0, n_active) ids (compact id p is the position of active[p]).

    Edges with a dormant endpoint are dropped (padded to (self, 0)) and the
    surviving weights are scaled so each row ("row", the pull form) or each
    sender column ("col", the push form) sums to what it summed to in the
    full graph.  The factor is orig_sum / alive_sum, NOT a renormalization
    to 1: when every edge survives the two sums are the same float, the
    factor is exactly 1.0 and the induced weights equal the originals bit
    for bit — which makes a sampled round with every client active equal
    the full round.  A row whose every positive edge went dormant keeps its
    whole weight on itself.  O(n*k + m) work on P's device."""
    if renorm not in ("row", "col"):
        raise ValueError(f"renorm must be 'row' or 'col'; got {renorm!r}")
    m, k = P.idx.shape
    _check_dense_degree(k, "induced_subgraph of a dense-width (k = m) table")
    dev = P.idx.device
    active = torch.as_tensor(active, device=dev).long()
    n = active.shape[0]
    pos = torch.full((m,), -1, dtype=torch.long, device=dev)
    pos[active] = torch.arange(n, device=dev)
    gidx = P.idx[active].long()                # (n, k) global neighbor ids
    gw = P.w[active]
    cpos = pos[gidx]                           # compact ids, -1 if dormant
    alive = (cpos >= 0) & (gw > 0)
    rows_c = torch.arange(n, device=dev)[:, None].expand(n, k)
    cidx = torch.where(alive, cpos, rows_c)    # dead edges -> (self, 0) pad
    wz = torch.where(alive, gw, torch.zeros_like(gw))
    if renorm == "row":
        orig = _sum_in_order(gw)
        live = _sum_in_order(wz)
        w = wz * torch.where(live > 0, orig / live, torch.zeros_like(live))
        first = torch.zeros((1, k), dtype=torch.bool, device=dev)
        first[0, 0] = True
        w = torch.where((live <= 0) & first, orig.expand(n, k), w)
    else:
        # per-SENDER column sums, full graph vs induced: both add the same
        # values in the same order when every client is active -> 1.0
        orig_col = torch.zeros((m,), dtype=torch.float32, device=dev)
        orig_col.index_add_(0, P.idx.reshape(-1).long(), P.w.reshape(-1))
        alive_col = torch.zeros((m,), dtype=torch.float32, device=dev)
        alive_col.index_add_(0, gidx.reshape(-1), wz.reshape(-1))
        scale = torch.where(alive_col > 0, orig_col / alive_col,
                            torch.zeros_like(alive_col))
        w = wz * scale[gidx]
    return SparseTopology(cidx.to(torch.int32), w.to(torch.float32))


# ---------------------------------------------------------------------------
# round schedules
# ---------------------------------------------------------------------------
def _round_seed(seed: int, t: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, t)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(t) + 1) % (2 ** 63)


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """The time-varying mixing schedule t -> SparseTopology.  `at(t)` is a
    pure function of (kind, m, n, seed, t) and returns CPU tables."""
    kind: str      # random | exponential | ring | full | undirected
    m: int
    n: int = 0                     # in-degree for the random kinds
    seed: int = 0

    KINDS = ("random", "exponential", "ring", "full", "undirected")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(
                f"schedule kind {self.kind!r}; known: {self.KINDS}")
        if self.kind in ("full", "undirected"):
            _check_dense_degree(self.m, f"topology={self.kind!r}")
        if self.kind == "exponential" and self.m & (self.m - 1):
            raise ValueError("exponential graph wants power-of-two m")

    @property
    def period(self) -> int:
        """Rounds until the schedule repeats: the B of the exponential
        graph's B-strongly-connected window, 1 for the static graphs, 0
        for the aperiodic random kinds."""
        if self.kind == "exponential":
            return max(int(math.log2(self.m)), 1)
        if self.kind in ("ring", "full"):
            return 1
        return 0

    def at(self, t) -> SparseTopology:
        """The round-t mixing pattern (CPU tensors)."""
        if self.kind in ("random", "undirected"):
            gen = torch.Generator().manual_seed(_round_seed(self.seed, t))
            build = directed_random if self.kind == "random" \
                else undirected_random
            return build(gen, self.m, self.n)
        if self.kind == "exponential":
            return directed_exponential(self.m, t)
        if self.kind == "ring":
            return ring(self.m)
        return fully_connected(self.m)

    def induced(self, t, active, renorm: str = "row") -> SparseTopology:
        """The round-t pattern restricted to the `active` subset (CPU
        tables, compact ids)."""
        return induced_subgraph(self.at(t), active, renorm)

    def permutation_offsets(self) -> tuple:
        """For one-peer schedules: the per-round pull offsets, read off the
        neighbor tables themselves.  Round t uses offsets[t % len(offsets)]:
        every client pulls from the peer at (i - offset) mod m with weights
        (1/2, 1/2), the doubly-stochastic permutation mix of Regime B.
        Raises ValueError for schedules that are not permutation mixes."""
        if self.period == 0:
            raise ValueError(f"{self.kind!r} schedule is not periodic")
        rows = torch.arange(self.m)
        offs = []
        for t in range(self.period):
            topo = self.at(t)
            idx, w = topo.idx.long(), topo.w
            if idx.shape[1] != 2 or not torch.allclose(
                    w, torch.full_like(w, 0.5)):
                raise ValueError(
                    f"{self.kind!r} round {t} is not a one-peer "
                    f"(1/2, 1/2) permutation mix")
            off = int((rows[0] - idx[0, 1]) % self.m)
            if not torch.equal(idx[:, 1], (rows - off) % self.m) \
                    or not torch.equal(idx[:, 0], rows):
                raise ValueError(
                    f"{self.kind!r} round {t} is not a uniform-offset "
                    f"permutation")
            offs.append(off)
        return tuple(offs)


def get_schedule(kind: str, m: int, n: int = 0,
                 seed: int = 0) -> TopologySchedule:
    """kind string -> the run's one TopologySchedule.  The degree/seed
    knobs parameterize only the random kinds; static kinds zero them so two
    resolvers handed the same (kind, m) produce equal schedules."""
    if kind in ("random", "undirected"):
        return TopologySchedule(kind, m, n, seed)
    return TopologySchedule(kind, m, 0, 0)
