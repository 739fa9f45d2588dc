"""Communication topologies: time-varying directed graphs.

Port of the parts of `repro/core/topology.py` the resident DFedPGP round
needs: the neighbor-indexed `SparseTopology`, the directed kinds (random,
exponential, ring, full), the dense-degree ceiling and the
`TopologySchedule` registry.  Pull form: every row is row-stochastic.

The exponential, ring and full tables are deterministic and equal the
reference's table for table.  `random` draws from a `torch.Generator`
seeded from (seed, t): it cannot replay `jax.random`, so parity runs hand
the reference's tables in (`fl.simulator.run_experiment(topology_at=)`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

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
# round schedules
# ---------------------------------------------------------------------------
def _round_seed(seed: int, t: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, t)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(t) + 1) % (2 ** 63)


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """The time-varying mixing schedule t -> SparseTopology.  `at(t)` is a
    pure function of (kind, m, n, seed, t) and returns CPU tables."""
    kind: str                      # random | exponential | ring | full
    m: int
    n: int = 0                     # in-degree for the random kind
    seed: int = 0

    KINDS = ("random", "exponential", "ring", "full")

    def __post_init__(self):
        if self.kind == "undirected":
            raise NotImplementedError(
                "topology='undirected' is ported with the baselines "
                "(ROADMAP queue 1 item 9)")
        if self.kind not in self.KINDS:
            raise ValueError(
                f"schedule kind {self.kind!r}; known: {self.KINDS}")
        if self.kind == "full":
            _check_dense_degree(self.m, f"topology={self.kind!r}")
        if self.kind == "exponential" and self.m & (self.m - 1):
            raise ValueError("exponential graph wants power-of-two m")

    def at(self, t) -> SparseTopology:
        """The round-t mixing pattern (CPU tensors)."""
        if self.kind == "random":
            gen = torch.Generator().manual_seed(_round_seed(self.seed, t))
            return directed_random(gen, self.m, self.n)
        if self.kind == "exponential":
            return directed_exponential(self.m, t)
        if self.kind == "ring":
            return ring(self.m)
        return fully_connected(self.m)


def get_schedule(kind: str, m: int, n: int = 0,
                 seed: int = 0) -> TopologySchedule:
    """kind string -> the run's one TopologySchedule.  The degree/seed
    knobs parameterize only the random kind; static kinds zero them so two
    resolvers handed the same (kind, m) produce equal schedules."""
    if kind == "random":
        return TopologySchedule(kind, m, n, seed)
    return TopologySchedule(kind, m, 0, 0)
