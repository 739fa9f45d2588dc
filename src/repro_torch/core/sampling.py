"""Per-round partial participation: which clients act this round.

Port of `repro/core/sampling.py`.  The `ParticipationSampler` decides the
round's active subset as a pure host-side function of (kind, m, frac, seed,
t), drawing from `numpy.random.default_rng([seed, t])` exactly as the
reference does — so the port's active ids equal the reference's id for id.

Kinds:
- "full"    — every client, every round;
- "uniform" — a uniform-random k = max(1, round(frac*m)) subset per round;
- "trace"   — availability-trace-driven (`hetero.profiles`): rank clients
              by ticks-until-reachable at round t, available first, ties
              broken by the round's generator, take k.  The subset size
              stays k even when fewer than k clients are on duty.

The ids are sorted int32: the gather/scatter row order of the compact
working set and the order `topology.induced_subgraph` re-indexes by.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..hetero import profiles as profiles_mod

KINDS = ("full", "uniform", "trace")


@dataclasses.dataclass(frozen=True, eq=False)
class ParticipationSampler:
    """t -> sorted (n_active,) int32 global client ids, a pure function of
    (seed, t)."""
    kind: str
    m: int
    frac: float = 1.0
    seed: int = 0
    profile: Optional[profiles_mod.ClientProfile] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"participation kind {self.kind!r}; known: {KINDS}")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(
                f"participation frac must be in (0, 1]; got {self.frac}")
        if self.kind == "trace":
            if self.profile is None:
                raise ValueError(
                    "participation='trace' needs the hetero profile that "
                    "carries the availability traces (hetero != 'uniform' "
                    "with availability < 1)")
            profiles_mod.validate_profile(self.profile, self.m)
        if self.m < 1:
            raise ValueError(f"need m >= 1 clients, got {self.m}")

    @property
    def n_active(self) -> int:
        """Per-round subset size."""
        if self.kind == "full":
            return self.m
        return max(1, int(round(self.frac * self.m)))

    def _rng(self, t) -> np.random.Generator:
        # the reference's host-side stream, replayed draw for draw
        return np.random.default_rng([int(self.seed), int(t)])  # noqa: TID251

    def active_at(self, t) -> np.ndarray:
        """Sorted (n_active,) int32 global ids of the round-t participants."""
        k = self.n_active
        if self.kind == "full" or k >= self.m:
            return np.arange(self.m, dtype=np.int32)
        rng = self._rng(t)
        if self.kind == "uniform":
            ids = rng.choice(self.m, size=k, replace=False)
        else:
            # soonest-reachable first; random tiebreak among equals
            wait = profiles_mod.time_to_available(self.profile, t)
            order = np.lexsort((rng.random(self.m), wait))
            ids = order[:k]
        return np.sort(ids).astype(np.int32)

    def active_mask(self, t) -> np.ndarray:
        """(m,) bool of the round-t participants."""
        mask = np.zeros(self.m, bool)
        mask[self.active_at(t)] = True
        return mask


def get_sampler(kind: str, m: int, frac: float = 1.0, seed: int = 0,
                profile=None) -> Optional[ParticipationSampler]:
    """kind string -> sampler, or None for "full" (the all-clients path:
    callers skip the gather/scatter round).  A fractional frac with
    kind="full" raises: the full sampler acts on every client."""
    if kind not in KINDS:
        raise ValueError(f"participation kind {kind!r}; known: {KINDS}")
    if kind == "full":
        if frac != 1.0:
            raise ValueError(
                f"participation_frac={frac} needs participation='uniform' "
                f"or 'trace' — the 'full' sampler acts on every client "
                f"(drop the knob or pick a kind)")
        return None
    return ParticipationSampler(kind, m, frac, seed,
                                profile if kind == "trace" else None)
