"""Per-client resource profiles: compute speed, push latency, availability.

Port of `repro/hetero/profiles.py`.  A `ClientProfile` is a NamedTuple of
(m,) arrays describing how each client behaves on the virtual clock — numpy
as the samplers build them, or tensors on a device after `to(device)`:

- `step_cost`   — virtual ticks one local SGD step takes (1.0 = fastest);
- `push_delay`  — delivery delay class of the client's pushes, in ticks;
- `avail_period`/`avail_duty`/`avail_phase` — periodic availability trace:
                  the client is reachable while
                  ((t + phase) mod period) < duty * period; period 0 means
                  always available.

The samplers draw from `numpy.random.default_rng(seed)` exactly as the
reference does, so a profile is equal to the reference's for the same
arguments.  The sync regime uses the profiles for trace-driven
participation (`core.sampling`) and the Table 3 step gates (`tier_gates`);
the async runtime (`hetero.runtime`) moves its profile to the buffer's
device once and asks `available(t)` every tick.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ClientProfile(NamedTuple):
    step_cost: np.ndarray      # (m,) f32, >= 1
    push_delay: np.ndarray     # (m,) int32, >= 0
    avail_period: np.ndarray   # (m,) f32; 0 => always available
    avail_duty: np.ndarray     # (m,) f32 in (0, 1]
    avail_phase: np.ndarray    # (m,) f32

    @property
    def m(self) -> int:
        return self.step_cost.shape[0]

    def to(self, device) -> "ClientProfile":
        """The profile as tensors on `device` (the async runtime moves it
        across once; validate the numpy profile first)."""
        return ClientProfile(*(torch.as_tensor(a).to(device) for a in self))

    def available(self, t) -> torch.Tensor:
        """(m,) bool tensor — which clients are reachable at virtual time t,
        on the device of the fields (the CPU for numpy fields).  f32
        arithmetic as the reference's: ((t + phase) mod period) < duty *
        period, where t + phase >= 0 and period >= 1, so the mod is the
        exact `fmod`."""
        period_raw, duty, phase = (torch.as_tensor(a) for a in (
            self.avail_period, self.avail_duty, self.avail_phase))
        period = torch.clamp(period_raw, min=1.0)
        # t adds as an f32 scalar: no copy to the device
        on = torch.fmod(phase + float(t), period) < duty * period
        return torch.where(period_raw <= 0.0, True, on)


def _rng(seed: int) -> np.random.Generator:
    # the reference's host-side numpy stream, replayed draw for draw
    return np.random.default_rng(seed)  # noqa: TID251


def validate_profile(profile: ClientProfile, m: int) -> ClientProfile:
    """Shape/value check — raises instead of silently broadcasting."""
    for name, arr in zip(profile._fields, profile):
        shape = tuple(np.shape(arr))
        if shape != (m,):
            raise ValueError(
                f"ClientProfile.{name} must have shape ({m},), got {shape}")
    if float(np.min(profile.step_cost)) < 1.0:
        raise ValueError("step_cost must be >= 1 (1.0 = fastest tier)")
    if int(np.min(profile.push_delay)) < 0:
        raise ValueError("push_delay must be >= 0")
    duty = np.asarray(profile.avail_duty)
    if float(duty.min()) <= 0.0 or float(duty.max()) > 1.0:
        raise ValueError("avail_duty must be in (0, 1] — duty 0 is a "
                         "client that never acts, not a trace")
    if float(np.min(profile.avail_period)) < 0.0:
        raise ValueError("avail_period must be >= 0 (0 = always on)")
    return profile


def _full(m, value, dtype=np.float32) -> np.ndarray:
    return np.full((m,), value, dtype)


def uniform(m: int) -> ClientProfile:
    """Homogeneous baseline: every client steps every tick, zero delay,
    always available."""
    return ClientProfile(_full(m, 1.0), _full(m, 0, np.int32),
                         _full(m, 0.0), _full(m, 1.0), _full(m, 0.0))


def tiered(m: int, tiers: int = 5, spread: float = 5.0,
           push_delay_max: int = 0, availability: float = 1.0,
           seed: int = 0) -> ClientProfile:
    """Hard capability tiers (paper Table 3's 5-tier split): tier t's step
    cost interpolates 1..spread; push delays cycle 0..push_delay_max
    across tiers; availability < 1 gives every client a duty-cycled trace
    with a random phase."""
    if tiers < 1 or spread < 1.0:
        raise ValueError(f"need tiers >= 1 and spread >= 1 "
                         f"(got {tiers}, {spread})")
    tier = np.arange(m) * tiers // m                       # 0 .. tiers-1
    frac = tier / max(tiers - 1, 1)
    cost = 1.0 + frac * (spread - 1.0)
    delay = (tier % (push_delay_max + 1)).astype(np.int32)
    if availability >= 1.0:
        period = np.zeros(m)
        phase = np.zeros(m)
    else:
        period = np.full(m, 8.0 * spread)
        phase = _rng(seed).uniform(0.0, period)
    return ClientProfile(cost.astype(np.float32), delay,
                         period.astype(np.float32),
                         _full(m, float(min(availability, 1.0))),
                         phase.astype(np.float32))


def lognormal(m: int, sigma: float = 0.5, push_delay_max: int = 0,
              availability: float = 1.0, seed: int = 0) -> ClientProfile:
    """Long-tailed device speeds: step_cost = exp(sigma * N(0,1)),
    normalized so the fastest client costs exactly 1 tick per step."""
    rng = _rng(seed)
    cost = np.exp(sigma * rng.standard_normal(m))
    cost = cost / cost.min()
    delay = rng.integers(0, push_delay_max + 1, m).astype(np.int32)
    if availability >= 1.0:
        period = np.zeros(m)
        phase = np.zeros(m)
    else:
        period = np.full(m, 8.0 * float(cost.max()))
        phase = rng.uniform(0.0, period)
    return ClientProfile(cost.astype(np.float32), delay,
                         period.astype(np.float32),
                         _full(m, float(min(availability, 1.0))),
                         phase.astype(np.float32))


def time_to_available(profile: ClientProfile, t) -> np.ndarray:
    """(m,) f32 ticks until each client is next reachable — 0 for clients
    available at t.  A client whose phase sits past the on-window waits
    out the rest of its period."""
    period = np.asarray(profile.avail_period, np.float32)
    duty = np.asarray(profile.avail_duty, np.float32)
    phase = np.asarray(profile.avail_phase, np.float32)
    p = np.maximum(period, 1.0)
    pos = np.mod(float(t) + phase, p)
    wait = np.where(pos < duty * p, 0.0, p - pos)
    return np.where(period <= 0.0, 0.0, wait).astype(np.float32)


KINDS = ("uniform", "tiered", "lognormal")


def make_profile(kind: str, m: int, *, spread: float = 5.0,
                 push_delay_max: int = 0, availability: float = 1.0,
                 seed: int = 0) -> ClientProfile:
    """Config-string constructor used by SimConfig (fl/simulator.py)."""
    if kind == "uniform":
        if push_delay_max != 0 or availability < 1.0:
            raise ValueError(
                "hetero='uniform' is the homogeneous baseline and ignores "
                "the heterogeneity knobs; use 'tiered' or 'lognormal' "
                "with push_delay_max/availability")
        p = uniform(m)
    elif kind == "tiered":
        p = tiered(m, spread=spread, push_delay_max=push_delay_max,
                   availability=availability, seed=seed)
    elif kind == "lognormal":
        p = lognormal(m, sigma=float(np.log(max(spread, 1.0))) / 2.0,
                      push_delay_max=push_delay_max,
                      availability=availability, seed=seed)
    else:
        raise ValueError(f"profile kind {kind!r}; known: {KINDS}")
    return validate_profile(p, m)


# ---------------------------------------------------------------------------
# synchronous-regime heterogeneity: step gates (paper Table 3)
# ---------------------------------------------------------------------------
def tier_gates(m: int, k: int, tiers: int = 5) -> np.ndarray:
    """(m, k) step gates for the sync regime's heterogeneity: tier t runs
    max(1, round(k*(t+1)/tiers)) of its k local steps, the rest are gated
    off."""
    gates = np.zeros((m, k), np.float32)
    for i in range(m):
        tier = i * tiers // m
        steps = max(1, round(k * (tier + 1) / tiers))
        gates[i, :steps] = 1.0
    return gates


def validate_step_gates(gates, m: int, k: int) -> np.ndarray:
    """Check a user-supplied (m, K) gate array against the client count and
    the local steps: a misshapen array would otherwise broadcast (or slice)
    into silently wrong gating."""
    g = np.asarray(gates, np.float32)
    if g.ndim != 2 or g.shape[0] != m or g.shape[1] < k:
        raise ValueError(
            f"step_gates must be (m, K) with m={m} clients and K >= {k} "
            f"local steps, got {g.shape}")
    return g
