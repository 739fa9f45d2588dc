"""Time-sliced virtual clock of the async runtime (port of
`repro/hetero/clock.py`).

Virtual time advances in unit ticks.  Each client carries the virtual time
of its NEXT step event; on a tick it is active — completes one local SGD
step, possibly firing a directed push — iff that time has arrived AND its
availability trace says it is reachable.  Completing a step costs the
client `profile.step_cost` ticks, so a 5x-slower client acts on every 5th
tick.  Unavailable clients accrue no lag: their next-event time stays put.

The tick index `t` is a host int (the host drives the ticks, and the codec
draws and the mailbox ring slots are functions of it); `next_time` is an
(m,) f32 tensor on the buffer's device, charged in f32 as the reference
charges it, so fractional costs add up to the same ticks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .profiles import ClientProfile


class ClockState(NamedTuple):
    t: int                    # global tick index == virtual time
    next_time: torch.Tensor   # (m,) f32 — when each client may act next


def init_clock(m: int, device="cpu") -> ClockState:
    return ClockState(0, torch.zeros((m,), dtype=torch.float32,
                                     device=device))


def active_mask(clock: ClockState, profile: ClientProfile) -> torch.Tensor:
    """(m,) bool — clients that act on this tick."""
    return (clock.next_time <= float(clock.t)) & profile.available(clock.t)


def advance(clock: ClockState, active: torch.Tensor,
            profile: ClientProfile) -> ClockState:
    """Charge each acting client its step cost and move to the next tick.
    next_time accumulates fractional costs in f32 (a cost-1.7 client acts
    at ticks 0, 2, 4, 6, 7, 9, ...: next_time 0, 1.7, 3.4, 5.1, 6.8,
    8.5)."""
    cost = torch.as_tensor(profile.step_cost).to(clock.next_time.device)
    nt = torch.where(active, clock.next_time + cost, clock.next_time)
    return ClockState(clock.t + 1, nt)
