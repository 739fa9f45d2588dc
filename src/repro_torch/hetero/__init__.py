"""Asynchronous heterogeneity runtime of the port (port of `repro/hetero`).

- `profiles` — per-client compute speed, push latency and availability
               (`repro/hetero/profiles.py`);
- `clock`    — the time-sliced virtual clock: each tick only the clients
               whose next-event time has arrived act
               (`repro/hetero/clock.py`);
- `mailbox`  — delayed push-sum as stacked in-flight mass buffers (a ring
               of delivery slots and a persistent inbox), conserving the
               push-sum weight at every tick (`repro/hetero/mailbox.py`);
- `runtime`  — the AsyncRuntime tick engine (`repro/hetero/runtime.py`).
               Its fires mix through the CUDA gossip_gather kernel, and
               a lossy codec's through topk_gather as well; with
               `algo.telemetry` each tick reports the reference's gauges.
"""
from .clock import ClockState, active_mask, advance, init_clock
from .mailbox import Mailbox
from .profiles import ClientProfile, tier_gates, validate_step_gates
from .runtime import AsyncRuntime, AsyncState

__all__ = [
    "AsyncRuntime", "AsyncState", "ClientProfile", "ClockState", "Mailbox",
    "active_mask", "advance", "init_clock", "tier_gates",
    "validate_step_gates",
]
