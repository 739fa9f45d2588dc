"""Deliberately broken fixture programs — one per detector (port of
`repro/analysis/fixtures.py`).

Each fixture is a small program carrying exactly one of the defects the
analyzer exists to catch; `python -m repro_torch.analysis --fixture
NAME` must exit 1 on every one of them, and
`tests/test_torch_analysis.py` asserts each trips the detector it
targets.  These are the proof that the detectors detect — a lint pass
that has never seen a violation is indistinguishable from one that
cannot see them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core import topology
from ..device import resolve_device
from .detectors import (Violation, check_donation,
                        check_topology_stochastic, run_program)
from .programs import N_ROUNDS, ProgramInstance

_M = 13          # same prime as the real programs


def broken_densify(device="cuda") -> ProgramInstance:
    """A 'mix' that materializes the dense (m, m) matrix inside the
    round — the exact O(m^2) blow-up the sparse engine avoids."""
    dev = resolve_device(device)
    P = topology.TopologySchedule.random(_M, 3, seed=3).at(0).to(dev)
    b = torch.ones((_M, 4), device=dev)

    def fn(U, P, b):
        dense = P.dense()                 # (m, m) intermediate: the bug
        return dense @ U + 0.0 * b, torch.sum(U)

    return ProgramInstance(
        name="broken.densify", fn=fn,
        round_args=((P, b),) * N_ROUNDS,
        fresh_state=lambda: torch.ones((_M, 4), device=dev),
        donate=(0,), m=_M, device=dev)


def broken_donation(device="cuda") -> ProgramInstance:
    """Takes a donated f32 buffer but only ever emits a bf16 projection of
    it, and keeps the input alive through the round's outputs (a metric
    that is a view of it): the 'resident' buffer quietly doubles."""
    dev = resolve_device(device)

    def fn(U, b):
        out = (U + b).to(torch.bfloat16)      # the new state: a projection
        return out, {"first_row": U[0]}       # a view pins the donated U

    return ProgramInstance(
        name="broken.donation", fn=fn,
        round_args=((torch.ones((_M, 4), device=dev),),) * N_ROUNDS,
        fresh_state=lambda: torch.ones((_M, 4), device=dev),
        donate=(0,), m=_M, device=dev)

# the donation fixture's carry changes dtype, so later rounds run another
# program; every detector but `donation` skips it (see run_fixture)


def broken_retrace(device="cuda") -> ProgramInstance:
    """The round counter as a Python int: every round dispatches another
    scalar, the eager face of a per-round retrace."""
    dev = resolve_device(device)

    def fn(U, t):
        return U * (0.99 ** t), torch.sum(U)

    return ProgramInstance(
        name="broken.retrace", fn=fn,
        round_args=tuple((t,) for t in range(N_ROUNDS)),
        fresh_state=lambda: torch.ones((_M, 4), device=dev),
        donate=(0,), m=_M, device=dev)


def broken_hostsync(device="cuda") -> ProgramInstance:
    """Feeds a raw numpy batch every round — each call moves it to the
    device again (a real resident loop keeps its batches there)."""
    dev = resolve_device(device)

    def fn(U, b):
        return U + torch.as_tensor(b, device=U.device), torch.sum(U)

    return ProgramInstance(
        name="broken.hostsync", fn=fn,
        round_args=((np.ones((_M, 4), np.float32),),) * N_ROUNDS,
        fresh_state=lambda: torch.ones((_M, 4), device=dev),
        donate=(0,), m=_M, device=dev)


def broken_stochastic_topology(device="cuda") -> topology.SparseTopology:
    """A hand-built neighbor table whose rows sum to 0.6 — mass leaks on
    every fire, the defect the stochasticity checker guards against."""
    P = topology.TopologySchedule.random(_M, 3, seed=3).at(0)
    return topology.SparseTopology(P.idx, P.w * 0.6).to(
        resolve_device(device))


# fixture name -> (builder, detectors expected to trip)
FIXTURES: Dict[str, Tuple[Callable[..., Any], Tuple[str, ...]]] = {
    "densify": (broken_densify, ("densify",)),
    "donation": (broken_donation, ("donation",)),
    "retrace": (broken_retrace, ("retrace",)),
    "hostsync": (broken_hostsync, ("hostsync",)),
    "stochastic": (broken_stochastic_topology, ("stochastic",)),
}


def run_fixture(name: str, device="cuda"
                ) -> Tuple[List[dict], List[Violation]]:
    """Run the full detector battery over one broken fixture on `device`.
    Returns (report rows, violations); the CLI exits 1 iff violations is
    non-empty — for fixtures, NOT tripping is the failure."""
    builder, _ = FIXTURES[name]
    built = builder(device=device)
    if isinstance(built, topology.SparseTopology):
        msgs = check_topology_stochastic(built, f"fixture:{name}")
        row = {"program": f"broken.{name}", "m": built.idx.shape[0],
               "stochastic": "FAIL" if msgs else "ok"}
        return [row], [Violation(f"broken.{name}", "stochastic", m)
                       for m in msgs]
    if name == "donation":
        # its carry changes dtype across rounds; only the donation check
        # is meaningful
        msgs = check_donation(built)
        row = {"program": built.name, "m": built.m,
               "donation": "FAIL" if msgs else "ok"}
        return [row], [Violation(built.name, "donation", m) for m in msgs]
    row, viols = run_program(built)
    return [row], viols
