"""Deprecated knob-surface helpers of Regime A (port of
`repro/fl/compat.py`).

`spec_from_sim` turns a SimConfig's legacy knob fields into the run's
`AlgoSpec` (an explicit `sim.spec` wins); it is duck-typed on the fields,
so it never imports the simulator.  The three per-entrypoint helpers
`make_sim_codec`, `make_schedule` and `make_sampler` resolve through the
spec and emit a DeprecationWarning; `fl.simulator` re-exports them lazily
(PEP 562).  New code builds an AlgoSpec (`spec.make_algo_spec`) and calls
its `schedule(m)` / `make_codec()` / `sampler(m, profile)`, or passes
`SimConfig(spec=...)`.
"""
from __future__ import annotations

import warnings

from .. import spec as spec_mod
from ..hetero import profiles as hetero_profiles


def spec_from_sim(sim, algo_name: str = "dfedpgp") -> spec_mod.AlgoSpec:
    """The AlgoSpec a legacy SimConfig describes.  An explicit `sim.spec`
    wins outright; otherwise the knob fields go through the one factory,
    with its validation."""
    explicit = getattr(sim, "spec", None)
    if explicit is not None:
        return explicit
    return spec_mod.make_algo_spec(
        algo_name,
        topology=sim.topology, n_neighbors=sim.n_neighbors, seed=sim.seed,
        gossip=sim.gossip, resident=sim.resident,
        codec=sim.codec, codec_ratio=sim.codec_ratio,
        codec_bits=sim.codec_bits, codec_gamma=sim.codec_gamma,
        participation=sim.participation,
        participation_frac=sim.participation_frac)


def _warn(old: str):
    warnings.warn(
        f"fl.simulator.{old} is deprecated: build an AlgoSpec "
        f"(repro_torch.spec.make_algo_spec) and use its schedule()/"
        f"make_codec()/sampler() methods, or pass SimConfig(spec=...)",
        DeprecationWarning, stacklevel=3)


def make_sim_codec(sim):
    """Deprecated: `AlgoSpec.make_codec()` / `compress.get_codec`."""
    _warn("make_sim_codec")
    return spec_from_sim(sim).make_codec()


def make_schedule(name: str, sim):
    """Deprecated: `AlgoSpec.schedule(m)` / `topology.get_schedule`."""
    _warn("make_schedule")
    return spec_from_sim(sim, name).schedule(sim.m)


def make_sampler(sim, profile=None):
    """Deprecated: `AlgoSpec.sampler(m, profile)` /
    `sampling.get_sampler`."""
    _warn("make_sampler")
    sp = spec_from_sim(sim)
    if sp.participation == "trace" and profile is None:
        profile = hetero_profiles.make_profile(
            sim.hetero, sim.m, spread=sim.speed_spread,
            push_delay_max=sim.push_delay_max,
            availability=sim.availability, seed=sim.seed)
    return sp.sampler(sim.m, profile)
