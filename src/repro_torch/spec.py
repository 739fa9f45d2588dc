"""AlgoSpec: ONE description of a training algorithm's knobs (port of
`repro/spec.py`).

One frozen dataclass, built by one factory (`make_algo_spec`), that the
simulator takes as `SimConfig(spec=...)`.  Name -> object resolution goes
through the port's registries (`topology.get_schedule`,
`sampling.get_sampler`, `compress.get_codec`).  The legacy SimConfig
knobs keep working: `fl.compat.spec_from_sim` funnels them through the
same factory, and the deprecated helpers there warn.

One stated difference from the reference: `block_m` is the reference's
Pallas DMA-panel knob.  The port's kernels take `block_d` / `block_n`
(`kernels.ops`) and have no such panel, so any `block_m` raises instead
of being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from . import compress
from .core import sampling, topology

GOSSIP_MODES = ("dense", "sparse", "pallas", "ppermute")
# algorithms whose mixing must be symmetric (no push-sum de-bias): the
# schedule resolver substitutes the undirected kind for them
UNDIRECTED_ALGOS = ("dfedavgm", "dfedavgm-p", "dispfl")


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """The one place an experiment's algorithm knobs live.  Frozen and
    hashable; invalid combinations refuse at construction (the loud-knob
    rule), not deep inside a round loop."""
    algo: str = "dfedpgp"
    topology: str = "random"        # schedule kind (topology.get_schedule)
    n_neighbors: int = 10           # in-degree of the random kinds
    seed: int = 0                   # schedule / codec / sampler seed
    gossip: str = "sparse"          # dense | sparse | pallas | ppermute
    resident: bool = True           # shared part lives in the flat buffer
    codec: Optional[str] = None     # wire codec kind (compress.get_codec)
    codec_ratio: float = 1.0 / 16.0
    codec_bits: int = 4
    codec_gamma: Any = 1.0          # float in (0, 1], or "auto"
    participation: str = "full"     # full | uniform | trace
    participation_frac: float = 1.0
    block_m: Optional[int] = None   # the reference's Pallas knob: refused
    telemetry: bool = False         # round gauges (repro_torch.obs)
    # collaboration-graph records (obs.graph, schema v2): one kind="graph"
    # record every `graph_every` rounds; 0 = never.  Rides the telemetry
    # gate
    graph_every: int = 0

    def __post_init__(self) -> None:
        if self.topology not in topology.TopologySchedule.KINDS:
            raise ValueError(
                f"topology {self.topology!r}; known: "
                f"{topology.TopologySchedule.KINDS}")
        if self.gossip not in GOSSIP_MODES:
            raise ValueError(
                f"gossip {self.gossip!r}; known: {GOSSIP_MODES}")
        if self.codec is not None and self.codec not in compress.KINDS:
            raise ValueError(
                f"codec {self.codec!r}; known: {compress.KINDS}")
        if self.participation not in sampling.KINDS:
            raise ValueError(
                f"participation {self.participation!r}; known: "
                f"{sampling.KINDS}")
        if self.participation == "full" and self.participation_frac != 1.0:
            raise ValueError(
                f"participation_frac={self.participation_frac} needs "
                f"participation='uniform' or 'trace' (the 'full' sampler "
                f"acts on every client)")
        if self.participation != "full" \
                and not 0.0 < self.participation_frac <= 1.0:
            raise ValueError(f"participation_frac="
                             f"{self.participation_frac}; want (0, 1]")
        if self.block_m is not None:
            raise ValueError(
                f"block_m={self.block_m} is the reference's Pallas "
                f"DMA-panel knob; the port's CUDA kernels have no such "
                f"panel and are tuned by block_d (gossip_gather, "
                f"pushsum_mix, gossip_scatter) and block_n "
                f"(head_gather_matmul) on kernels.ops — drop the knob")
        if self.gossip == "ppermute":
            if self.codec is not None:
                raise ValueError(
                    "codec and gossip='ppermute' are mutually exclusive: "
                    "the codec path owns the wire crossing "
                    "(gossip.mix_flat); ppermute is a mix override")
            if self.participation != "full":
                raise ValueError(
                    "ppermute offsets address all m shards; the sampled "
                    "round mixes the compact working set — use a matrix "
                    "gossip mode")
        if self.codec is not None and not self.resident:
            raise ValueError(
                "wire codecs live on the resident flat buffer; "
                "resident=False has no payload boundary")
        if self.telemetry and not self.resident:
            raise ValueError(
                "telemetry gauges (repro_torch.obs) read the resident "
                "(m, d_flat) buffer; resident=False has no buffer to "
                "gauge — enable resident or drop telemetry")
        if self.graph_every < 0:
            raise ValueError(
                f"graph_every={self.graph_every}; want 0 (off) or a "
                f"positive round period")
        if self.graph_every > 0 and not self.telemetry:
            raise ValueError(
                "graph_every > 0 emits collaboration-graph records "
                "through the telemetry spine; enable telemetry (or drop "
                "the knob)")

    # -- name -> object resolution (the registries) -----------------------
    def schedule(self, m: int) -> topology.TopologySchedule:
        """The run's one TopologySchedule at client count m; undirected
        algorithms take the undirected kind."""
        kind = "undirected" if self.algo in UNDIRECTED_ALGOS \
            else self.topology
        return topology.get_schedule(kind, m, self.n_neighbors, self.seed)

    def make_codec(self):
        """The wire codec instance, or None (uncompressed)."""
        return compress.get_codec(self.codec, ratio=self.codec_ratio,
                                  bits=self.codec_bits, seed=self.seed)

    def sampler(self, m: int,
                profile: Any = None) -> Optional[sampling.ParticipationSampler]:
        """The ParticipationSampler, or None for full participation."""
        return sampling.get_sampler(self.participation, m,
                                    self.participation_frac, self.seed,
                                    profile)


def make_algo_spec(algo: str = "dfedpgp", **kw: Any) -> AlgoSpec:
    """THE factory.  Accepts the reference's Regime B alias
    gossip="matrix" (the sparse engine) and normalizes it."""
    if kw.get("gossip") == "matrix":
        kw["gossip"] = "sparse"
    return AlgoSpec(algo=algo, **kw)
