"""Decentralized directed trainer (Regime B, runnable; port of
`repro/launch/train.py`).

Runs real DFedPGP rounds of a transformer-LM config: each client is a
personalized model, the shared body gossips over a time-varying directed
graph, `lm_head` and `final_norm` stay personal.  Every client lives on
one device (the card by default; `--device cpu` runs the plain PyTorch
path), and the gossip is the matrix mix: on the resident buffer the
`gossip_gather` kernel, and with `--sample` one `gossip_scatter` write-back
a round.

ONE `topology.TopologySchedule` (--topology / --seed) decides who talks to
whom, each round mixing over `schedule.at(r)`.  --resident trains on the
(m, d_flat) flat buffer (`FlatDFedPGPState`) instead of the tree-form
state.  `--gossip ppermute` needs a client mesh: on one device the run
falls back to the matrix mix and says so, as the reference does without
a mesh.

Usage (the reduced smoke config on the CPU, a few rounds, synthetic LM
data):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --rounds 4 --clients 4 --batch 2 --seq 128 --reduced --device cpu \\
      [--topology random|exponential|ring|full] [--resident] [--sample 0.5]
and on the card at full width:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --clients 4 --resident
"""
from __future__ import annotations

import argparse

import torch

from .. import obs
from ..configs import get_config, get_reduced
from ..core import partition, topology
from ..device import resolve_device, seeded_generator
from ..models import get_model
from ..obs import gauges as obs_gauges
from ..spec import make_algo_spec
from ..tree import tree_map
from . import mesh as mesh_mod
from . import steps

# streams of `device.seeded_generator`: client i's init is (0, INIT, i),
# round r's batches (0, DATA, r + 1)
INIT_STREAM = 21
DATA_STREAM = 22


def synth_lm_batch(generator: torch.Generator, cfg, lead, seq: int) -> dict:
    """Synthetic next-token data with learnable structure (the labels are
    the tokens shifted by one), drawn from `generator` on its device:
    tokens and labels (*lead, seq) int64, and for the vlm family the
    stub vision embeddings (*lead, n_vision_tokens, d_model) f32 drawn
    after them."""
    toks = torch.randint(0, cfg.vocab, tuple(lead) + (seq,),
                         generator=generator, device=generator.device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn(
            tuple(lead) + (cfg.n_vision_tokens, cfg.d_model),
            generator=generator, device=generator.device)
    return batch


def init_stacked(cfg, m: int, device) -> dict:
    """The (m, ...)-stacked params of m clients, client i drawn from
    `seeded_generator(0, INIT_STREAM, i)` on `device` and copied into its
    slot (one client's tree beside the stack at a time)."""
    api = get_model(cfg)
    stacked = None
    for i in range(m):
        one = api.init_params(seeded_generator(0, INIT_STREAM, i, device),
                              cfg, device=device)
        if stacked is None:
            stacked = tree_map(lambda a: torch.empty(
                (m,) + tuple(a.shape), dtype=a.dtype, device=a.device), one)
        tree_map(lambda s, a: s[i].copy_(a), stacked, one)
        del one
    return stacked


def make_cli_spec(args, gossip: str):
    """The run's one AlgoSpec from the CLI flags.  Topology default: the
    one-peer exponential graph for ppermute (the only kind that is a
    permutation mix), the paper's n random in-neighbors for the matrix
    contraction."""
    kind = args.topology or \
        ("exponential" if gossip == "ppermute" else "random")
    return make_algo_spec(
        "dfedpgp", topology=kind, n_neighbors=args.neighbors,
        seed=args.seed, gossip=gossip, resident=args.resident,
        participation="uniform" if args.sample < 1.0 else "full",
        participation_frac=args.sample, telemetry=args.telemetry,
        graph_every=args.graph_every)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Regime B: DFedPGP rounds of a transformer LM")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--k_u", type=int, default=1)
    ap.add_argument("--k_v", type=int, default=1)
    ap.add_argument("--neighbors", type=int, default=2)
    ap.add_argument("--gossip", default="matrix",
                    choices=["matrix", "ppermute"])
    ap.add_argument("--topology", default="",
                    choices=["", "random", "exponential", "ring", "full"],
                    help="mixing schedule kind (default: exponential for "
                         "ppermute, random otherwise)")
    ap.add_argument("--seed", type=int, default=0,
                    help="schedule seed (random kinds)")
    ap.add_argument("--resident", action="store_true",
                    help="train on the resident (m, d_flat) flat buffer "
                         "(FlatDFedPGPState)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (smoke) variant of the arch")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sample", type=float, default=1.0,
                    help="participation fraction per round: < 1 draws a "
                         "seeded uniform subset each round and runs the "
                         "compact sampled step (needs --resident)")
    ap.add_argument("--telemetry", action="store_true",
                    help="round gauges (repro_torch.obs; needs "
                         "--resident): consensus gap, mass ledger, "
                         "grad/update norms ride the round metrics")
    ap.add_argument("--graph-every", type=int, default=0,
                    help="emit one schema-v2 collaboration-graph record "
                         "every N rounds (needs --telemetry)")
    ap.add_argument("--metrics", default="",
                    help="JSONL path: one schema round record per round "
                         "through obs.JsonlSink (render with `python -m "
                         "repro_torch.obs.report <path>`)")
    ap.add_argument("--profile", default="",
                    help="trace directory: wrap the round loop in "
                         "torch.profiler (obs.maybe_trace)")
    ap.add_argument("--device", default="cuda",
                    help="where every client lives: 'cuda' (default; "
                         "raises without a GPU) or 'cpu'")
    return ap


class Trainer:
    """One Regime-B run built from the parsed CLI flags: the model config,
    the DFedPGP instance (`steps.build_train_algo`), the schedule and
    sampler of the run's one AlgoSpec, and the state on `device`.
    `step(r)` runs round r; `main` loops it and emits the records."""

    def __init__(self, args, ap=None):
        ap = ap or build_parser()
        self.device = resolve_device(args.device)
        cfg = get_reduced(args.arch) if args.reduced \
            else get_config(args.arch)
        m = args.clients
        if m * args.tp > 1:
            print(f"[train] note: {m}x{args.tp} logical > 1 devices; "
                  f"running unsharded on 1 device(s)")
        gossip = args.gossip
        if gossip == "ppermute":
            print("[train] note: ppermute needs the client mesh; "
                  "falling back to matrix gossip")
            gossip = "matrix"
        if not 0.0 < args.sample <= 1.0:
            ap.error(f"--sample {args.sample}: want a fraction in (0, 1]")
        sampled = args.sample < 1.0
        if sampled and not args.resident:
            ap.error("--sample < 1 gathers/scatters the resident flat "
                     "buffer; add --resident")
        if args.telemetry and not args.resident:
            ap.error("--telemetry gauges read the resident flat buffer; "
                     "add --resident")
        if args.graph_every and not args.telemetry:
            ap.error("--graph-every emits through the telemetry spine; "
                     "add --telemetry")
        self.args, self.cfg, self.m = args, cfg, m
        self.spec = make_cli_spec(args, gossip)
        # the schedule the loop mixes over and the sampler it draws from
        # resolve from the SAME spec `build_train_algo` consumes
        self.schedule = self.spec.schedule(m)
        self.sampler = self.spec.sampler(m)
        self.layout = mesh_mod.one_device_layout(m, args.batch)
        self.algo, self.mask, _, self.flat_layout = steps.build_train_algo(
            cfg, None, self.layout, k_u=args.k_u, k_v=args.k_v,
            spec=self.spec, lr=0.02)
        self.n_lead = self.sampler.n_active if self.sampler is not None \
            else m
        stacked = init_stacked(cfg, m, self.device)
        self.d_client = partition.count_params(stacked) // m
        self.d_shared = partition.count_params(stacked, self.mask, True) // m
        if args.resident:
            self.state, self.flat_layout = self.algo.init_flat(
                stacked, self.flat_layout, device=self.device)
        else:
            self.state = self.algo.init(stacked, device=self.device)

    def batches(self, r: int) -> dict:
        """Round r's synthetic batches on the device: {'v': (n, K_v, B,
        S), 'u': (n, K_u, B, S)} for the round's n clients."""
        gen = seeded_generator(0, DATA_STREAM, r + 1, self.device)
        a = self.args
        return {"v": synth_lm_batch(gen, self.cfg,
                                    (self.n_lead, a.k_v, a.batch), a.seq),
                "u": synth_lm_batch(gen, self.cfg,
                                    (self.n_lead, a.k_u, a.batch), a.seq)}

    def topology(self, r: int):
        """(round r's CPU table, the sorted active ids or None): the
        schedule's table, induced on the round's participants when
        sampling."""
        if self.sampler is None:
            return self.schedule.at(r), None
        active = self.sampler.active_at(r)
        return topology.induced_subgraph(self.schedule.at(r), active,
                                         "row"), active

    def step(self, r: int, batches=None):
        """Round r on the device: -> (metrics, CPU table, active ids or
        None).  `batches` replaces the round's draw (parity runs hand in
        another run's)."""
        P, active = self.topology(r)
        b = self.batches(r) if batches is None else batches
        dev_P = P.to(self.device)
        if active is not None:
            act = torch.as_tensor(active, device=self.device)
            self.state, metrics = self.algo.round_fn_sampled(
                self.state, dev_P, act, b, self.flat_layout)
        elif self.args.resident:
            self.state, metrics = self.algo.round_fn_flat(
                self.state, dev_P, b, self.flat_layout)
        else:
            self.state, metrics = self.algo.round_fn(self.state, dev_P, b)
        return metrics, P, active


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    run = Trainer(args, ap)
    cfg, m = run.cfg, run.m
    print(f"[train] {cfg.arch_id} family={cfg.family} clients={m} "
          f"params/client={run.d_client:,} shared={run.d_shared:,} "
          f"topology={run.schedule.kind} resident={args.resident}"
          + (f" sample={args.sample} ({run.n_lead}/{m})"
             if run.sampler is not None else ""))

    # one record per round through the telemetry spine: the printed line
    # IS the record's rendered form
    sink = obs.JsonlSink(args.metrics) if args.metrics else obs.NULL_SINK
    run_id = f"trainB-{cfg.arch_id}-seed{args.seed}"
    wire_rb = obs_gauges.payload_row_bytes(None, run.d_shared)
    wire_total = 0
    timer = obs.PhaseTimer()
    with obs.maybe_trace(args.profile or None):
        for r in range(args.rounds):
            with timer.phase("data"):
                batches = run.batches(r)
            with timer.phase("round", block=True) as ph:
                metrics, P_r, active = run.step(r, batches)
                ph.out = metrics
            host = obs_gauges.to_host(metrics)
            wire_total += obs_gauges.edge_count(P_r) * wire_rb
            rec = obs.round_record(
                run=run_id, algo="dfedpgp", step=r, m=m,
                loss=host["loss_u"], wire_bytes=wire_total,
                round_s=timer.seconds("round"), **timer.gauges(), **host)
            timer.reset()
            sink.emit(rec)
            if args.graph_every and (r + 1) % args.graph_every == 0:
                from ..obs import graph as obs_graph
                s = run.state
                obs_graph.emit_graph_record(
                    sink, run_id=run_id, algo="dfedpgp", m=m,
                    seed=args.seed, schedule=run.schedule, step=r, t0=r,
                    flat=s.flat, mu=s.mu, personal=s.personal,
                    active=active)
            print(f"[train] {obs.record.render(rec)} "
                  f"loss_v={rec['loss_v']:.4f} "
                  f"mu=[{rec['mu_min']:.3f},{rec['mu_max']:.3f}]")
    sink.close()
    if args.metrics:
        print(f"[train] metrics -> {args.metrics} "
              f"(render: python -m repro_torch.obs.report {args.metrics})")
    return run.state


if __name__ == "__main__":
    main()
