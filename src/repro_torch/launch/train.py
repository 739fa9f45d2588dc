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

`--ranks W` spawns W processes joined in one `torch.distributed` group
(`launch/ranks.py`: NCCL on the card, gloo on the CPU, a file
rendezvous), or joins the group torchrun's environment describes.  With
`--tp T` the W ranks form the client mesh (data W / T, model T): each
data index holds a block of m / (W / T) clients, and its T model ranks
split those clients' models (`launch/tp.py`, every family).  The
schedule and the batch draws are the same on every rank, each slicing
its rows.  The mix crosses data indices: `--gossip ppermute` the
permutation mix (tree form or --resident), `--gossip matrix` the
resident matrix mix.  With
`--sample f` each rank steps the round's active clients of its block,
their compact mix crosses ranks (`--gossip matrix`) and each row goes
back on its owner.  The rounds reduce their losses, mu range and
`--telemetry` gauges over the mesh; `--graph-every` snapshots the buffer
where its rows live.  Rank 0 prints and emits the records.

Usage (the reduced smoke config on the CPU, a few rounds, synthetic LM
data):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --rounds 4 --clients 4 --batch 2 --seq 128 --reduced --device cpu \\
      [--topology random|exponential|ring|full] [--resident] [--sample 0.5]
and on the card at full width:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --clients 4 --resident
and over two gloo ranks on the CPU, or four as (data 2, model 2):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --clients 4 --resident --ranks 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --clients 8 --resident --sample 0.5 --telemetry \\
      --ranks 4 --tp 2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

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
from . import ranks, steps, tp

# streams of `device.seeded_generator`: client i's init is (0, INIT, i),
# round r's batches (0, DATA, r + 1)
INIT_STREAM = 21
DATA_STREAM = 22


def synth_lm_batch(generator: torch.Generator, cfg, lead, seq: int) -> dict:
    """Synthetic next-token data with learnable structure (the labels are
    the tokens shifted by one), drawn from `generator` on its device:
    tokens and labels (*lead, seq) int64, and drawn after them the vlm
    family's stub vision embeddings (*lead, n_vision_tokens, d_model) or
    the encdec family's stub frame embeddings (*lead, n_frames, d_model),
    f32."""
    toks = torch.randint(0, cfg.vocab, tuple(lead) + (seq,),
                         generator=generator, device=generator.device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    extra = {"vlm": ("vision", cfg.n_vision_tokens),
             "encdec": ("frames", cfg.n_frames)}.get(cfg.family)
    if extra is not None:
        name, n = extra
        batch[name] = torch.randn(tuple(lead) + (n, cfg.d_model),
                                  generator=generator,
                                  device=generator.device)
    return batch


def init_stacked(cfg, m: int, device, rows=None) -> dict:
    """The stacked params of the clients `rows` (a range; default all m),
    client i drawn from `seeded_generator(0, INIT_STREAM, i)` on `device`
    and copied into its slot (one client's tree beside the stack at a
    time): a rank of a client mesh draws its block only."""
    api = get_model(cfg)
    rows = range(m) if rows is None else rows
    stacked = None
    for slot, i in enumerate(rows):
        one = api.init_params(seeded_generator(0, INIT_STREAM, i, device),
                              cfg, device=device)
        if stacked is None:
            stacked = tree_map(lambda a: torch.empty(
                (len(rows),) + tuple(a.shape), dtype=a.dtype,
                device=a.device), one)
        tree_map(lambda s, a: s[slot].copy_(a), stacked, one)
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
    ap.add_argument("--tp", type=int, default=1,
                    help="with --ranks: T model ranks split each client's "
                         "model (tensor parallelism; W %% T == 0, the dense "
                         "and vlm families); without --ranks a note only")
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
    ap.add_argument("--no-remat", dest="remat", action="store_false",
                    help="keep every block's activations for the backward "
                         "(the config's remat off; the full-width configs "
                         "rematerialize each block, as the reference's)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="W > 0: spread the clients over W processes of "
                         "one process group (NCCL on the card, gloo on "
                         "the CPU), each a contiguous block of m / W; the "
                         "mixes cross ranks")
    return ap


def check_ranks_args(ap, args, world: int) -> None:
    """The flags a run over `world` ranks refuses (before any process
    starts)."""
    if world < 1:
        ap.error(f"--ranks {world}: want at least one rank")
    T = args.tp
    if T < 1 or world % T:
        ap.error(f"--ranks {world} --tp {T}: the client mesh wants "
                 f"W % T == 0 (whole data indices)")
    try:
        ranks.row_range(args.clients, world // T, 0)
    except ValueError as e:
        ap.error(f"--ranks {world} --tp {T}: {e}")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    try:
        tp.check_tp(cfg, T)
    except ValueError as e:
        ap.error(f"--tp {T}: {e}")
    check_flags(ap, args, args.gossip)
    if args.gossip == "matrix" and not args.resident:
        ap.error("--gossip matrix with --ranks mixes the resident buffer: "
                 "add --resident (or use --gossip ppermute)")


def check_flags(ap, args, gossip: str) -> None:
    """The reference's refusals of participation and telemetry flags, for
    the mix `gossip` the run takes (one device falls back to "matrix")."""
    if not 0.0 < args.sample <= 1.0:
        ap.error(f"--sample {args.sample}: want a fraction in (0, 1]")
    sampled = args.sample < 1.0
    if sampled and not args.resident:
        ap.error("--sample < 1 gathers/scatters the resident flat "
                 "buffer; add --resident")
    if sampled and gossip == "ppermute":
        ap.error("--sample < 1 mixes the compact working set; ppermute "
                 "offsets address all m shards — use --gossip matrix")
    if args.telemetry and not args.resident:
        ap.error("--telemetry gauges read the resident flat buffer; "
                 "add --resident")
    if args.graph_every and not args.telemetry:
        ap.error("--graph-every emits through the telemetry spine; "
                 "add --telemetry")


class Trainer:
    """One Regime-B run built from the parsed CLI flags: the model config,
    the DFedPGP instance (`steps.build_train_algo`), the schedule and
    sampler of the run's one AlgoSpec, and the state on `device`.
    `step(r)` runs round r; `main` loops it and emits the records."""

    def __init__(self, args, ap=None, mesh=None):
        ap = ap or build_parser()
        self.mesh = mesh
        self.device = resolve_device(args.device) if mesh is None \
            else mesh.device
        cfg = get_reduced(args.arch) if args.reduced \
            else get_config(args.arch)
        if not args.remat:
            cfg = cfg.replace(remat=False)
        m = args.clients
        gossip = args.gossip
        if mesh is not None:
            check_ranks_args(ap, args, mesh.world * mesh.shape["model"])
            self.rows = range(*mesh.rows)
        else:
            self.rows = range(m)
            if m * args.tp > 1:
                print(f"[train] note: {m}x{args.tp} logical > 1 devices; "
                      f"running unsharded on 1 device(s)")
            if gossip == "ppermute":
                print("[train] note: ppermute needs the client mesh; "
                      "falling back to matrix gossip")
                gossip = "matrix"
        check_flags(ap, args, gossip)
        self.args, self.cfg, self.m = args, cfg, m
        self.spec = make_cli_spec(args, gossip)
        # the schedule the loop mixes over and the sampler it draws from
        # resolve from the SAME spec `build_train_algo` consumes
        self.schedule = self.spec.schedule(m)
        self.sampler = self.spec.sampler(m)
        self.layout = mesh_mod.one_device_layout(m, args.batch)
        self.algo, self.mask, _, self.flat_layout = steps.build_train_algo(
            cfg, mesh, self.layout, k_u=args.k_u, k_v=args.k_v,
            spec=self.spec, lr=0.02)
        self.n_lead = self.sampler.n_active if self.sampler is not None \
            else m
        stacked = init_stacked(cfg, m, self.device, self.rows)
        n = len(self.rows)
        self.d_client = partition.count_params(stacked) // n
        self.d_shared = partition.count_params(stacked, self.mask, True) // n
        # a client mesh's rank keeps its shard of every client
        # (`algo.tp`, launch/tp.py)
        shards = self.algo.tp
        if args.resident:
            self.state, self.flat_layout = self.algo.init_flat(
                stacked, self.flat_layout, device=self.device)
            del stacked
            if shards is not None:
                self.state = shards.shard_state(self.state)
        else:
            if shards is not None:
                stacked = shards.shard(stacked)
            self.state = self.algo.init(stacked, device=self.device)

    def batches(self, r: int) -> dict:
        """Round r's synthetic batches on the device: {'v': (n, K_v, B,
        S), 'u': (n, K_u, B, S)} for the round's n clients (on a client
        mesh the rank's own: its block, or under sampling its compact
        rows [a_q, a_{q+1}) of `ranks.compact_bounds`)."""
        gen = seeded_generator(0, DATA_STREAM, r + 1, self.device)
        a = self.args
        b = {"v": synth_lm_batch(gen, self.cfg,
                                 (self.n_lead, a.k_v, a.batch), a.seq),
             "u": synth_lm_batch(gen, self.cfg,
                                 (self.n_lead, a.k_u, a.batch), a.seq)}
        if self.mesh is None:
            return b
        # every rank draws every client's batch and keeps its own rows
        lo, hi = self.mesh.rows
        if self.sampler is not None:
            q = self.mesh.data_index
            bounds = ranks.compact_bounds(self.sampler.active_at(r), self.m,
                                          self.mesh.world)
            lo, hi = bounds[q], bounds[q + 1]
        return tree_map(lambda x: x[lo:hi], b)

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
        # the cross-rank mixes plan from the full table and ids on the host
        dev_P = P.to(self.device) if self.mesh is None else P
        if active is not None:
            act = torch.as_tensor(active, device=self.device) \
                if self.mesh is None else active
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
    env = ranks.from_environment()
    if args.ranks and env is None:
        check_ranks_args(ap, args, args.ranks)
        return spawn(sys.argv[1:] if argv is None else argv, args.ranks)
    if env is None:
        return run_rank(args, ap)
    rank, world = env
    mesh = _join(args, rank, world, None)
    try:
        return run_rank(args, ap, mesh)
    finally:
        ranks.shutdown()


def _join(args, rank: int, world: int, init_file):
    """This process's rank of the group and its client mesh."""
    ranks.init(rank, world, init_file, args.device)
    return mesh_mod.make_host_mesh(args.clients, model=args.tp)


def _rank_main(rank: int, argv, world: int, init_file: str) -> None:
    """One spawned rank of `spawn`."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = _join(args, rank, world, init_file)
    try:
        run_rank(args, ap, mesh)
    finally:
        ranks.shutdown()


def spawn(argv, world: int) -> None:
    """Run the trainer over `world` processes started here (spawned, one
    a rank), their rendezvous a file in a fresh temporary directory."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        mp.spawn(_rank_main, args=(list(argv), world,
                                   os.path.join(tmp, "rendezvous")),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_rank(args, ap, mesh=None):
    """The trainer's loop in this process: every client on one device
    (mesh None), or this rank's block of a client mesh.  -> the state
    (the rank's block)."""
    run = Trainer(args, ap, mesh)
    cfg, m = run.cfg, run.m
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        say(f"[train] ranks={mesh.world * mesh.shape['model']} "
            f"clients/rank={mesh.n_local} "
            f"backend={ranks.backend_for(mesh.device)} gossip={args.gossip} "
            f"data={mesh.world} model={mesh.shape['model']}")
    say(f"[train] {cfg.arch_id} family={cfg.family} clients={m} "
        f"params/client={run.d_client:,} shared={run.d_shared:,} "
        f"topology={run.schedule.kind} resident={args.resident}"
        + (f" sample={args.sample} ({run.n_lead}/{m})"
           if run.sampler is not None else ""))

    # one record per round through the telemetry spine: the printed line
    # IS the record's rendered form
    sink = obs.JsonlSink(args.metrics) if args.metrics and lead \
        else obs.NULL_SINK
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
                    active=active, ranks=run.algo.across_ranks)
            say(f"[train] {obs.record.render(rec)} "
                f"loss_v={rec['loss_v']:.4f} "
                f"mu=[{rec['mu_min']:.3f},{rec['mu_max']:.3f}]")
    sink.close()
    if args.metrics:
        say(f"[train] metrics -> {args.metrics} "
            f"(render: python -m repro_torch.obs.report {args.metrics})")
    return run.state


if __name__ == "__main__":
    main()
