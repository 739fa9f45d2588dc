"""FL simulation engine (Regime A) — port of `repro/fl/simulator.py` on one
device: the synchronous rounds and the asynchronous regime.

`run_experiment(algo, SimConfig())` builds the synthetic non-IID data, m
stacked CNN clients and the classifier-personal mask, then runs the rounds
of one of `ALGOS`: DFedPGP or one of the paper's baselines
(`core.baselines`).  Personalized test accuracy is evaluated on each
client's own test split.

- "dfedpgp" packs the shared part once (`DFedPGP.init_flat`) and each round
  runs all clients' local steps, then the push-pull mix of the buffer
  through the CUDA gossip_gather kernel.  Variants: `participation=
  "uniform"|"trace"` (`DFedPGP.round_fn_sampled` over the induced subgraph;
  the CUDA gossip_scatter kernel writes the active rows back),
  `resident=False` (the tree-form `DFedPGP.round_fn`), and a wire `codec`
  (`repro_torch.compress`; under `gossip="pallas"` sparse payloads mix
  through the CUDA topk_gather kernel).
- The DFL baselines gossip their stacked trees through `gossip.mix_tree`
  (one gossip_gather launch a round); "dfedavgm", "dfedavgm-p" and
  "dispfl" always take the undirected schedule.  With a codec, "osgp" and
  "dfedavgm" run on their flat-core (`build_flat_core`: DFedPGP with an
  all-shared mask and no personal phase), with or without participation.
- The CFL baselines and "local" draw no topology: each round a CFL run
  samples `sample_ratio * m` clients (`baselines.sample`, a CPU generator
  per round, so every device draws the same sample).
`step_gates` (m, K) gate local steps per client (the sync computation
heterogeneity of the paper's Table 3, `hetero.profiles.tier_gates`).

`runtime="async"` runs dfedpgp, osgp or dfedavgm (`ASYNC_ALGOS`) on the
virtual clock of `hetero.runtime.AsyncRuntime` instead (`async_experiment`):
a round becomes a window of k_local + k_personal ticks, each client steps at
its profile's speed (`SimConfig.hetero`, `speed_spread`, `availability`)
and pushes its mass through delayed mailboxes (`push_delay_max`,
`mailbox_depth`) over the lazy push form of the tick's table
(`topology.to_push_sparse`, per-sender shares with `stale_discount`).
Every fire mixes through the CUDA gossip_gather kernel once per delay
group; a lossy codec under gossip="pallas" adds topk_gather.

The algorithm's knobs are one `spec.AlgoSpec`: `SimConfig(spec=...)`, or
the legacy SimConfig fields funneled through the same factory
(`resolve_spec`; a spec next to a non-default legacy knob raises).
`spec.telemetry` adds the round gauges to the resident rounds' and the
ticks' metrics, and a `sink=` (`repro_torch.obs`) receives one "round" or
"tick" record per round or window (one device sync each), plus a "graph"
record every `spec.graph_every` rounds.

The injection arguments (`data=`, `init_params=`, `init_state=`,
`topology_at=`, `batches_at=`, `sampled_at=`) replay another run's draws —
the reference's data, initial parameters or state, neighbor tables,
minibatches and CFL samples (async: the participation masks, and every
hook takes the tick index) — so a test can compare the two engines step
for step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import obs, tree
from .. import spec as spec_mod
from ..core import baselines, dfedpgp, gossip, partition, topology
from ..core.topology import SparseTopology
from ..data import ClientData, from_arrays, make_dataset, sample_batches
from ..device import resolve_device, seeded_generator
from ..hetero import mailbox as mbox
from ..hetero import profiles
from ..hetero.runtime import AsyncRuntime
from ..models import cnn
from ..obs import gauges
from ..obs import graph as obs_graph
from ..optim import SGD
from . import compat


@dataclasses.dataclass(frozen=True)
class SimConfig:
    m: int = 100                    # clients
    n_neighbors: int = 10           # DFL gossip degree
    sample_ratio: float = 0.1       # CFL client sampling ratio
    rounds: int = 100
    batch: int = 32
    k_local: int = 5                # shared-part local steps
    k_personal: int = 1             # personal-part steps
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay: float = 0.99
    n_classes: int = 10
    dist: str = "dirichlet"         # dirichlet | pathological
    alpha: float = 0.3
    c: int = 2
    n_train: int = 64
    n_test: int = 32
    image_size: int = 8
    noise: float = 0.7
    seed: int = 0
    topology: str = "random"        # a TopologySchedule kind

    gossip: str = "sparse"          # sparse | dense | pallas
    resident: bool = True           # False: the tree-form round
    runtime: str = "sync"           # sync | async (virtual-clock ticks)
    # the simulated fleet: the profile a "trace" sampler ranks by
    hetero: str = "uniform"         # uniform | tiered | lognormal
    speed_spread: float = 5.0
    push_delay_max: int = 0
    availability: float = 1.0
    mailbox_depth: int = 4          # async delivery ring (>= delays + 1)
    # wire codecs (item 10)
    codec: Optional[str] = None
    codec_ratio: float = 1.0 / 16.0
    codec_bits: int = 4
    codec_gamma: object = 1.0
    # partial participation: "full" | "uniform" | "trace"
    participation: str = "full"
    participation_frac: float = 1.0
    # async: slow-link senders keep more of their mass at home
    # (topology.staleness_self_weight) instead of the flat 1/2
    stale_discount: bool = False
    # the one knob surface (spec.AlgoSpec): when set, the legacy knob
    # fields above (topology, n_neighbors, gossip, resident, codec*,
    # participation*) must stay at their defaults — resolve_spec raises
    spec: Optional[spec_mod.AlgoSpec] = None


# algo names, as the reference's `simulator.ALGOS`
ALGOS = ("local", "fedavg", "fedper", "fedrep", "fedbabu", "ditto",
         "dfedavgm", "dfedavgm-p", "osgp", "dispfl", "dfedpgp")
CFL = ("fedavg", "fedper", "fedrep", "fedbabu", "ditto")
# algorithms whose mixing must be symmetric (no push-sum de-bias): their
# schedule is the undirected kind whatever the topology knob says
UNDIRECTED_ALGOS = spec_mod.UNDIRECTED_ALGOS
RUNTIMES = ("sync", "async")
# the push-sum methods the async runtime drives
ASYNC_ALGOS = ("dfedpgp", "osgp", "dfedavgm")
# the baselines with a flat-buffer core (build_flat_core)
FLAT_CORE_ALGOS = ("osgp", "dfedavgm")
# stream of `device.seeded_generator` the CFL client sample draws from
CFL_STREAM = 4

# stream of `device.seeded_generator` the minibatches draw from (a round's
# in the sync regime, a tick's in the async one)
BATCH_STREAM = 2
# legacy SimConfig fields the spec owns (resolve_spec's conflict check)
_SPEC_KNOBS = ("topology", "n_neighbors", "gossip", "resident", "codec",
               "codec_ratio", "codec_bits", "codec_gamma",
               "participation", "participation_frac")


def resolve_spec(algo_name: str, sim: SimConfig) -> spec_mod.AlgoSpec:
    """The run's one AlgoSpec.  `SimConfig(spec=...)` wins, but only when
    the legacy knobs sit at their defaults — two copies that could
    disagree raise instead.  Without a spec, the legacy fields go through
    the one factory (`compat.spec_from_sim`)."""
    if sim.spec is not None:
        defaults = {f.name: f.default for f in dataclasses.fields(SimConfig)}
        clash = [k for k in _SPEC_KNOBS if getattr(sim, k) != defaults[k]]
        if clash:
            raise ValueError(
                f"SimConfig(spec=...) conflicts with legacy knob(s) "
                f"{clash}: the spec owns them now — drop the duplicated "
                f"SimConfig fields (or drop spec= to keep the deprecated "
                f"surface)")
        if sim.spec.algo != algo_name:
            raise ValueError(
                f"spec.algo={sim.spec.algo!r} but the experiment runs "
                f"{algo_name!r}; one spec describes one algorithm")
        return sim.spec
    return compat.spec_from_sim(sim, algo_name)


def _spec_view(sim: SimConfig, sp: spec_mod.AlgoSpec) -> SimConfig:
    """sim with its legacy knob fields set to the spec's values (spec
    None), the form build_algorithm and build_flat_core read."""
    return dataclasses.replace(
        sim, spec=None, **{k: getattr(sp, k) for k in _SPEC_KNOBS})


# the deprecated knob-surface helpers live in fl/compat.py; PEP 562 keeps
# `simulator.make_schedule(...)` and the others reachable
_DEPRECATED = ("make_sim_codec", "make_schedule", "make_sampler")


def __getattr__(name):
    if name in _DEPRECATED:
        return getattr(compat, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _sgd(sim: SimConfig) -> SGD:
    return SGD(lr=sim.lr, momentum=sim.momentum,
               weight_decay=sim.weight_decay)


_PARTIAL_MODES = {"fedper": "per", "fedrep": "rep", "fedbabu": "babu"}


def build_algorithm(name: str, loss_fn, mask: dict, sim: SimConfig,
                    codec=None, telemetry: bool = False):
    """algo name -> its round engine (`core.baselines` or DFedPGP); codec
    is DFedPGP's wire codec, telemetry its round gauges."""
    kw = dict(loss_fn=loss_fn, opt=_sgd(sim), lr_decay=sim.lr_decay)
    if name == "local":
        return baselines.LocalOnly(**kw)
    if name == "fedavg":
        return baselines.FedAvg(sample_ratio=sim.sample_ratio, **kw)
    if name in ("fedper", "fedrep", "fedbabu"):
        extra = dict(k_head=sim.k_personal) if name == "fedrep" else {}
        return baselines.FedPartial(mask=mask, mode=_PARTIAL_MODES[name],
                                    sample_ratio=sim.sample_ratio, **extra,
                                    **kw)
    if name == "ditto":
        return baselines.Ditto(sample_ratio=sim.sample_ratio, **kw)
    if name == "dfedavgm":
        return baselines.DFedAvgM(**kw)
    if name == "dfedavgm-p":
        return baselines.DFedAvgM(partial_mask=mask, **kw)
    if name == "osgp":
        return baselines.OSGP(**kw)
    if name == "dispfl":
        return baselines.DisPFL(**kw)
    if name == "dfedpgp":
        return dfedpgp.DFedPGP(
            loss_fn=loss_fn, mask=mask, opt_u=kw["opt"], opt_v=kw["opt"],
            k_v=sim.k_personal, k_u=sim.k_local, lr_decay=sim.lr_decay,
            gossip=sim.gossip, codec=codec, codec_gamma=sim.codec_gamma,
            telemetry=telemetry)
    raise ValueError(f"unknown algorithm {name!r}; known: {ALGOS}")


def build_flat_core(name: str, loss_fn, mask: dict, sim: SimConfig,
                    codec=None, telemetry: bool = False) -> dfedpgp.DFedPGP:
    """The flat-engine push-sum core behind osgp / dfedavgm: DFedPGP that
    gossips the FULL model (all-shared mask, k_v = 0, k_u = k_local +
    k_personal), so their rounds are the k_v = 0 specialization of
    Algorithm 1.  The sync regime runs them when a wire codec is requested
    (codecs live on the resident flat buffer).  dfedpgp itself is built by
    `build_algorithm`."""
    if name not in FLAT_CORE_ALGOS:
        raise ValueError(
            f"the flat push-sum core drives {FLAT_CORE_ALGOS}; {name!r} "
            f"has no flat-buffer core (dfedpgp is built by "
            f"build_algorithm)")
    opt = _sgd(sim)
    return dfedpgp.DFedPGP(
        loss_fn=loss_fn, mask=tree.tree_map(lambda _: True, mask),
        opt_u=opt, opt_v=opt, k_v=0, k_u=sim.k_local + sim.k_personal,
        lr_decay=sim.lr_decay,
        gossip="pallas" if sim.gossip == "pallas" else "sparse",
        codec=codec, codec_gamma=sim.codec_gamma, telemetry=telemetry)


def evaluate(eval_params: dict, data: ClientData, model_cfg: cnn.CNNConfig):
    """-> (mean personalized accuracy, (m,) per-client accuracy)."""
    with torch.no_grad():
        acc = vmap(lambda p, x, y: cnn.accuracy(p, x, y, model_cfg))(
            eval_params, data.x_test, data.y_test)
    return float(acc.mean()), acc.cpu().numpy()


def _as_topology(P) -> SparseTopology:
    """A SparseTopology or (idx, w) arrays -> CPU tables."""
    if isinstance(P, SparseTopology):
        return P.to("cpu")
    idx, w = P
    return SparseTopology(torch.as_tensor(np.asarray(idx), dtype=torch.int32),
                          torch.as_tensor(np.asarray(w), dtype=torch.float32))


def _as_batches(b: dict, device) -> dict:
    return {"x": torch.as_tensor(np.asarray(b["x"]), dtype=torch.float32,
                                 device=device),
            "y": torch.as_tensor(np.asarray(b["y"]), dtype=torch.int64,
                                 device=device)}


def _split_vu(b: dict, kv: int) -> dict:
    """A round's (m, K, ...) batches -> DFedPGP's v steps (the first kv)
    and u steps."""
    return {"v": {k: a[:, :kv] for k, a in b.items()},
            "u": {k: a[:, kv:] for k, a in b.items()}}


def _trace_profile(sim: SimConfig):
    """The availability profile a trace-driven sampler ranks by, built
    from the fleet knobs; None for the other participation kinds."""
    if sim.participation != "trace":
        return None
    return profiles.make_profile(
        sim.hetero, sim.m, spread=sim.speed_spread,
        push_delay_max=sim.push_delay_max,
        availability=sim.availability, seed=sim.seed)


def run_experiment(algo_name: str, sim: SimConfig,
                   model_cfg: Optional[cnn.CNNConfig] = None, *,
                   device="cuda", eval_every: int = 10,
                   verbose: bool = False, return_state: bool = False,
                   return_params: bool = False,
                   step_gates=None, sink=None,
                   data: Optional[ClientData] = None,
                   init_params: Optional[dict] = None,
                   init_state=None,
                   topology_at: Optional[Callable] = None,
                   batches_at: Optional[Callable] = None,
                   sampled_at: Optional[Callable] = None) -> dict:
    """Returns the history dict: per-eval `round`, `acc`, `loss` (the round
    metrics' "loss", DFedPGP's "loss_u"), `vtime` (lockstep ticks, (r + 1)
    * (k_local + k_personal)) and `wire_bytes` (cumulative bytes on the
    wire: a lossy codec's reference bootstrap, then per round every
    payload-carrying non-self edge times the payload's bytes,
    `obs.gauges`; codec=None meters the uncompressed f32 rows of the
    gossiped part — the shared part for dfedpgp and dfedavgm-p, the whole
    model otherwise; CFL and local runs meter 0), plus `final_acc` and
    per-round wall seconds `round_s` (each round ends in a device sync on
    CUDA).  return_state adds the final state and, for the resident runs,
    its FlatLayout (`state`, `layout`; the layout is None otherwise) — the
    resident DFedPGP state is what the serve path takes; return_params
    adds the final personalized models (`params`).  verbose prints each
    evaluation.  step_gates: (m, K) per-client step gates; dfedpgp gates
    its k_local shared steps with the first k_local columns, the other
    algorithms all k_local + k_personal steps.

    sink: an `obs.MetricsSink` — every round then emits one "round"
    record (the round metrics, the wire meter, the phase times and, with
    spec.telemetry, the gauges; fetching them costs one device sync per
    round), and with spec.graph_every a "graph" record every that many
    rounds on the resident runs.

    Replay injection (test plumbing): `data` — a ClientData or a 5-tuple
    of arrays; `init_params` — stacked (m, ...) params dict; `init_state`
    — a tree-form baseline's initial state (e.g.
    `convert.baseline_state_from_reference`), in place of `algo.init`;
    `topology_at` — t -> SparseTopology or (idx, w) arrays; `batches_at` —
    t -> {"x": (m, K, B, H, W, C), "y": (m, K, B)} arrays; `sampled_at` —
    t -> the CFL round's (m,) 0/1 sampled-client indicator.

    runtime="async" (`async_experiment`): a round is a window of k_local +
    k_personal ticks; `vtime` is the virtual clock, history adds
    `mean_local_rounds` (the mean completed local rounds) and `round_s` is
    per window; the hooks take the tick index t: `batches_at(t)` leaves
    (m, 1, B, ...), `topology_at(t)` the tick's PULL table (the run
    applies `to_push_sparse`) and `sampled_at(t)` the (m,) participation
    mask (participation != "full")."""
    if algo_name not in ALGOS:
        raise ValueError(f"unknown algorithm {algo_name!r}; known: {ALGOS}")
    sp = resolve_spec(algo_name, sim)
    if sp.gossip not in gossip.MODES:
        raise ValueError(
            f"gossip mode {sp.gossip!r}: Regime A mixes through the "
            f"matrix engines {gossip.MODES}; 'ppermute' is the sharded "
            f"trainer's mix")
    sim = _spec_view(sim, sp)
    if sim.runtime not in RUNTIMES:
        raise ValueError(f"runtime {sim.runtime!r}; known: sync | async")
    run_async = sim.runtime == "async"
    if run_async:
        if step_gates is not None:
            raise ValueError(
                "step_gates are the sync regime's faked heterogeneity; "
                "the async runtime models speed via SimConfig.hetero")
        if algo_name not in ASYNC_ALGOS:
            raise ValueError(
                f"runtime='async' drives the push-sum flat engines "
                f"{ASYNC_ALGOS}; {algo_name!r} has no flat-buffer core")
    dev = resolve_device(device)
    codec = sp.make_codec()
    if codec is None and sim.codec_gamma != 1.0:
        raise ValueError(
            f"codec_gamma={sim.codec_gamma} only applies to lossy "
            f"codecs; set the codec or drop the knob")
    if codec is not None and algo_name not in ASYNC_ALGOS:
        raise ValueError(
            f"codec={sim.codec!r} rides the push-sum flat engines "
            f"{ASYNC_ALGOS}; {algo_name!r} has no wire-payload boundary "
            f"to compress")
    if codec is not None and not sim.resident and not run_async:
        raise ValueError("wire codecs live on the resident flat buffer; "
                         "resident=False has no payload boundary")
    # the resident flat buffer: dfedpgp's, or a flat-core codec run's
    use_flat = (algo_name == "dfedpgp" and sim.resident) or \
        (codec is not None and algo_name in FLAT_CORE_ALGOS)
    sampler = sp.sampler(sim.m, _trace_profile(sim))
    if sampler is not None and not use_flat and not run_async:
        raise ValueError(
            f"partial participation gathers and scatters the resident flat "
            f"buffer; {algo_name!r} with resident={sim.resident} has none "
            f"— use dfedpgp with resident=True (or a flat-core codec run)")
    k_total = sim.k_local + sim.k_personal
    gate = None
    if step_gates is not None:
        need_k = sim.k_local if algo_name == "dfedpgp" else k_total
        gate = torch.as_tensor(profiles.validate_step_gates(
            step_gates, sim.m, need_k)[:, :need_k], device=dev)
    model_cfg = model_cfg or cnn.CNNConfig(image_size=sim.image_size,
                                           n_classes=sim.n_classes)
    if data is None:
        data = make_dataset(sim.seed, sim.m, n_classes=sim.n_classes,
                            dist=sim.dist, alpha=sim.alpha, c=sim.c,
                            n_train=sim.n_train, n_test=sim.n_test,
                            size=sim.image_size, noise=sim.noise,
                            device=dev)
    elif isinstance(data, ClientData):
        data = data.to(dev)
    else:
        data = from_arrays(*data, device=dev)

    def loss_fn(p, batch):
        return cnn.loss_fn(p, batch, model_cfg)

    if init_params is None:
        stacked = cnn.init_params(seeded_generator(sim.seed, 1, 0),
                                  model_cfg, (sim.m,))
    else:
        stacked = tree.tree_map(
            lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32),
            init_params)
    mask = partition.build_mask(stacked, partition.classifier_personal)
    if run_async:
        return async_experiment(
            algo_name, sim, model_cfg, data, loss_fn, mask, stacked, dev,
            codec=codec, sampler=sampler, eval_every=eval_every,
            verbose=verbose, return_state=return_state,
            return_params=return_params, batches_at=batches_at,
            topology_at=topology_at, sampled_at=sampled_at, spec=sp,
            sink=sink)
    if sp.telemetry and not use_flat:
        raise ValueError(
            f"spec.telemetry gauges read the resident flat buffer; "
            f"{algo_name!r} with resident={sp.resident} has no buffer to "
            f"gauge (use dfedpgp with resident=True or a flat-core codec "
            f"run)")
    if codec is not None and algo_name in FLAT_CORE_ALGOS:
        algo = build_flat_core(algo_name, loss_fn, mask, sim, codec,
                               telemetry=sp.telemetry)
    else:
        algo = build_algorithm(algo_name, loss_fn, mask, sim, codec,
                               telemetry=sp.telemetry)
    schedule = None
    if algo_name not in CFL and algo_name != "local":
        schedule = sp.schedule(sim.m)
    layout = None
    if init_state is not None:
        if use_flat or isinstance(algo, dfedpgp.DFedPGP):
            raise ValueError("init_state replays a tree-form baseline's "
                             "state; DFedPGP and the flat-core runs start "
                             "from init_params")
        state = init_state
        eval_params = algo.eval_params
    elif use_flat:
        state, layout = algo.init_flat(stacked, device=dev)

        def eval_params(s):
            return algo.eval_params_flat(s, layout)
    else:
        state = algo.init(stacked, device=dev)
        eval_params = algo.eval_params
    if isinstance(algo, dfedpgp.DFedPGP):
        def round_fn(state, P, b, g):
            b = _split_vu(b, algo.k_v)
            if use_flat:
                return algo.round_fn_flat(state, P, b, layout,
                                          step_gate_u=g)
            return algo.round_fn(state, P, b, step_gate_u=g)
    else:
        def round_fn(state, ctx, b, g):
            return algo.round_fn(state, ctx, b, step_gate=g)

    # the wire meter: host arithmetic on the round's CPU tables
    wire_rb = wire_total = 0
    if schedule is not None:
        wire_mask = mask if algo_name in ("dfedpgp", "dfedavgm-p") \
            else tree.tree_map(lambda _: True, mask)
        d_wire = gossip.flat_width(stacked, wire_mask)
        wire_rb = gauges.payload_row_bytes(codec, d_wire)
        wire_total = gauges.bootstrap_bytes(codec, sim.m, d_wire)
    history = {"round": [], "acc": [], "loss": [], "vtime": [],
               "wire_bytes": [], "round_s": [], "algo": algo_name,
               "runtime": "sync", "device": str(dev)}
    run_id = f"{algo_name}-sync-seed{sim.seed}"
    timer = obs.PhaseTimer()
    t0 = time.perf_counter()
    for r in range(sim.rounds):
        active = None
        if batches_at is not None:
            batches = _as_batches(batches_at(r), dev)
        else:
            batches = sample_batches(seeded_generator(sim.seed, BATCH_STREAM,
                                                      r), data, k_total,
                                     sim.batch)
        g = gate
        if algo_name in CFL:
            ctx = torch.as_tensor(
                np.asarray(sampled_at(r)), dtype=torch.float32,
                device=dev) if sampled_at is not None else \
                baselines.sample(seeded_generator(sim.seed, CFL_STREAM, r),
                                 sim.m, sim.sample_ratio, dev)
        elif schedule is None:
            ctx = None
        else:
            ctx = _as_topology(topology_at(r) if topology_at is not None
                               else schedule.at(r))
            if sampler is not None:
                active = sampler.active_at(r)
                ctx = topology.induced_subgraph(ctx, active, "row")
                act = torch.as_tensor(active, device=dev)
                idx = act.long()
                batches = {k: a.index_select(0, idx)
                           for k, a in batches.items()}
                g = None if gate is None else gate.index_select(0, idx)
            # only active <-> active edges carry bytes
            wire_total += gauges.edge_count(ctx) * wire_rb
            ctx = ctx.to(dev)
            if sim.gossip == "dense" and sampler is None:
                ctx = ctx.dense()
        # the round ends in a device sync on CUDA (round_s)
        timer.reset()
        with timer.phase("round", block=True) as ph:
            if sampler is not None:
                state, metrics = algo.round_fn_sampled(
                    state, ctx, act, _split_vu(batches, algo.k_v), layout,
                    step_gate_u=g)
            else:
                state, metrics = round_fn(state, ctx, batches, g)
            ph.out = state
        history["round_s"].append(timer.seconds("round"))

        acc = None
        if (r + 1) % eval_every == 0 or r == sim.rounds - 1:
            with timer.phase("eval"):
                acc, _ = evaluate(eval_params(state), data, model_cfg)
            history["round"].append(r + 1)
            history["acc"].append(acc)
            history["vtime"].append(float((r + 1) * k_total))
            history["wire_bytes"].append(wire_total)
            history["loss"].append(float(metrics["loss"] if "loss" in
                                         metrics else metrics["loss_u"]))
            if verbose:
                print(f"[{algo_name}] round {r + 1:4d} acc={acc:.4f} "
                      f"({time.perf_counter() - t0:.1f}s)")
        if sink is not None:
            sink.emit(obs.round_record(
                run=run_id, algo=algo_name, step=r + 1, m=sim.m, acc=acc,
                vtime=float((r + 1) * k_total), wire_bytes=wire_total,
                **timer.gauges(), **gauges.to_host(metrics)))
            if sp.graph_every and (r + 1) % sp.graph_every == 0 \
                    and schedule is not None and use_flat:
                obs_graph.emit_graph_record(
                    sink, run_id=run_id, algo=algo_name, m=sim.m,
                    seed=sim.seed, schedule=schedule, step=r + 1, t0=r,
                    flat=state.flat, mu=state.mu, personal=state.personal,
                    active=active)
    history["final_acc"] = history["acc"][-1] if history["acc"] \
        else float("nan")
    if return_state:
        history["state"], history["layout"] = state, layout
    if return_params:
        history["params"] = eval_params(state)
    return history


# ---------------------------------------------------------------------------
# async regime: virtual-clock gossip
# ---------------------------------------------------------------------------
def build_async(algo_name: str, sim: SimConfig, loss_fn, mask: dict,
                stacked: dict, codec=None, device="cuda", spec=None):
    """The async run's engine and draws -> (runtime, state, schedule):
    the algorithm's flat push-sum core (dfedpgp's own partition and
    phases; osgp / dfedavgm on `build_flat_core`; the spec's telemetry),
    the profile from the fleet knobs, the mailbox ring of depth
    max(mailbox_depth, push_delay_max + 1), and the spec's
    TopologySchedule (undirected for dfedavgm)."""
    sp = spec if spec is not None else resolve_spec(algo_name, sim)
    if algo_name not in ASYNC_ALGOS:
        raise ValueError(
            f"runtime='async' drives the push-sum flat engines "
            f"{ASYNC_ALGOS}; {algo_name!r} has no flat-buffer core")
    profile = profiles.make_profile(
        sim.hetero, sim.m, spread=sim.speed_spread,
        push_delay_max=sim.push_delay_max, availability=sim.availability,
        seed=sim.seed)
    build = build_flat_core if algo_name in FLAT_CORE_ALGOS \
        else build_algorithm
    algo = build(algo_name, loss_fn, mask, sim, codec,
                 telemetry=sp.telemetry)
    depth = max(sim.mailbox_depth, sim.push_delay_max + 1)
    runtime, state = AsyncRuntime.build(algo, stacked, profile, depth=depth,
                                        device=device)
    return runtime, state, sp.schedule(sim.m)


def async_round(runtime: AsyncRuntime, state, schedule, data,
                sim: SimConfig, tick0: int, wire_edges=0, *, sampler=None,
                batches_at: Optional[Callable] = None,
                topology_at: Optional[Callable] = None,
                sampled_at: Optional[Callable] = None,
                on_tick: Optional[Callable] = None):
    """Advance one sync-equivalent WINDOW of k_v + k_u ticks.  Each tick
    draws one minibatch per client (`seeded_generator(seed, BATCH_STREAM,
    t)`, or `batches_at(t)`), the tick's pull table (`schedule.at(t)` or
    `topology_at(t)`) in its lazy push form (`to_push_sparse`: the sender
    keeps 1/2, or its `staleness_self_weight` under stale_discount), the
    participation mask (`sampler.active_mask(t)` or `sampled_at(t)`), and
    runs `runtime.tick`.  A full-rate client completes one local round
    per window.  on_tick(t, state, metrics): called after each tick.
    -> (state, last metrics, next tick, wire_edges) — wire_edges sums the
    payload-carrying edges on the device."""
    dev = state.flat.device
    self_weight = topology.staleness_self_weight(
        runtime.profile.push_delay.cpu()) if sim.stale_discount else 0.5
    metrics = {}
    for t in range(tick0, tick0 + runtime.k_total):
        if batches_at is not None:
            b = _as_batches(batches_at(t), dev)
        else:
            b = sample_batches(seeded_generator(sim.seed, BATCH_STREAM, t),
                               data, 1, sim.batch)
        batch = {k: a[:, 0] for k, a in b.items()}
        P = _as_topology(topology_at(t) if topology_at is not None
                         else schedule.at(t))
        P = topology.to_push_sparse(P, self_weight=self_weight).to(dev)
        part = None
        if sampler is not None or sampled_at is not None:
            mask = sampled_at(t) if sampled_at is not None \
                else sampler.active_mask(t)
            part = torch.as_tensor(np.asarray(mask), dtype=torch.bool,
                                   device=dev)
        state, metrics = runtime.tick(state, P, batch, participation=part)
        wire_edges = wire_edges + metrics["wire_edges"]
        if on_tick is not None:
            on_tick(t, state, metrics)
    return state, metrics, tick0 + runtime.k_total, wire_edges


def async_experiment(algo_name: str, sim: SimConfig, model_cfg, data,
                     loss_fn, mask: dict, stacked: dict, dev, *, codec=None,
                     sampler=None, eval_every: int = 10,
                     verbose: bool = False, return_state: bool = False,
                     return_params: bool = False,
                     batches_at: Optional[Callable] = None,
                     topology_at: Optional[Callable] = None,
                     sampled_at: Optional[Callable] = None,
                     spec=None, sink=None) -> dict:
    """The runtime="async" leg of `run_experiment`: the same data, model
    and protocol constants, but rounds become windows of ticks on the
    virtual clock (`async_round`).  The wire meter is the sync one's
    `obs.gauges` arithmetic on the run's flat width: the lossy codec's
    reference bootstrap plus every fired payload-carrying edge times the
    payload row bytes.  round_s: wall seconds per window, each ending in
    a device sync on CUDA.  sink: each window then emits one "tick" record
    (the last tick's metrics and gauges, the cumulative wire meter), and
    with spec.graph_every a "graph" record of the in-flight-aware ledger
    every that many windows."""
    sp = spec if spec is not None else resolve_spec(algo_name, sim)
    runtime, state, schedule = build_async(algo_name, sim, loss_fn, mask,
                                           stacked, codec, dev, spec=sp)
    d_flat = runtime.layout.d_flat
    wire_rb = gauges.payload_row_bytes(runtime.algo.codec, d_flat)
    wire_boot = gauges.bootstrap_bytes(runtime.algo.codec, sim.m, d_flat)
    history = {"round": [], "acc": [], "loss": [], "vtime": [],
               "wire_bytes": [], "mean_local_rounds": [], "round_s": [],
               "algo": algo_name, "runtime": "async", "device": str(dev)}
    run_id = f"{algo_name}-async-seed{sim.seed}"
    timer = obs.PhaseTimer()
    t0 = time.perf_counter()
    tick, wire_edges = 0, 0
    for r in range(sim.rounds):
        # the window ends in a device sync on CUDA (round_s)
        timer.reset()
        with timer.phase("window", block=True) as ph:
            state, metrics, tick, wire_edges = async_round(
                runtime, state, schedule, data, sim, tick, wire_edges,
                sampler=sampler, batches_at=batches_at,
                topology_at=topology_at, sampled_at=sampled_at)
            ph.out = state
        history["round_s"].append(timer.seconds("window"))
        acc = None
        if (r + 1) % eval_every == 0 or r == sim.rounds - 1:
            with timer.phase("eval"):
                acc, _ = evaluate(runtime.eval_params(state), data,
                                  model_cfg)
            history["round"].append(r + 1)
            history["acc"].append(acc)
            history["vtime"].append(float(metrics["vtime"]))
            history["wire_bytes"].append(int(wire_edges) * wire_rb
                                         + wire_boot)
            history["loss"].append(float(metrics["loss"]))
            history["mean_local_rounds"].append(
                float(state.local_round.to(torch.float32).mean()))
            if verbose:
                print(f"[{algo_name}/async] window {r + 1:4d} "
                      f"vtime={float(metrics['vtime']):.0f} acc={acc:.4f} "
                      f"mass={float(metrics['mass_total']):.3f} "
                      f"({time.perf_counter() - t0:.1f}s)")
        if sink is not None:
            sink.emit(obs.tick_record(
                run=run_id, algo=algo_name, step=r + 1, m=sim.m, acc=acc,
                wire_bytes=int(wire_edges) * wire_rb + wire_boot,
                **timer.gauges(), **gauges.to_host(metrics)))
            if sp.graph_every and (r + 1) % sp.graph_every == 0:
                # the in-flight-aware ledger (eval_params' accounting):
                # mass_total over it is the conserved local + in-flight
                # total; the age histogram keys off the last tick run
                mail_f, mail_mu = mbox.in_flight(state.mail)
                extra = dict(gauges.staleness_gauges(state.local_round))
                extra.update(obs_graph.mailbox_age_hist(
                    state.mail.slots_mu, tick - 1))
                obs_graph.emit_graph_record(
                    sink, run_id=run_id, algo=algo_name, m=sim.m,
                    seed=sim.seed, schedule=schedule, step=r + 1, t0=tick,
                    flat=state.flat + mail_f.to(state.flat.dtype),
                    mu=state.mu + mail_mu, personal=state.personal,
                    extra=extra)
    history["final_acc"] = history["acc"][-1] if history["acc"] \
        else float("nan")
    if return_state:
        history["state"], history["layout"] = state, runtime.layout
        history["engine"] = runtime
    if return_params:
        history["params"] = runtime.eval_params(state)
    return history
