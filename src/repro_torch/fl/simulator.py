"""FL simulation engine (Regime A) — the synchronous DFedPGP branch of
`repro/fl/simulator.py`, on one device.

`run_experiment("dfedpgp", SimConfig())` builds the synthetic non-IID
data, m stacked CNN clients and the classifier-personal mask, packs the
shared part once (`DFedPGP.init_flat`) and runs the rounds: all clients'
local steps, then the push-pull mix of the buffer through the CUDA
gossip_gather kernel.  Personalized test accuracy is evaluated on each
client's own test split.  Variants of the round:
- `participation="uniform"|"trace"` — each round only the sampler's active
  clients act (`DFedPGP.round_fn_sampled` over the induced subgraph; the
  CUDA gossip_scatter kernel writes them back into the resident buffer);
- `resident=False` — the tree-form round (`DFedPGP.round_fn`);
- `codec="identity"|"topk"|"randk"|"qsgd"` — the compressed crossing with
  error feedback and reference tracking (`repro_torch.compress`); under
  `gossip="pallas"` sparse payloads mix through the CUDA topk_gather
  kernel.
`step_gates` (m, K) gate local steps per client (the sync computation
heterogeneity of the paper's Table 3, `hetero.profiles.tier_gates`).

The injection arguments (`data=`, `init_params=`, `topology_at=`,
`batches_at=`) replay another run's draws — the reference's data, initial
parameters, neighbor tables and minibatches — so a test can compare the
two engines step for step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import compress, tree
from ..core import dfedpgp, gossip, partition, sampling, topology
from ..core.topology import SparseTopology
from ..data import ClientData, from_arrays, make_dataset, sample_batches
from ..device import resolve_device, seeded_generator
from ..hetero import profiles
from ..models import cnn
from ..obs import gauges
from ..optim import SGD


@dataclasses.dataclass(frozen=True)
class SimConfig:
    m: int = 100                    # clients
    n_neighbors: int = 10           # DFL gossip degree
    sample_ratio: float = 0.1       # CFL baselines only
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
    topology: str = "random"        # random | exponential | ring | full
    gossip: str = "sparse"          # sparse | dense | pallas
    resident: bool = True           # False: the tree-form round
    runtime: str = "sync"           # "async": ROADMAP queue 1 item 11
    # the simulated fleet: the profile a "trace" sampler ranks by
    hetero: str = "uniform"         # uniform | tiered | lognormal
    speed_spread: float = 5.0
    push_delay_max: int = 0
    availability: float = 1.0
    mailbox_depth: int = 4          # async runtime (item 11)
    # wire codecs (item 10)
    codec: Optional[str] = None
    codec_ratio: float = 1.0 / 16.0
    codec_bits: int = 4
    codec_gamma: object = 1.0
    # partial participation: "full" | "uniform" | "trace"
    participation: str = "full"
    participation_frac: float = 1.0
    stale_discount: bool = False    # async runtime (item 11)
    spec: Optional[object] = None


# SimConfig field -> ROADMAP queue 1 item that ports it
_UNPORTED = {"sample_ratio": 9, "runtime": 11, "mailbox_depth": 11,
             "stale_discount": 11, "spec": 13}


def _check_ported(algo_name: str, sim: SimConfig) -> None:
    if algo_name != "dfedpgp":
        raise NotImplementedError(
            f"algorithm {algo_name!r} is not ported yet: this slice runs "
            f"'dfedpgp'; the baselines (and their flat-core codec runs) "
            f"are ROADMAP queue 1 item 9")
    defaults = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    for name, item in _UNPORTED.items():
        if getattr(sim, name) != defaults[name]:
            raise NotImplementedError(
                f"SimConfig({name}={getattr(sim, name)!r}) is not ported "
                f"yet (ROADMAP queue 1 item {item})")


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
                   return_state: bool = False,
                   step_gates=None, sink=None,
                   data: Optional[ClientData] = None,
                   init_params: Optional[dict] = None,
                   topology_at: Optional[Callable] = None,
                   batches_at: Optional[Callable] = None) -> dict:
    """Returns the history dict: per-eval `round`, `acc`, `loss`, `vtime`
    (lockstep ticks, (r + 1) * (k_local + k_personal)) and `wire_bytes`
    (cumulative bytes on the wire: a lossy codec's reference bootstrap, then
    per round every payload-carrying non-self edge times the payload's
    bytes, `obs.gauges`; codec=None meters the uncompressed f32 rows), plus
    `final_acc` and per-round wall seconds `round_s` (each round ends in
    a device sync on CUDA).  return_state adds the final state and its
    FlatLayout (`state`, `layout`; the layout is None for resident=False)
    — the resident state is what the serve path takes.  step_gates: (m, K)
    per-client step gates (K >= k_local), the first k_local columns gate
    the shared-part steps.

    Replay injection (test plumbing): `data` — a ClientData or a 5-tuple
    of arrays; `init_params` — stacked (m, ...) params dict; `topology_at`
    — t -> SparseTopology or (idx, w) arrays; `batches_at` — t -> {"x":
    (m, K, B, H, W, C), "y": (m, K, B)} arrays."""
    _check_ported(algo_name, sim)
    if sink is not None:
        raise NotImplementedError("metric sinks are ported with "
                                  "observability (ROADMAP queue 1 item 13)")
    dev = resolve_device(device)
    sampler = sampling.get_sampler(sim.participation, sim.m,
                                   sim.participation_frac, sim.seed,
                                   _trace_profile(sim))
    if sampler is not None and not sim.resident:
        raise ValueError("partial participation gathers and scatters the "
                         "resident flat buffer; resident=False has none")
    gate_u = None
    if step_gates is not None:
        gate_u = torch.as_tensor(profiles.validate_step_gates(
            step_gates, sim.m, sim.k_local)[:, :sim.k_local], device=dev)
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
    opt = SGD(lr=sim.lr, momentum=sim.momentum,
              weight_decay=sim.weight_decay)
    codec = compress.get_codec(sim.codec, ratio=sim.codec_ratio,
                               bits=sim.codec_bits, seed=sim.seed)
    if codec is None and sim.codec_gamma != 1.0:
        raise ValueError(
            f"codec_gamma={sim.codec_gamma} only applies to lossy "
            f"codecs; set the codec or drop the knob")
    algo = dfedpgp.DFedPGP(loss_fn=loss_fn, mask=mask, opt_u=opt, opt_v=opt,
                           k_v=sim.k_personal, k_u=sim.k_local,
                           lr_decay=sim.lr_decay, gossip=sim.gossip,
                           codec=codec, codec_gamma=sim.codec_gamma)
    schedule = topology.get_schedule(sim.topology, sim.m, sim.n_neighbors,
                                     sim.seed)
    if sim.resident:
        state, layout = algo.init_flat(stacked, device=dev)

        def eval_params(s):
            return algo.eval_params_flat(s, layout)
    else:
        state, layout = algo.init(stacked, device=dev), None
        eval_params = algo.eval_params
    k_total = sim.k_local + sim.k_personal
    kv = algo.k_v

    def split(b):
        return {"v": {k: a[:, :kv] for k, a in b.items()},
                "u": {k: a[:, kv:] for k, a in b.items()}}

    # the wire meter: host arithmetic on the round's CPU tables
    d_wire = gossip.flat_width(stacked, mask)
    wire_rb = gauges.payload_row_bytes(codec, d_wire)
    wire_total = gauges.bootstrap_bytes(codec, sim.m, d_wire)
    history = {"round": [], "acc": [], "loss": [], "vtime": [],
               "wire_bytes": [], "round_s": [], "algo": algo_name,
               "runtime": "sync", "device": str(dev)}
    for r in range(sim.rounds):
        if batches_at is not None:
            batches = _as_batches(batches_at(r), dev)
        else:
            batches = sample_batches(seeded_generator(sim.seed, 2, r), data,
                                     k_total, sim.batch)
        P = _as_topology(topology_at(r) if topology_at is not None
                         else schedule.at(r))
        if sampler is not None:
            active = sampler.active_at(r)
            P = topology.induced_subgraph(P, active, "row")
            act = torch.as_tensor(active, device=dev)
            idx = act.long()
            batches = {k: a.index_select(0, idx) for k, a in batches.items()}
            g = None if gate_u is None else gate_u.index_select(0, idx)
        # only active <-> active edges carry bytes
        wire_total += gauges.edge_count(P) * wire_rb
        P = P.to(dev)
        if sim.gossip == "dense" and sampler is None:
            P = P.dense()
        t_round = time.perf_counter()
        if sampler is not None:
            state, metrics = algo.round_fn_sampled(state, P, act,
                                                   split(batches), layout,
                                                   step_gate_u=g)
        elif sim.resident:
            state, metrics = algo.round_fn_flat(state, P, split(batches),
                                                layout, step_gate_u=gate_u)
        else:
            state, metrics = algo.round_fn(state, P, split(batches),
                                           step_gate_u=gate_u)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history["round_s"].append(time.perf_counter() - t_round)

        if (r + 1) % eval_every == 0 or r == sim.rounds - 1:
            acc, _ = evaluate(eval_params(state), data, model_cfg)
            history["round"].append(r + 1)
            history["acc"].append(acc)
            history["vtime"].append(float((r + 1) * k_total))
            history["wire_bytes"].append(wire_total)
            history["loss"].append(float(metrics["loss_u"]))
    history["final_acc"] = history["acc"][-1] if history["acc"] \
        else float("nan")
    if return_state:
        history["state"], history["layout"] = state, layout
    return history
