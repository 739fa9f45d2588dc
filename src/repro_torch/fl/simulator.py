"""FL simulation engine (Regime A) — the synchronous resident DFedPGP branch
of `repro/fl/simulator.py`, on one device.

`run_experiment("dfedpgp", SimConfig())` builds the synthetic non-IID
data, m stacked CNN clients and the classifier-personal mask, packs the
shared part once (`DFedPGP.init_flat`) and runs the rounds: all clients'
local steps, then the push-pull mix of the buffer through the CUDA
gossip_gather kernel.  Personalized test accuracy is evaluated on each
client's own test split.

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

from .. import tree
from ..core import dfedpgp, partition, topology
from ..core.topology import SparseTopology
from ..data import ClientData, from_arrays, make_dataset, sample_batches
from ..device import resolve_device
from ..models import cnn
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
    gossip: str = "sparse"          # sparse | dense
    resident: bool = True
    # ---- knobs of the reference that later slices port (non-default
    # values raise NotImplementedError naming the ROADMAP item) ----
    runtime: str = "sync"
    hetero: str = "uniform"
    speed_spread: float = 5.0
    push_delay_max: int = 0
    availability: float = 1.0
    mailbox_depth: int = 4
    codec: Optional[str] = None
    codec_ratio: float = 1.0 / 16.0
    codec_bits: int = 4
    codec_gamma: object = 1.0
    participation: str = "full"
    participation_frac: float = 1.0
    stale_discount: bool = False
    spec: Optional[object] = None


# SimConfig field -> ROADMAP queue 1 item that ports it
_UNPORTED = {"sample_ratio": 9, "resident": 8, "runtime": 11, "hetero": 11,
             "speed_spread": 11, "push_delay_max": 11, "availability": 11,
             "mailbox_depth": 11, "stale_discount": 11, "codec": 10,
             "codec_ratio": 10, "codec_bits": 10, "codec_gamma": 10,
             "participation": 7, "participation_frac": 7, "spec": 13}

def _check_ported(algo_name: str, sim: SimConfig) -> None:
    if algo_name != "dfedpgp":
        raise NotImplementedError(
            f"algorithm {algo_name!r} is not ported yet: this slice runs "
            f"'dfedpgp'; the baselines are ROADMAP queue 1 item 9")
    defaults = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    for name, item in _UNPORTED.items():
        if getattr(sim, name) != defaults[name]:
            raise NotImplementedError(
                f"SimConfig({name}={getattr(sim, name)!r}) is not ported "
                f"yet (ROADMAP queue 1 item {item})")


def _seeded(seed: int, stream: int, t: int) -> torch.Generator:
    """A CPU generator that is a pure function of (seed, stream, t)."""
    s = (int(seed) * 1_000_003 + int(stream) * 7_919 + int(t)) % (2 ** 63)
    return torch.Generator().manual_seed(s)


def evaluate(eval_params: dict, data: ClientData, model_cfg: cnn.CNNConfig):
    """-> (mean personalized accuracy, (m,) per-client accuracy)."""
    with torch.no_grad():
        acc = vmap(lambda p, x, y: cnn.accuracy(p, x, y, model_cfg))(
            eval_params, data.x_test, data.y_test)
    return float(acc.mean()), acc.cpu().numpy()


def _as_topology(P, device) -> SparseTopology:
    if isinstance(P, SparseTopology):
        return P.to(device)
    idx, w = P
    return SparseTopology(
        torch.as_tensor(np.asarray(idx), dtype=torch.int32, device=device),
        torch.as_tensor(np.asarray(w), dtype=torch.float32, device=device))


def _as_batches(b: dict, device) -> dict:
    return {"x": torch.as_tensor(np.asarray(b["x"]), dtype=torch.float32,
                                 device=device),
            "y": torch.as_tensor(np.asarray(b["y"]), dtype=torch.int64,
                                 device=device)}


def run_experiment(algo_name: str, sim: SimConfig,
                   model_cfg: Optional[cnn.CNNConfig] = None, *,
                   device="cuda", eval_every: int = 10,
                   return_state: bool = False,
                   step_gates=None, sink=None,
                   data: Optional[ClientData] = None,
                   init_params: Optional[dict] = None,
                   topology_at: Optional[Callable] = None,
                   batches_at: Optional[Callable] = None) -> dict:
    """Returns the history dict: per-eval `round`, `acc`, `loss`, plus
    `final_acc` and per-round wall seconds `round_s` (each round ends in
    a device sync on CUDA).  return_state adds the final FlatDFedPGPState
    and its FlatLayout (`state`, `layout`) — what the serve path takes.

    Replay injection (test plumbing): `data` — a ClientData or a 5-tuple
    of arrays; `init_params` — stacked (m, ...) params dict; `topology_at`
    — t -> SparseTopology or (idx, w) arrays; `batches_at` — t -> {"x":
    (m, K, B, H, W, C), "y": (m, K, B)} arrays."""
    _check_ported(algo_name, sim)
    if step_gates is not None:
        raise NotImplementedError("step_gates (sync computation "
                                  "heterogeneity) are ported with the "
                                  "hetero runtime (ROADMAP queue 1 item 11)")
    if sink is not None:
        raise NotImplementedError("metric sinks are ported with "
                                  "observability (ROADMAP queue 1 item 13)")
    dev = resolve_device(device)
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
        stacked = cnn.init_params(_seeded(sim.seed, 1, 0), model_cfg,
                                  (sim.m,))
    else:
        stacked = tree.tree_map(
            lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32),
            init_params)
    mask = partition.build_mask(stacked, partition.classifier_personal)
    opt = SGD(lr=sim.lr, momentum=sim.momentum,
              weight_decay=sim.weight_decay)
    algo = dfedpgp.DFedPGP(loss_fn=loss_fn, mask=mask, opt_u=opt, opt_v=opt,
                           k_v=sim.k_personal, k_u=sim.k_local,
                           lr_decay=sim.lr_decay, gossip=sim.gossip)
    schedule = topology.get_schedule(sim.topology, sim.m, sim.n_neighbors,
                                     sim.seed)
    state, layout = algo.init_flat(stacked, device=dev)
    k_total = sim.k_local + sim.k_personal
    kv = algo.k_v

    history = {"round": [], "acc": [], "loss": [], "round_s": [],
               "algo": algo_name, "runtime": "sync", "device": str(dev)}
    for r in range(sim.rounds):
        if batches_at is not None:
            batches = _as_batches(batches_at(r), dev)
        else:
            batches = sample_batches(_seeded(sim.seed, 2, r), data, k_total,
                                     sim.batch)
        P = _as_topology(topology_at(r) if topology_at is not None
                         else schedule.at(r), dev)
        if sim.gossip == "dense":
            P = P.dense()
        b = {"v": {k: a[:, :kv] for k, a in batches.items()},
             "u": {k: a[:, kv:] for k, a in batches.items()}}
        t_round = time.perf_counter()
        state, metrics = algo.round_fn_flat(state, P, b, layout)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history["round_s"].append(time.perf_counter() - t_round)

        if (r + 1) % eval_every == 0 or r == sim.rounds - 1:
            acc, _ = evaluate(algo.eval_params_flat(state, layout), data,
                              model_cfg)
            history["round"].append(r + 1)
            history["acc"].append(acc)
            history["loss"].append(float(metrics["loss_u"]))
    history["final_acc"] = history["acc"][-1] if history["acc"] \
        else float("nan")
    if return_state:
        history["state"], history["layout"] = state, layout
    return history
