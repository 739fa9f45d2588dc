"""The registered programs the invariant analyzer lints (port of
`repro/analysis/programs.py`).

One `ProgramInstance` per distinct program the port ships: the resident
Regime A round, the sampled round, the Regime B train step in resident
and sampled forms, the async tick, and the fused serve path.  Each
instance packages what the detectors need — the function, its per-round
arguments pre-built on the program's device for `N_ROUNDS` rounds, the
donation contract, the client-axis size and the reviewed allowlists — so
a detector never has to know HOW a program is built, only that
`inst.args(t, carry)` yields a runnable call.

The programs use a PRIME client count (`SIM_M = 13`) on purpose: 13
appears nowhere else in any registered program's shapes, so the
densification detector can identify an (m, m)-scale intermediate purely
from its shape.  The reference's Regime B programs take m from the jax
device mesh (1 in its unit tests, 13 under its CLI's forced host
devices); the port runs every client on one card, so its Regime B
programs lay SIM_M clients on one device (`mesh.one_device_layout`) and
the densify scan is real on the CPU and on the card alike.

Every builder takes `device=` (default "cuda": the port's entry points
run on the card unless the caller asks for the CPU) and optional inputs
to inject — the quad problem's targets, the schedule's tables, the active
sets, the serve init and requests, Regime B's state and token batches —
so that tests can feed the reference's draws (torch cannot replay
`jax.random`).  Without them the builders draw from seeded torch
generators, and Regime B starts from zeros (mu 1) on zero batches.

Allowlists name a reviewed site by the scope (`analysis.scope`) the port
wraps around it, each with its reason beside it: a violation of a shipped
program is a fault of the port, never a reason to widen a detector.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dfedpgp, topology
from ..device import resolve_device
from ..optim import SGD

N_ROUNDS = 3     # rounds every dynamic detector drives (steady state by 2)
SIM_M = 13       # prime client count of every registered program

# (scope substring, reason) pairs of the reviewed sites
TELEMETRY_BOUNDARY = (
    "obs.to_host",
    "the explicit telemetry boundary (obs/gauges.py to_host): one device "
    "sync per round fetches the round's gauges, the counterpart of the "
    "reference's explicit jax.device_get")
FIRE_GATE = (
    "async.fire_gate",
    "bool(fired.any()) (hetero/runtime.py) is the reference's "
    "lax.cond(any(fired)) as a host branch: one device sync per tick, and a "
    "tick where nobody fires launches no kernel")
HOST_CLOCK = (
    "async.host_clock",
    "the tick index is a host int by design (hetero/clock.py): the mailbox "
    "ring slot, the availability trace and the vtime metric are functions "
    "of it, computed on the host (vtime is a CPU tensor that stays there)")
FIRE = (
    "async.fire",
    "the fire runs only on ticks where a client completes its local round "
    "(the host branch behind async.fire_gate), so its ops come and go "
    "between ticks by design")


@dataclasses.dataclass(frozen=True, eq=False)
class ProgramInstance:
    """One registered program, packaged for the detectors.

    fn:          the function a round calls.
    round_args:  per-round non-state argument tuples, PRE-BUILT on the
                 program's device — the host-sync detector watches rounds
                 1..N-1, and arguments built at build time keep host-side
                 schedule construction (a host concern by design) out of
                 the watched window.
    fresh_state: () -> a fresh donated arg 0, or None for stateless
                 programs (serve).  Fresh per call: a round consumes it
                 (the sampled round writes it in place).
    donate:      the argument positions a round consumes (() = no donation
                 contract, donation check reports n/a).
    m:           the client-axis size the densify scan keys on.
    device:      where the program runs.
    inplace:     dotted paths of the state leaves a round writes in place
                 (`round_fn_sampled`'s buffers): their storage must stay.
    allow_dense: scope substrings whose (m, m) intermediates are reviewed.
    allow_sync:  (scope, reason) of the reviewed host syncs.
    allow_vary:  (scope, reason) of reviewed ops that may differ between
                 rounds (left out of the retrace comparison).
    """
    name: str
    fn: Callable[..., Any]
    round_args: Tuple[Tuple[Any, ...], ...]
    fresh_state: Optional[Callable[[], Any]]
    donate: Tuple[int, ...]
    m: int
    device: torch.device = torch.device("cpu")
    inplace: Tuple[str, ...] = ()
    allow_dense: Tuple[str, ...] = ()
    allow_sync: Tuple[Tuple[str, str], ...] = (TELEMETRY_BOUNDARY,)
    allow_vary: Tuple[Tuple[str, str], ...] = ()

    def args(self, t: int, carry: Any) -> Tuple[Any, ...]:
        """The full argument tuple for round t (carry threads arg 0)."""
        rest = self.round_args[t % len(self.round_args)]
        if self.fresh_state is None:
            return rest
        state = carry if carry is not None else self.fresh_state()
        return (state,) + rest

    def carry_of(self, out: Any) -> Any:
        """The next round's arg 0 from this round's output."""
        return out[0] if self.fresh_state is not None else None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _generator(*seed: int) -> torch.Generator:
    s = 0
    for x in seed:
        s = (s * 1_000_003 + int(x)) % (2 ** 63)
    return torch.Generator().manual_seed(s)


def _tables(tables, schedule: topology.TopologySchedule, dev):
    """N_ROUNDS SparseTopology on dev: the injected (idx, w) pairs, or the
    schedule's."""
    if tables is None:
        return [schedule.at(t).to(dev) for t in range(N_ROUNDS)]
    return [topology.SparseTopology(
        torch.tensor(np.asarray(idx, np.int32), device=dev),
        torch.tensor(np.asarray(w, np.float32), device=dev))
        for idx, w in tables]


def _active_sets(active, m: int, n_act: int, seed: int, dev):
    """N_ROUNDS sorted (n_act,) int32 active sets on dev: the injected
    ones, or the first n_act of a seeded permutation each round."""
    if active is None:
        active = [torch.sort(torch.randperm(m, generator=_generator(
            seed, t))[:n_act]).values for t in range(N_ROUNDS)]
    return [torch.tensor(np.asarray(a, np.int32), device=dev)
            for a in active]


def _map_tensors(fn, state):
    """fn over the tensors of a state (NamedTuples, dicts; other leaves
    such as None or a host int kept)."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_map_tensors(fn, x) for x in state))
    if isinstance(state, dict):
        return {k: _map_tensors(fn, v) for k, v in state.items()}
    return state


def _copy_state(state):
    return _map_tensors(torch.clone, state)


def _zeros_of(struct, dev):
    """Zeros on dev shaped as the meta tensors of a state struct."""
    return _map_tensors(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=dev), struct)


# ---------------------------------------------------------------------------
# simulation-scale core (the quad problem the unit suites train)
# ---------------------------------------------------------------------------
def _quad_setup(dev, cu=None, cv=None, m: int = SIM_M, d: int = 6,
                dp: int = 3):
    if cu is None or cv is None:
        gen = _generator(0)
        cu = torch.randn((m, d), generator=gen)
        cv = torch.randn((m, dp), generator=gen)
    cu = torch.tensor(np.asarray(cu, np.float32), device=dev)
    cv = torch.tensor(np.asarray(cv, np.float32), device=dev)

    def loss_fn(p, b):
        return torch.sum((p["body"] - b["tu"][0]) ** 2) + \
            torch.sum((p["head"] - b["tv"][0]) ** 2)

    opt = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    algo = dfedpgp.DFedPGP(loss_fn=loss_fn,
                           mask={"body": True, "head": False},
                           opt_u=opt, opt_v=opt, k_v=1, k_u=2,
                           lr_decay=0.99)
    return algo, cu, cv


def _quad_batches(cu, cv, k_v: int, k_u: int, rows=None):
    tu = cu if rows is None else cu[rows.long()]
    tv = cv if rows is None else cv[rows.long()]

    def rep(x, k):
        return x[:, None].repeat(1, k, 1)[..., None, :]

    return {"v": {"tu": rep(tu, k_v), "tv": rep(tv, k_v)},
            "u": {"tu": rep(tu, k_u), "tv": rep(tv, k_u)}}


def build_sim_resident(device="cuda", *, cu=None, cv=None,
                       tables: Optional[Sequence] = None) -> ProgramInstance:
    """Regime A resident round: `round_fn_flat` on the flat buffer (the
    round `fl.simulator` and `launch/train.py --resident` run)."""
    dev = resolve_device(device)
    algo, cu, cv = _quad_setup(dev, cu, cv)
    state0, layout = algo.init_flat({"body": cu, "head": cv}, device=dev)
    Ps = _tables(tables, topology.TopologySchedule.random(SIM_M, 3, seed=13),
                 dev)
    b = _quad_batches(cu, cv, algo.k_v, algo.k_u)
    return ProgramInstance(
        name="simA.resident",
        fn=lambda s, P, bb: algo.round_fn_flat(s, P, bb, layout),
        round_args=tuple((P, b) for P in Ps),
        fresh_state=lambda: _copy_state(state0),
        donate=(0,), m=SIM_M, device=dev)


def build_sim_sampled(device="cuda", *, cu=None, cv=None,
                      tables: Optional[Sequence] = None,
                      active: Optional[Sequence] = None) -> ProgramInstance:
    """Regime A sampled round: gather / round / in-place write-back over
    the induced subgraph of 7 of the 13 clients."""
    dev = resolve_device(device)
    algo, cu, cv = _quad_setup(dev, cu, cv)
    state0, layout = algo.init_flat({"body": cu, "head": cv}, device=dev)
    Ps = _tables(tables, topology.TopologySchedule.random(SIM_M, 3, seed=13),
                 dev)
    acts = _active_sets(active, SIM_M, 7, 101, dev)
    round_args = tuple(
        (topology.induced_subgraph(P, act, "row"), act,
         _quad_batches(cu, cv, algo.k_v, algo.k_u, rows=act))
        for P, act in zip(Ps, acts))
    return ProgramInstance(
        name="simA.sampled",
        fn=lambda s, P, a, bb: algo.round_fn_sampled(s, P, a, bb, layout),
        round_args=round_args,
        fresh_state=lambda: _copy_state(state0),
        donate=(0,), m=SIM_M, device=dev,
        inplace=("flat", "opt_u.momentum", "ef", "ref"))


def build_async_tick(device="cuda", *, cu=None, cv=None,
                     tables: Optional[Sequence] = None) -> ProgramInstance:
    """The async runtime's tick: local step + mailbox fire / drain.  The
    simulator holds the AsyncState across ticks without donating it, so
    the donation check reports n/a."""
    from ..hetero import profiles
    from ..hetero.runtime import AsyncRuntime

    dev = resolve_device(device)
    algo, cu, cv = _quad_setup(dev, cu, cv)
    rt, state0 = AsyncRuntime.build(algo, {"body": cu, "head": cv},
                                    profiles.uniform(SIM_M), depth=2,
                                    device=dev)
    Ps = _tables(tables, topology.TopologySchedule.random(SIM_M, 3, seed=13),
                 dev)
    b = _quad_batches(cu, cv, algo.k_v, algo.k_u)

    def tick_batch(t):
        k_total = algo.k_v + algo.k_u
        src = b["v"] if t % k_total < algo.k_v else b["u"]
        off = t % k_total
        off = off if off < algo.k_v else off - algo.k_v
        return {k: v[:, off] for k, v in src.items()}

    return ProgramInstance(
        name="async.tick",
        fn=lambda s, P, bb: rt.tick(s, P, bb),
        round_args=tuple((P, tick_batch(t)) for t, P in enumerate(Ps)),
        fresh_state=lambda: _copy_state(state0),
        donate=(), m=SIM_M, device=dev,
        allow_sync=(TELEMETRY_BOUNDARY, FIRE_GATE, HOST_CLOCK),
        allow_vary=(HOST_CLOCK, FIRE))


def build_serve_cnn(device="cuda", *, init=None,
                    requests: Optional[Sequence] = None) -> ProgramInstance:
    """The fused serve path: consensus trunk once + head_gather per
    mixed-user batch of 6.  Stateless: no donation contract.  init: the
    stacked (SIM_M, ...) CNN params (a tree of tensors); requests:
    N_ROUNDS (uid (6,), x (6, 8, 8, 3)) pairs."""
    from .. import serve
    from ..core import partition
    from ..models import cnn
    from ..serve.engine import serve_logits

    dev = resolve_device(device)
    cfg = cnn.CNNConfig(image_size=8, n_classes=10)

    def loss_fn(p, batch):
        return cnn.loss_fn(p, batch, cfg)

    template = cnn.init_params(_generator(0), cfg)
    mask = partition.build_mask(template, partition.classifier_personal)
    algo = dfedpgp.DFedPGP(loss_fn=loss_fn, mask=mask, opt_u=SGD(lr=0.1),
                           opt_v=SGD(lr=0.1))
    if init is None:
        init = cnn.init_params(_generator(1), cfg, batch_shape=(SIM_M,))
    state, layout = algo.init_flat(init, device=dev)
    sstate = serve.from_train_state(state, layout=layout, consensus="mass")

    B = 6
    if requests is None:
        requests = []
        for t in range(N_ROUNDS):
            gen = _generator(2, t)
            requests.append((
                torch.randint(0, SIM_M, (B,), generator=gen,
                              dtype=torch.int32),
                torch.randn((B, cfg.image_size, cfg.image_size,
                             cfg.channels), generator=gen)))
    round_args = tuple(
        (torch.tensor(np.asarray(uid, np.int32), device=dev),
         torch.tensor(np.asarray(x, np.float32), device=dev))
        for uid, x in requests)

    def fn(uid, x):
        with torch.no_grad():
            return serve_logits(sstate, uid, x, cfg)

    return ProgramInstance(
        name="serve.cnn", fn=fn, round_args=round_args,
        fresh_state=None, donate=(), m=SIM_M, device=dev)


# ---------------------------------------------------------------------------
# Regime B (launch/steps.py builders, SIM_M clients on one device)
# ---------------------------------------------------------------------------
def _batches_like(struct, values, dev):
    """Injected numpy batches, nested as `struct`, on dev in its dtypes."""
    if isinstance(struct, dict):
        return {k: _batches_like(v, values[k], dev)
                for k, v in struct.items()}
    return torch.as_tensor(np.asarray(values)).to(dev, struct.dtype)


def _build_regime_b(sampled: bool, device, tables, active, state, batches
                    ) -> ProgramInstance:
    from ..configs import SHAPES, get_reduced
    from ..launch import mesh, steps
    from ..spec import make_algo_spec

    dev = resolve_device(device)
    arch = "qwen2-0.5b"
    cfg = get_reduced(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=SIM_M)
    layout = mesh.one_device_layout(SIM_M, 1)
    m = layout.n_clients
    # the reference's schedule=TopologySchedule.random(m, 2, seed=7),
    # resident=True (and sample_frac=0.5), through the spec that owns them
    kw: dict = dict(topology="random", n_neighbors=min(2, max(m - 1, 0)),
                    seed=7, gossip="matrix", resident=True)
    if sampled:
        kw.update(participation="uniform", participation_frac=0.5)
    spec = make_algo_spec("dfedpgp", **kw)
    sched = spec.schedule(m)
    fn, _, _, structs, donate = steps.build_step(cfg, None, layout, shape,
                                                 spec=spec)
    if state is None:
        state0 = _zeros_of(structs[0], dev)
        # a zero push-sum weight would de-bias to inf; the analyzer runs
        # on values only to drive the program, so any valid mu does
        state0 = state0._replace(mu=torch.ones_like(state0.mu))
    else:
        state0 = _map_tensors(lambda t: t.to(dev), state)
    b_struct = structs[-1]
    if batches is None:
        bs = [_zeros_of(b_struct, dev) for _ in range(N_ROUNDS)]
    else:
        bs = [_batches_like(b_struct, b, dev) for b in batches]
    Ps = _tables(tables, sched, dev)
    if sampled:
        acts = _active_sets(active, m, structs[2].shape[0], 11, dev)
        round_args = tuple(
            (topology.induced_subgraph(P, act, "row"), act, b)
            for P, act, b in zip(Ps, acts, bs))
    else:
        round_args = tuple(zip(Ps, bs))
    return ProgramInstance(
        name="regimeB.sampled" if sampled else "regimeB.resident",
        fn=fn, round_args=round_args,
        fresh_state=lambda: _copy_state(state0),
        donate=donate, m=m, device=dev,
        inplace=("flat", "opt_u.momentum", "ef", "ref") if sampled else ())


def build_regime_b_resident(device="cuda", *,
                            tables: Optional[Sequence] = None,
                            state: Any = None,
                            batches: Optional[Sequence] = None
                            ) -> ProgramInstance:
    """state: a FlatDFedPGPState to start from (default zeros, mu 1);
    batches: N_ROUNDS {'v', 'u'} trees of numpy token batches (default
    zeros)."""
    return _build_regime_b(False, device, tables, None, state, batches)


def build_regime_b_sampled(device="cuda", *,
                           tables: Optional[Sequence] = None,
                           active: Optional[Sequence] = None,
                           state: Any = None,
                           batches: Optional[Sequence] = None
                           ) -> ProgramInstance:
    """As build_regime_b_resident; the batches hold the active rows."""
    return _build_regime_b(True, device, tables, active, state, batches)


# name -> builder; building is deferred so `--program X` only pays for X
PROGRAMS = {
    "simA.resident": build_sim_resident,
    "simA.sampled": build_sim_sampled,
    "regimeB.resident": build_regime_b_resident,
    "regimeB.sampled": build_regime_b_sampled,
    "async.tick": build_async_tick,
    "serve.cnn": build_serve_cnn,
}
