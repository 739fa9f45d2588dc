"""What both regimes share: DFedPGP rounds on the program's resident
buffer, driven with the benchmark's inputs, and the output check's
readings of the program and of the reference.

Set-up builds the program's one algorithm and state from the seed and
runs the first CHECK_ROUNDS rounds through the same `plan` and
`dispatch` the window runs (they also warm every shape up); the readings
of `check` are taken from that state before round CHECK_ROUNDS, and the
window goes on from it.  After the window `release()` frees the program
and `reference_readings()` runs the reference from the same inputs,
made again from the seed.
"""
from __future__ import annotations

import contextlib
import copy
import gc

import numpy as np
import torch

from portbench import check, inputs
from portbench.metrics import kernel_bytes
from portbench.reference import dfedpgp as ref_dfedpgp

CHECK_ROUNDS = 3


@contextlib.contextmanager
def tf32_off():
    """The reference's precision: no TF32 in products or convolutions."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DFedPGPCell:
    """One cell's program under test.  Subclasses give the model's leaves
    (`param_specs`), its data (`prepare`), the program's algorithm
    (`build`), the round's minibatches (`batches`), the reference's loss
    (`reference_loss`) and the work counts (`flops_per_round`,
    `kernel_bytes`, `precision`)."""

    PERSONAL: frozenset = frozenset()   # the leaves each client keeps

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None, program: bool = True):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        t = traffic
        self.m = int(t["clients"])
        self.neighbors = int(t["neighbors"])
        self.frac = float(t["participation"])
        self.hyper = ref_dfedpgp.Hyper(
            float(t["lr"]), float(t["momentum"]), float(t["weight_decay"]),
            float(t["lr_decay"]), int(t["k_v"]), int(t["k_u"]))
        self.specs = self.param_specs()
        self.shared = {p for p, _, _ in self.specs} - self.PERSONAL
        self.prepare()
        self.r = 0
        self._undo = []
        if program:
            self._program(fault)

    def _program(self, fault) -> None:
        """The program's algorithm and state from the seed's weights, and
        the checked rounds."""
        tree = inputs.nest(inputs.leaves(self.specs, self.m, self.seed,
                                         self.device))
        self.algo, layout = self.build(tree)
        h = self.hyper
        opt = self.algo.opt_u
        if (opt.lr, opt.momentum, opt.weight_decay, self.algo.lr_decay,
                self.algo.k_v, self.algo.k_u) != (h.lr, h.momentum, h.wd,
                                                  h.decay, h.k_v, h.k_u):
            raise ValueError(f"the program runs {opt}, lr_decay "
                             f"{self.algo.lr_decay}, k_v {self.algo.k_v}, "
                             f"k_u {self.algo.k_u}; the traffic states "
                             f"{h}")
        self._undo = self._plant(fault) if fault else []
        try:
            self.state, self.layout = self.algo.init_flat(
                tree, layout, device=self.device)
            del tree
            mixed = {"/".join(map(str, p)) for p in self.layout.paths}
            if mixed != self.shared:
                raise ValueError(f"the program shares {sorted(mixed)}; the "
                                 f"paper's split shares "
                                 f"{sorted(self.shared)}")
            self.readings = self._check_rounds()
        except BaseException:
            self.release()
            raise

    # -- the inputs ---------------------------------------------------------
    def n_active(self) -> int:
        return self.m if self.frac >= 1.0 else max(
            1, int(round(self.frac * self.m)))

    def initial(self, path: str) -> torch.Tensor:
        """Leaf `path` as drawn at set-up, drawn again."""
        for i, spec in enumerate(self.specs):
            if spec[0] == path:
                return inputs.leaf(spec, i, self.m, self.seed, self.device)
        raise KeyError(path)

    def table(self, r: int):
        return inputs.directed_table(self.seed, r, self.m, self.neighbors)

    def active(self, r: int):
        return inputs.active_ids(self.seed, r, self.m, self.frac)

    # -- a round ------------------------------------------------------------
    def plan(self, r: int):
        """Round r's host work before the round function: the table, its
        restriction to the participants and the table to the device, the
        participants' ids, the minibatches (`fl.simulator.run_experiment`'s
        and `launch.train.Trainer.step`'s calls)."""
        from repro_torch.core import topology
        idx, w = self.table(r)
        P = topology.SparseTopology(torch.from_numpy(idx),
                                    torch.from_numpy(w))
        active = self.active(r)
        act = None
        if active is not None:
            P = topology.induced_subgraph(P, active, "row")
            act = torch.as_tensor(active, device=self.device)
        return P.to(self.device), act, self.batches(r, active)

    def dispatch(self, plan) -> dict:
        """The round function on the resident state -> its metrics."""
        P, act, b = plan
        if act is None:
            self.state, metrics = self.algo.round_fn_flat(
                self.state, P, b, self.layout)
        else:
            self.state, metrics = self.algo.round_fn_sampled(
                self.state, P, act, b, self.layout)
        return metrics

    def kernel_bytes(self) -> dict:
        """The least bytes a call of each port kernel on the round's path
        moves: the mix's gather of the participants' f32 rows (the
        program densifies it where the table is as wide as the rows, and
        then no gather runs) and a sampled round's write-back of their
        buffer and momentum rows."""
        n, d = self.n_active(), self.layout.d_flat
        out = {"gossip_gather": kernel_bytes.gather(n, self.neighbors + 1, n, d, 4)}
        if self.frac < 1.0:
            out["gossip_scatter"] = kernel_bytes.scatter(n, d, 2, 4, 4)
        return out

    # -- the output check ---------------------------------------------------
    def _leaves(self, state):
        from portbench.inputs import flatten
        params = flatten(self.layout.unravel(state.flat))
        params.update(flatten(state.personal))
        mom = flatten(self.layout.unravel(state.opt_u.momentum))
        mom.update(flatten(state.opt_v.momentum))
        return params, mom

    def _one_step(self, momentum: dict) -> dict:
        """The leaves whose part took one optimizer step in the first
        round (personal ones where k_v is 1, shared ones where k_u is 1):
        only there does the state after it hold the first gradient."""
        h = self.hyper
        return {p: m for p, m in momentum.items()
                if (h.k_u if p in self.shared else h.k_v) == 1}

    def _dormant(self):
        if self.frac >= 1.0:
            return None
        ever = np.unique(np.concatenate(
            [self.active(r) for r in range(CHECK_ROUNDS)]))
        return np.setdiff1d(np.arange(self.m), ever)

    def _check_rounds(self) -> check.Readings:
        losses, grad = [], None
        for r in range(CHECK_ROUNDS):
            metrics = self.dispatch(self.plan(r))
            losses.append((metrics["loss_v"], metrics["loss_u"]))
            if r == 0:
                grad = check.grad_norms(self._one_step(
                    self._leaves(self.state)[1]), self.initial,
                    self.hyper.wd, self.active(0))
        sync(self.device)
        params, mom = self._leaves(self.state)
        change = check.change_norms(params, self.initial)
        dormant = self._dormant()
        moved = None if dormant is None else check.dormant_moved(
            params, mom, self.state.mu, self.initial, dormant)
        self.r = CHECK_ROUNDS
        return check.Readings([[float(a), float(b)] for a, b in losses],
                              grad, change, moved)

    def release(self) -> None:
        """Free the program's state and algorithm (and take a planted
        fault out)."""
        for fn in self._undo:
            fn()
        self._undo = []
        self.state = self.algo = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, control: bool = False) -> check.Readings:
        """The reference's rounds from the same inputs; control=True runs
        it in the precision below the configuration's."""
        feed = []
        for r in range(CHECK_ROUNDS):
            idx, w = self.table(r)
            active = self.active(r)
            feed.append(ref_dfedpgp.Round(idx, w, active,
                                          self.batches(r, active)))
        grad = {}

        def after(t, params, mom, act):
            if t == 0:
                grad.update(check.grad_norms(self._one_step(mom),
                                             self.initial, self.hyper.wd,
                                             self.active(0)))

        params0 = {spec[0]: inputs.leaf(spec, i, self.m, self.seed,
                                        self.device)
                   for i, spec in enumerate(self.specs)}
        with tf32_off():
            params, mom, mu, losses = ref_dfedpgp.rounds(
                params0, self.shared, self.reference_loss(control), feed,
                self.hyper, after)
        del params0
        change = check.change_norms(params, self.initial)
        dormant = self._dormant()
        moved = None if dormant is None else check.dormant_moved(
            params, mom, mu, self.initial, dormant)
        return check.Readings(losses, grad, change, moved)

    # -- faults the output check must catch (tests and calibration) ---------
    FAULTS = ("half_batch", "no_mix", "frozen")

    def _plant(self, name: str) -> list:
        """Break the program under the harness, from the first round to
        `release`: "half_batch" (each step's loss over the first half of
        its batch), "no_mix" (the gossip mix returns its input), "frozen"
        (a round returns its state unchanged).  -> the undo calls."""
        from repro_torch.core import dfedpgp, gossip
        undo = []
        if name == "half_batch":
            algo = self.algo
            whole = algo.loss_fn

            def half(p, batch):
                return whole(p, {k: v[:v.shape[0] // 2]
                                 for k, v in batch.items()})
            object.__setattr__(algo, "loss_fn", half)
            undo.append(lambda: object.__setattr__(algo, "loss_fn", whole))
        elif name == "no_mix":
            mix = gossip.mix_flat
            gossip.mix_flat = lambda P, flat, mu, **kw: (flat, mu)
            undo.append(lambda: setattr(gossip, "mix_flat", mix))
        elif name == "frozen":
            for attr in ("round_fn_flat", "round_fn_sampled"):
                real = getattr(dfedpgp.DFedPGP, attr)

                def frozen(algo, state, *a, _real=real, **k):
                    return state, _real(algo, copy.deepcopy(state), *a,
                                        **k)[1]
                setattr(dfedpgp.DFedPGP, attr, frozen)
                undo.append(lambda a=attr, f=real:
                            setattr(dfedpgp.DFedPGP, a, f))
        else:
            raise ValueError(f"fault {name!r}; known: {self.FAULTS}")
        return undo
