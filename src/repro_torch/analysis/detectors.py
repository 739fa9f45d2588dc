"""The five program-invariant detectors (port of
`repro/analysis/detectors.py`).

The reference proves its properties on the compiled artifact: jaxprs
and lowered StableHLO.  Eager PyTorch has neither, so each check is
rebuilt for what the port actually runs.  Three of them read one
recording: `Recorder`, a `TorchDispatchMode` that files every aten op
dispatched during a round — name, output shapes, input shapes / dtypes
/ devices and non-tensor arguments — under the open `analysis.scope`
path.  Under `torch.func.vmap(grad(...))`, which the local steps use, it
sees the physical batched ops with the client axis in front.  The CUDA
kernels are `ctypes` calls: the recorder sees their output allocations,
not their launches (`chip_smoke.py` counts those with the profiler).

- `check_densify` (reference: a walk of the closed jaxpr) — flags any op
  output with two or more dims equal to m: an (m, m)-scale product is
  exactly the dense mix the O(m*k) engine exists to avoid.  Allowlisted
  by scope substrings; vacuous at m <= 1.
- `check_donation` (reference: `tf.aliasing_output` markers) — eager
  torch has no aliasing pass, so the contract is what donation buys: the
  resident buffer does not double.  (a) The leaves a round writes in
  place (`inst.inplace`) keep their storage (`data_ptr`) across rounds.
  (b) Every other donated leaf is unreachable once the caller drops its
  reference (a weakref to it is dead), unless the round hands it back as
  the same tensor, or a view of it, inside its new state (aliasing:
  honoured); an output outside the new state that shares its storage is
  named.  On CUDA also, after rounds 1..N-1, the bytes the caching
  allocator has handed out, at the sizes asked for
  (`memory_stats()["requested_bytes.all.current"]`), equal their value
  after round 1.  That counts storage held from C++ as much as from
  Python: autograd's saved tensors of a graph chained across rounds,
  library workspaces, caches.  `torch.cuda.memory_allocated()` counts the
  same blocks at the sizes the allocator gave them, and the allocator
  hands a block out unsplit when less than 1 MiB of it would remain, so
  the same tensors read another total as they land in other free blocks:
  it is quoted, not gated (chip_smoke.py, phase `analysis`, records both
  over six rounds of each Regime B program).  Stateless programs: n/a.
- `check_retrace` (reference: a counting-compile harness) — eager torch
  has no trace; what the reference guards against is a Python value or
  branch flapping per round.  Rounds 1..N-1 must dispatch the same op
  signature as round 1, non-tensor arguments included (ops inside
  `inst.allow_vary` scopes are left out), and no kernel plan cache may
  miss, nor a kernel library build, after round 0.
- `check_host_sync` (reference: `jax.transfer_guard("disallow")`) —
  (a) every round-argument leaf is a tensor on the program's device (a
  numpy array or Python scalar is re-uploaded every call); (b) over
  rounds 1..N-1 the recording holds no `aten._local_scalar_dense`
  (`.item()`, `bool()`), no `aten.lift_fresh` (`torch.tensor(x)`, a
  Python value committed per round; the 0-d scalar of an indexed
  assignment `x[i] = 0.0`, consumed by `fill_`, is a kernel argument and
  not flagged), no copy between devices, and no op whose output shape
  depends on data (`nonzero`, a bool index); (c) on CUDA the same rounds
  run under `torch.cuda.set_sync_debug_mode("error")`.  Ops inside the
  `inst.allow_sync` scopes are reviewed syncs (the recorder lifts the
  debug mode inside them); the telemetry boundary `obs.gauges.to_host`
  runs after every round, as the reference's `jax.device_get` does.
- `check_topology_stochastic` / `check_schedules` — the reference's
  checks on the port's tables: every SparseTopology of a registered
  `get_schedule` kind is row-stochastic in pull form and
  column-stochastic (to f32) after `to_push_sparse`, over induced
  subgraphs too.
"""
from __future__ import annotations

import gc
import weakref
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import topology as topo_mod
from ..obs import gauges
from . import scope as scope_mod
from .programs import N_ROUNDS, PROGRAMS, ProgramInstance


class Violation(NamedTuple):
    """One detector trip: which program, which detector, what happened."""
    program: str
    detector: str
    message: str


# ---------------------------------------------------------------------------
# the op recorder
# ---------------------------------------------------------------------------
class OpRecord(NamedTuple):
    name: str                 # e.g. "aten.mul.Tensor"
    scope: str                # '/'-joined analysis.scope path
    outputs: tuple            # output shapes
    signature: tuple          # inputs: (shape, dtype, device) or the value


_COPIES = ("aten._to_copy.", "aten.copy_.", "aten._copy_from.",
           "aten._copy_from_and_resize.", "aten.lift_fresh_copy.")
_DATA_SHAPED = ("aten.nonzero.", "aten.nonzero_numpy.", "aten.argwhere.",
                "aten.masked_select.", "aten.unique", "aten._unique",
                "aten.repeat_interleave.Tensor")
_BOOL_INDEXED = ("aten.index.Tensor", "aten.index_put.", "aten.index_put_.",
                 "aten._index_put_impl_.")


def _describe(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _describe(v)) for k, v in sorted(x.items()))
    if isinstance(x, (int, float, bool, str, type(None))):
        return x
    return str(x)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Files every aten op of a round (`round` set by `drive`) and the
    host syncs among them.  relax: the (scope, reason) pairs inside which
    a CUDA sync debug mode is lifted for the op."""

    def __init__(self, device: torch.device, relax=()):
        super().__init__()
        self.device = device
        self.relax = tuple(s for s, _ in relax)
        self.round = 0
        self.ops: Dict[int, List[OpRecord]] = {}
        self.syncs: Dict[int, List[Tuple[str, str, str]]] = {}
        self._fresh: Dict[int, Tuple[torch.Tensor, str]] = {}

    def _on_device(self, ts) -> bool:
        return any(t.device.type == self.device.type for t in ts)

    def _sync(self, what: str, name: str, where: str) -> None:
        self.syncs.setdefault(self.round, []).append((what, name, where))

    def end_round(self) -> None:
        """A fresh 0-d tensor that no op consumed is a per-round upload
        too (e.g. a metric made with torch.tensor)."""
        for t, where in self._fresh.values():
            self._sync("Python value made into a tensor (torch.tensor)",
                       "aten.lift_fresh.default", where)
        self._fresh.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        where = scope_mod.current()
        ins = _tensors((args, kwargs))
        relax = (self.device.type == "cuda" and where
                 and any(s in where for s in self.relax))
        if relax:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
        try:
            out = func(*args, **kwargs)
        finally:
            if relax:
                torch.cuda.set_sync_debug_mode(mode)
        outs = _tensors(out)
        # a pending 0-d fresh tensor is a kernel argument when fill_ takes
        # it as the scalar of x[i] = v; consumed by anything else, it was
        # a value committed to a tensor this round
        for t in ins:
            hit = self._fresh.pop(id(t), None)
            if hit is not None and not (name.startswith("aten.fill_.")
                                        and t is args[1]):
                self._sync("Python value made into a tensor (torch.tensor)",
                           "aten.lift_fresh.default", hit[1])
        if name.startswith("aten.lift_fresh."):
            if outs and outs[0].dim() == 0:
                self._fresh[id(outs[0])] = (outs[0], where)
            else:
                self._sync("host data made into a tensor "
                           "(torch.tensor / as_tensor of an array)", name,
                           where)
        elif name.startswith("aten._local_scalar_dense."):
            if self._on_device(ins):
                self._sync("device value read on the host (.item() / "
                           "bool() / int() / float())", name, where)
        elif name.startswith(_COPIES):
            devs = {t.device for t in ins + outs}
            if len(devs) > 1:
                self._sync(f"copy between devices "
                           f"{sorted(str(d) for d in devs)}", name, where)
        elif name.startswith(_DATA_SHAPED) or (
                name.startswith(_BOOL_INDEXED) and any(
                    t.dtype == torch.bool for t in ins[1:])):
            if self._on_device(ins):
                self._sync("output shape depends on the data", name, where)
        self.ops.setdefault(self.round, []).append(OpRecord(
            name, where, tuple(tuple(t.shape) for t in outs),
            _describe((args, kwargs))))
        return out


# ---------------------------------------------------------------------------
# driving a program
# ---------------------------------------------------------------------------
def _leaves(obj, prefix: str = ""):
    """(dotted path, tensor) over NamedTuples, dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from _leaves(getattr(obj, f), f"{prefix}.{f}".lstrip("."))
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k], f"{prefix}.{k}".lstrip("."))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}.{i}".lstrip("."))


def _plan_misses() -> int:
    from ..kernels import (gossip_gather, gossip_scatter, head_gather,
                           pushsum_mix, topk_gather)
    return sum(mod.plan.cache_info().misses for mod in (
        gossip_gather, gossip_scatter, head_gather, pushsum_mix,
        topk_gather))


def _libraries() -> int:
    from ..kernels import _build
    return len(_build._LIBS)


def _telemetry(out) -> None:
    """The telemetry emit boundary: the round's scalars to the host."""
    last = out[-1] if isinstance(out, tuple) else None
    if isinstance(last, dict):
        gauges.to_host(last)
    elif isinstance(last, torch.Tensor) and last.dim() == 0:
        gauges.to_host({"value": last})


class Run(NamedTuple):
    """What one drive of N_ROUNDS rounds observed."""
    ops: Dict[int, List[OpRecord]]
    syncs: Dict[int, List[Tuple[str, str, str]]]
    debug_error: str           # the CUDA sync debug mode's error, or ''
    plan_misses: int           # plan cache misses after round 0
    libraries: int             # kernel libraries loaded after round 0
    kept: List[str]            # donated leaves kept alive, by round
    moved: List[str]           # in-place leaves whose storage moved
    memory: List[Tuple[int, int]]  # CUDA allocated and requested bytes
    #                                after each round


def _allocator_bytes(device: torch.device) -> Tuple[int, int]:
    """(memory_allocated, requested bytes) of the CUDA caching allocator:
    every block it has handed out, whether Python or C++ holds it, at the
    block sizes and at the sizes asked for."""
    return (torch.cuda.memory_allocated(device),
            torch.cuda.memory_stats(device)["requested_bytes.all.current"])


def _kept_alive(refs, keep, keep_storage, others) -> List[str]:
    """The donated leaves still alive that the new state does not hand
    back (by identity or shared storage), with the outputs holding their
    storage."""
    out = []
    for p, ref in refs:
        leaf = ref()
        if leaf is None or id(leaf) in keep:
            continue
        ptr = leaf.untyped_storage().data_ptr()
        if ptr in keep_storage:
            continue
        held = [q for q, x in others
                if x.untyped_storage().data_ptr() == ptr]
        out.append(f"{p} {tuple(leaf.shape)} {leaf.dtype} is still alive "
                   f"after the round"
                   + (f", its storage held by output {held}" if held
                      else ""))
    return out


def _drive_once(inst: ProgramInstance, rounds: int, sync_debug: bool
                ) -> Run:
    rec = Recorder(inst.device, inst.allow_sync)
    cuda = inst.device.type == "cuda"
    kept: List[str] = []
    moved: List[str] = []
    memory: List[Tuple[int, int]] = []
    misses = libs = 0
    carry = None
    for t in range(rounds):
        if t == 1:
            misses, libs = _plan_misses(), _libraries()
        args = inst.args(t, carry)
        donated = [(f"round {t}: arg {i}" + (f".{p}" if p else ""), leaf)
                   for i in inst.donate for p, leaf in _leaves(args[i])]
        refs = [(p, weakref.ref(leaf)) for p, leaf in donated]
        inplace = {p: leaf.data_ptr() for p, leaf in
                   (_leaves(args[0]) if inst.inplace else ())
                   if p in inst.inplace}
        del donated
        rec.round = t
        debug = cuda and sync_debug and t >= 1
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with rec:
                out = inst.fn(*args)
                rec.end_round()
        finally:
            if debug:
                torch.cuda.set_sync_debug_mode(0)
        del args
        carry = inst.carry_of(out)
        new = dict(_leaves(carry)) if carry is not None else {}
        for p, ptr in inplace.items():
            leaf = new.get(p)
            if leaf is not None and leaf.data_ptr() != ptr:
                moved.append(f"round {t}: {p} moved from storage "
                             f"{ptr:#x} to {leaf.data_ptr():#x}")
        if t >= 1:
            with rec:
                _telemetry(out)
        keep = {id(x) for x in new.values()}
        keep_storage = {x.untyped_storage().data_ptr()
                        for x in new.values()}
        others = [(p, x) for p, x in _leaves(out) if id(x) not in keep]
        del out
        gc.collect()
        kept += _kept_alive(refs, keep, keep_storage, others)
        del others
        if cuda:
            torch.cuda.synchronize(inst.device)
            memory.append(_allocator_bytes(inst.device))
    return Run(rec.ops, rec.syncs, "",
               _plan_misses() - misses if rounds > 1 else 0,
               _libraries() - libs if rounds > 1 else 0,
               kept, moved, memory)


def drive(inst: ProgramInstance, rounds: int = N_ROUNDS) -> Run:
    """N_ROUNDS rounds of `inst` from a fresh state under the recorder; on
    CUDA the steady-state rounds run under
    `torch.cuda.set_sync_debug_mode("error")`, and if that raises the
    rounds are driven again without it for the other detectors."""
    if inst.device.type != "cuda":
        return _drive_once(inst, rounds, False)
    try:
        return _drive_once(inst, rounds, True)
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        msg = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return _drive_once(inst, rounds, False)._replace(debug_error=msg)


def _scoped(where: str, allow) -> bool:
    return bool(where) and any(a in where for a in allow)


# ---------------------------------------------------------------------------
# 1. densification
# ---------------------------------------------------------------------------
def check_densify(inst: ProgramInstance,
                  run: Optional[Run] = None) -> List[str]:
    """Flag op outputs whose shape contains the client axis twice."""
    if inst.m <= 1:
        return []      # every axis is "the client axis" at m = 1
    run = run or drive(inst)
    out: List[str] = []
    for t in sorted(run.ops):
        for op in run.ops[t]:
            if _scoped(op.scope, inst.allow_dense):
                continue
            for shape in op.outputs:
                if sum(1 for s in shape if s == inst.m) >= 2:
                    msg = (f"`{op.name}` materializes {shape} (client axis "
                           f"m={inst.m} twice) at scope "
                           f"'{op.scope or '<top>'}'")
                    if msg not in out:
                        out.append(msg)
    return out


# ---------------------------------------------------------------------------
# 2. donation
# ---------------------------------------------------------------------------
def check_donation(inst: ProgramInstance,
                   run: Optional[Run] = None) -> List[str]:
    """The donated state must not double: in-place leaves keep their
    storage, other donated leaves die with the caller's reference, and on
    CUDA the allocator's requested bytes stay flat after round 1."""
    if not inst.donate:
        return []
    run = run or drive(inst)
    out = [f"in-place leaf {m}" for m in run.moved]
    if run.kept:
        out.append(f"donation dropped: {len(run.kept)} donated leaves "
                   f"outlive the round (the resident buffer would double): "
                   + "; ".join(run.kept[:4]))
    mem = run.memory[1:]
    if any(x[1] != mem[0][1] for x in mem):
        out.append(f"CUDA memory moves across rounds 1..{len(mem)}: the "
                   f"caching allocator holds {[x[1] for x in mem]} "
                   f"requested bytes (want equal; memory_allocated "
                   f"{[x[0] for x in mem]})")
    return out


# ---------------------------------------------------------------------------
# 3. retrace sentinel
# ---------------------------------------------------------------------------
def _signature(ops: List[OpRecord], allow) -> tuple:
    return tuple((op.name, op.signature) for op in ops
                 if not _scoped(op.scope, allow))


def check_retrace(inst: ProgramInstance,
                  run: Optional[Run] = None) -> List[str]:
    """Rounds 1..N-1 dispatch one op signature; no plan cache miss and no
    library build after round 0."""
    run = run or drive(inst)
    allow = tuple(s for s, _ in inst.allow_vary)
    steady = [t for t in sorted(run.ops) if t >= 1]
    sigs = [_signature(run.ops[t], allow) for t in steady]
    out = []
    distinct = len(set(sigs))
    if distinct > 1:
        first = sigs[0]
        diff = ""
        for t, sig in zip(steady[1:], sigs[1:]):
            if sig != first:
                i = next((i for i, (a, b) in enumerate(zip(first, sig))
                          if a != b), min(len(first), len(sig)))
                a = first[i] if i < len(first) else "<end>"
                b = sig[i] if i < len(sig) else "<end>"
                diff = (f"; round {t} first differs from round "
                        f"{steady[0]} at op #{i}: {a} vs {b}")
                break
        out.append(f"retraced: {distinct} distinct op signatures across "
                   f"rounds {steady[0]}..{steady[-1]} (want 1) — a Python "
                   f"value or branch is flapping per round{diff}")
    if run.plan_misses:
        out.append(f"{run.plan_misses} kernel plan cache misses after "
                   f"round 0 (a shape or knob changes per round)")
    if run.libraries:
        out.append(f"{run.libraries} kernel libraries loaded after round 0")
    return out


# ---------------------------------------------------------------------------
# 4. host syncs
# ---------------------------------------------------------------------------
def _static_args(inst: ProgramInstance) -> List[str]:
    """Round arguments that are not tensors on the program's device."""
    out = []
    for t, rest in enumerate(inst.round_args):
        for i, a in enumerate(rest):
            for p, leaf in _pytree.tree_flatten_with_path(a)[0]:
                where = f"round {t} arg {i}{_pytree.keystr(p)}"
                if isinstance(leaf, torch.Tensor):
                    if leaf.device != inst.device and not (
                            leaf.device.type == inst.device.type == "cuda"
                            and inst.device.index is None):
                        out.append(f"{where} lies on {leaf.device}, the "
                                   f"program on {inst.device}")
                elif leaf is not None:
                    out.append(f"{where} is a {type(leaf).__name__}: "
                               f"re-uploaded to {inst.device} every call")
    return out


def check_host_sync(inst: ProgramInstance,
                    run: Optional[Run] = None) -> List[str]:
    """No host transfer or sync in the steady-state rounds outside the
    reviewed scopes."""
    out = _static_args(inst)
    run = run or drive(inst)
    allow = tuple(s for s, _ in inst.allow_sync)
    seen = []
    for t in sorted(run.syncs):
        if t < 1:
            continue
        for what, name, where in run.syncs[t]:
            if _scoped(where, allow):
                continue
            msg = (f"{what}: `{name}` at scope '{where or '<top>'}'")
            if msg not in seen:
                seen.append(msg)
    out += [f"implicit host transfer in the steady-state round: {m}"
            for m in seen]
    if run.debug_error:
        out.append(f"synchronizing CUDA call in the steady-state round "
                   f"(set_sync_debug_mode('error')): {run.debug_error}")
    return out


# ---------------------------------------------------------------------------
# 5. stochasticity of every registered schedule kind
# ---------------------------------------------------------------------------
def _dense_np(P: topo_mod.SparseTopology) -> np.ndarray:
    """Host-side dense form of a small SparseTopology (analysis only)."""
    idx = np.asarray(P.idx.cpu())
    w = np.asarray(P.w.cpu(), np.float64)
    n = idx.shape[0]
    D = np.zeros((n, n))
    np.add.at(D, (np.repeat(np.arange(n), idx.shape[1]),
                  idx.reshape(-1)), w.reshape(-1))
    return D


def check_topology_stochastic(P: topo_mod.SparseTopology, what: str,
                              atol: float = 1e-4) -> List[str]:
    """Pull rows sum to 1; to_push_sparse columns sum to 1 (f32)."""
    out = []
    rows = _dense_np(P).sum(1)
    if not np.allclose(rows, 1.0, atol=atol):
        out.append(f"{what}: pull form not row-stochastic — row sums in "
                   f"[{rows.min():.6f}, {rows.max():.6f}]")
        return out       # push re-weighting of a broken pull form is moot
    cols = _dense_np(topo_mod.to_push_sparse(P)).sum(0)
    if not np.allclose(cols, 1.0, atol=atol):
        out.append(f"{what}: push form not column-stochastic — column "
                   f"sums in [{cols.min():.6f}, {cols.max():.6f}] (mass "
                   f"is created or destroyed every fire)")
    return out


def _check_induced(P: topo_mod.SparseTopology, what: str,
                   atol: float = 1e-4) -> List[str]:
    """Induced subgraphs preserve the stochasticity contracts: 'row'
    keeps row sums at 1; 'col' of the push form keeps every surviving
    sender's column at 1 (fully-dormant senders drop to exactly 0)."""
    out = []
    m = P.idx.shape[0]
    active = torch.arange(0, m, 2, dtype=torch.int32)   # deterministic
    rows = _dense_np(topo_mod.induced_subgraph(P, active, "row")).sum(1)
    if not np.allclose(rows, 1.0, atol=atol):
        out.append(f"{what}: induced 'row' subgraph rows sum to "
                   f"[{rows.min():.6f}, {rows.max():.6f}], want 1")
    push = topo_mod.to_push_sparse(P)
    cols = _dense_np(topo_mod.induced_subgraph(push, active, "col")).sum(0)
    bad = ~(np.isclose(cols, 1.0, atol=atol) |
            np.isclose(cols, 0.0, atol=atol))
    if bad.any():
        out.append(f"{what}: induced 'col' push subgraph has sender "
                   f"columns summing to {cols[bad][:4].tolist()} — "
                   f"neither conserved (1) nor dormant (0)")
    return out


def check_schedules(m: int = 16, n: int = 3, seed: int = 5,
                    rounds: int = N_ROUNDS,
                    kinds: Optional[Tuple[str, ...]] = None,
                    ) -> Tuple[List[dict], List[Violation]]:
    """Run the stochasticity checks over every registered schedule kind
    (host tables: no device involved)."""
    rows, viols = [], []
    for kind in kinds or topo_mod.TopologySchedule.KINDS:
        base: List[str] = []
        induced: List[str] = []
        for t in range(rounds):
            P = topo_mod.get_schedule(kind, m, n, seed).at(t)
            base += check_topology_stochastic(P, f"{kind}@t={t}")
            induced += _check_induced(P, f"{kind}@t={t}")
        rows.append({"kind": kind,
                     "stochastic": "FAIL" if base else "ok",
                     "induced": "FAIL" if induced else "ok"})
        viols += [Violation(f"schedule:{kind}", "stochastic", msg)
                  for msg in base + induced]
    return rows, viols


# ---------------------------------------------------------------------------
# runners + report
# ---------------------------------------------------------------------------
DETECTORS: Dict[str, Callable[..., List[str]]] = {
    "densify": check_densify,
    "donation": check_donation,
    "retrace": check_retrace,
    "hostsync": check_host_sync,
}


def run_program(inst: ProgramInstance) -> Tuple[dict, List[Violation]]:
    """All four program detectors over one instance, from one drive ->
    (report row, violations)."""
    run = drive(inst)
    row: Dict[str, Any] = {"program": inst.name, "m": inst.m}
    viols: List[Violation] = []
    for name, check in DETECTORS.items():
        if name == "donation" and not inst.donate:
            row[name] = "n/a"
            continue
        msgs = check(inst, run)
        row[name] = "FAIL" if msgs else "ok"
        viols += [Violation(inst.name, name, msg) for msg in msgs]
    return row, viols


def run_all(names: Optional[Tuple[str, ...]] = None, device="cuda",
            ) -> Tuple[List[dict], List[dict], List[Violation]]:
    """The full pass: every registered program x every detector on
    `device`, plus the schedule stochasticity sweep.  -> (program rows,
    schedule rows, violations); tests assert `not violations`."""
    rows, viols = [], []
    for name in names or tuple(PROGRAMS):
        row, v = run_program(PROGRAMS[name](device=device))
        rows.append(row)
        viols += v
    srows, sviols = check_schedules()
    return rows, srows, viols + sviols


def render_report(rows: List[dict], srows: List[dict],
                  violations: List[Violation]) -> str:
    """The per-program report table (the obs report renderer)."""
    from ..obs.report import table
    out = table(rows, ["program", "m"] + list(DETECTORS),
                "program invariants")
    out += table(srows, ["kind", "stochastic", "induced"],
                 "schedule stochasticity")
    if violations:
        out += "\n== violations ==\n"
        out += "\n".join(f"  [{v.program} / {v.detector}] {v.message}"
                         for v in violations) + "\n"
    return out
