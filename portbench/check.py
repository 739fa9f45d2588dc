"""The output check: what is read from the program's state and from the
reference's after the same three rounds, and the numbers compared.

Both sides reduce their state with the same functions here, leaf by
leaf (a leaf is one parameter tensor stacked over the clients):

- the losses of each round (the clients' mean personal-step and
  shared-step losses);
- the first gradient of each leaf as the optimizer got it, worked out
  from the optimizer's state after its first step: momentum minus
  weight decay times the initial weights, over the rows that stepped
  (read after the first round, so only for the leaves whose part takes
  one step a round: the personal part of the CNN's k_v 1 / k_u 5 round,
  every leaf of qwen2's k_v 1 / k_u 1);
- the change of each leaf after three rounds, |p3 - p0|;
- in a sampled cell, the leaves whose rows that never stepped moved.

`gaps` compares norms (the gap between the two sides' norms of a leaf,
over the larger of the reference's norm of that leaf and of the median
leaf), never the norm of a difference, and leaves out of the change the
leaves whose reference gradient is under a thousandth of the median
leaf's (a key bias under softmax has none: it moves by round-off).
"""
from __future__ import annotations

import math
import statistics
from typing import Callable, NamedTuple, Optional

import torch

NOUGHT_GRADIENT = 1e-3      # of the median leaf's: left out of the change


class Readings(NamedTuple):
    losses: list            # [loss_v, loss_u] of each checked round
    grad: dict              # path -> first round's gradient norm
    change: dict            # path -> |p3 - p0|
    dormant_moved: Optional[int]    # sampled cells only


def _rows(t: torch.Tensor, rows) -> torch.Tensor:
    if rows is None:
        return t
    return t.index_select(0, torch.as_tensor(rows, dtype=torch.long,
                                             device=t.device))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float32)))


def grad_norms(momentum: dict, p0: Callable, wd: float, rows) -> dict:
    """{path: |m - wd p0|} over `rows` (None: all) of each leaf."""
    out = {}
    for path, mo in momentum.items():
        a = _rows(p0(path), rows)
        out[path] = _norm(_rows(mo, rows) - wd * a)
        del a
    return out


def change_norms(params: dict, p0: Callable) -> dict:
    out = {}
    for path, p in params.items():
        a = p0(path)
        out[path] = _norm(p - a)
        del a
    return out


def dormant_moved(params: dict, momentum: dict, mu: torch.Tensor,
                  p0: Callable, dormant) -> int:
    """How many leaves (weights, momentum, and mu counted as one) moved
    on a row that never stepped: each must hold its initial value bit for
    bit (weights as drawn, momentum 0, mu 1)."""
    if len(dormant) == 0:
        return 0
    moved = 0
    for path, p in params.items():
        moved += not torch.equal(_rows(p, dormant), _rows(p0(path), dormant))
        mo = _rows(momentum[path], dormant)
        moved += bool(torch.count_nonzero(mo))
    moved += not bool(torch.all(_rows(mu, dormant) == 1.0))
    return moved


def _rel(a: float, b: float, floor: float) -> float:
    den = max(abs(b), floor)
    if den == 0.0:
        return 0.0 if a == b else math.inf
    return abs(a - b) / den


def gaps(prog: Readings, ref: Readings) -> dict:
    """The numbers compared: loss_gap, grad_gap, change_gap and, in a
    sampled cell, dormant_moved."""
    out = {"loss_gap": max(_rel(p, r, 0.0) for lp, lr in
                           zip(prog.losses, ref.losses)
                           for p, r in zip(lp, lr))}
    med_g = statistics.median(ref.grad.values())
    out["grad_gap"] = max(_rel(prog.grad[k], g, med_g)
                          for k, g in ref.grad.items())
    med_c = statistics.median(ref.change.values())
    moving = [k for k in ref.change
              if ref.grad.get(k, med_g) >= NOUGHT_GRADIENT * med_g]
    out["change_gap"] = max(_rel(prog.change[k], ref.change[k], med_c)
                            for k in moving)
    if prog.dormant_moved is not None:
        out["dormant_moved"] = prog.dormant_moved
    if not all(math.isfinite(x) for lp in prog.losses for x in lp):
        out["loss_gap"] = math.inf
    return out


def decide(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over the numbers the
    limits name (a number without an upper reading has none and is not
    compared): each at or under its limit; a limit of null, a value that
    is not finite, or no number compared at all fails."""
    table, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers[name]
        table[name] = {"value": value, "limit": limit}
        ok &= limit is not None and math.isfinite(value) and value <= limit
    return ok, table


CONTROL_FACTOR = 3      # a control reading bounds a number from 3x up
FAULT_FACTOR = 10       # a fault's reading from 10x up
FROZEN = {"change_gap": 1.0}    # a state left unchanged, with no run


def limits_from(rows: list) -> dict:
    """Each number's limit from calibration readings (`calibrate.py`'s
    rows: {"kind": "program" | "control" | a fault, "numbers": {...}}):
    the lower reading is the largest sound program run's; the upper the
    least of the control's readings (where they are 3x the lower or
    more), of each fault's (10x) and of a state left unchanged
    (change_gap 1, 3x).  The limit lies
    between, nearer the upper in ratio (lower^(1/3) upper^(2/3)).  A
    number with no upper reading gets none (it is not compared); one that
    every program run reads 0 is exact: limit 0."""
    out = {}
    prog = [r["numbers"] for r in rows if r["kind"] == "program"]
    for name in prog[0]:
        lower = max(p[name] for p in prog)
        ups = []
        control = [r["numbers"][name] for r in rows if r["kind"] == "control"]
        if control and min(control) >= CONTROL_FACTOR * lower:
            ups.append(min(control))
        for kind in {r["kind"] for r in rows} - {"program", "control"}:
            got = [r["numbers"][name] for r in rows if r["kind"] == kind]
            if min(got) >= FAULT_FACTOR * lower:
                ups.append(min(got))
        if name in FROZEN and FROZEN[name] >= CONTROL_FACTOR * lower:
            ups.append(FROZEN[name])
        if lower == 0:
            out[name] = 0
        elif ups:
            out[name] = float(f"{lower ** (1 / 3) * min(ups) ** (2 / 3):.2g}")
    return out
