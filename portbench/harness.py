"""One run of one cell: set-up, the measured window, the traced slice, the
output check and the result line (`run.py` is the command).

The window runs whole rounds until `--seconds` have passed; each round
is the round driver's host work (`plan`), the round function
(`dispatch`) and a device sync, timed on the host clock back to back, so
the window holds nothing but rounds.  A traced run then profiles a slice
of whole rounds after the window (`metrics.trace`).  The program's peak
memory is read before its state is freed and the reference runs.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple, Optional

from portbench import catalog, check

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SLICE_S = 0.6               # a traced slice holds about this many seconds
SLICE_MAX_ROUNDS = 6


class Run(NamedTuple):
    """What a run measured, as the metric readers see it."""
    setup_s: float
    window_s: float
    round_s: list            # each round of the window, seconds
    spans: dict              # host span -> [seconds per window round]
    peak_bytes: int
    slice: Optional[object]  # metrics.trace.Slice of a traced run
    kernel_bytes: dict       # port kernel -> least bytes a call moves
    device_name: Optional[str]
    precision: str           # of the step's products: f32, tf32, bf16
    flops_per_round: float


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root=catalog.ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build into build/repro_torch/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(root / "build" / "portbench" / sub)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def window(cell, seconds: float, sync) -> tuple:
    """Rounds from cell.r until `seconds` have passed -> (window seconds,
    round seconds, host spans, each round's loss tensor)."""
    spans = {"plan": [], "dispatch": [], "sync": []}
    round_s, losses = [], []
    t0 = end = time.perf_counter()
    while True:
        a = time.perf_counter()
        plan = cell.plan(cell.r)
        b = time.perf_counter()
        metrics = cell.dispatch(plan)
        c = time.perf_counter()
        sync()
        d = time.perf_counter()
        spans["plan"].append(b - a)
        spans["dispatch"].append(c - b)
        spans["sync"].append(d - c)
        round_s.append(d - end)
        end = d
        losses.append(metrics["loss_u"])
        cell.r += 1
        if d - t0 >= seconds:
            return end - t0, round_s, spans, losses


def traced_rounds(cell, sync):
    """n rounds with the host spans the slice's idle gaps are named by."""
    from torch.profiler import record_function

    def run(n: int) -> None:
        for _ in range(n):
            with record_function("portbench.plan"):
                plan = cell.plan(cell.r)
            with record_function("portbench.dispatch"):
                cell.dispatch(plan)
            with record_function("portbench.sync"):
                sync()
            cell.r += 1
    return run


def quartiles(xs: list) -> list:
    """The window's round times at their first, second and third
    quartiles (the spread within one run, logged beside the metrics)."""
    return statistics.quantiles(xs, n=4) if len(xs) > 1 else list(xs) * 3


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) \
        else repr(x)


def execute(cell: catalog.Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float, *, config=None, traffic=None,
            limits=None, fault=None) -> dict:
    """One run of `cell` on `device` -> the result object.  config,
    traffic and limits default to the cell's files; `fault` plants one of
    the regimes' faults (tests)."""
    import torch

    from portbench.metrics import trace as trace_mod
    config = config if config is not None else \
        catalog.read("configs", cell.config)
    traffic = traffic if traffic is not None else \
        catalog.read("traffic", cell.traffic)
    limits = limits if limits is not None else \
        catalog.read("limits", cell.name)
    regime = importlib.import_module(f"portbench.regimes.{config['regime']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prog = regime.Cell(config, traffic, seed, dev, fault=fault)
    try:
        sync()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        window_s, round_s, spans, losses = window(prog, seconds, sync)
        _log(f"set-up {setup_s:.3f} s, window {window_s:.3f} s, "
             f"{len(round_s)} rounds, quartiles (ms) "
             f"{[round(q * 1e3, 3) for q in quartiles(round_s)]}")
        slice_ = None
        if trace and cuda:
            from repro_torch.kernels import ops
            per = sorted(round_s)[len(round_s) // 2]
            n = max(1, min(SLICE_MAX_ROUNDS, int(SLICE_S / per)))
            slice_, misses = trace_mod.take(traced_rounds(prog, sync), n,
                                            ops.launch_counts)
            if slice_ is None:
                raise RuntimeError(f"no profiler slice held every port kernel's "
                                   f"launches: {misses}")
            _log(f"slice of {n} rounds, {slice_.attempts} attempt(s), "
                 f"{time.perf_counter() - t0 - window_s:.3f} s")
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        name = torch.cuda.get_device_name(dev) if cuda else None
        lost = torch.stack([x.detach().float().cpu() for x in losses])
        failed = int((~torch.isfinite(lost)).sum())
        run = Run(setup_s, window_s, round_s, spans, peak, slice_,
                  prog.kernel_bytes(), name, prog.precision(),
                  prog.flops_per_round())
        readings = prog.readings
    finally:
        prog.release()
    t_ref = time.perf_counter()
    ok, table = check.decide(check.gaps(readings,
                                        prog.reference_readings()), limits)
    _log(f"reference {time.perf_counter() - t_ref:.3f} s")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = catalog.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_out = {"platform": "gpu" if cuda else dev.type, "kind": name,
               "count": cell.chips, "memory_peak_bytes": int(peak),
               "power_limit": power_limit() if cuda else None}
    result = {"correct": bool(ok and failed == 0),
              "attempted": len(round_s), "failed": failed,
              "metrics": metrics, "device": dev_out}
    if slice_ is not None:
        dev_out["busy_s"] = slice_.busy_s
        dev_out["window_s"] = slice_.wall_s
        result["breakdown"] = {"device_ops": slice_.device_ops,
                               "idle_gaps": slice_.idle_gaps}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in table.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        cell = catalog.find_cell(catalog.load_benchmark(), args.workload)
        for kind, name in (("configs", cell.config),
                           ("traffic", cell.traffic), ("limits", cell.name)):
            catalog.read(kind, name)
    except (OSError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    cache_dirs()
    torch.set_num_threads(1)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found} (the JAX package or "
              f"JAX); no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
