"""Profiler + wall-clock hooks (port of `repro/obs/profiler.py`).

Two layers, deliberately separate:

  maybe_trace(dir)  device-level: wraps a region in `torch.profiler`
                    (CPU activity, and CUDA activity when a GPU is
                    present) when `dir` is set, no-op otherwise, and
                    writes one Chrome trace JSON into `dir` on exit — the
                    kernels launched inside (gossip_gather, ...) appear by
                    name.
  PhaseTimer        host-level: perf_counter phase buckets emitted as
                    plain gauges on the round/tick record.

PhaseTimer measures HOST wall-clock.  For the number to mean device time
rather than launch time, the phase must wait for its outputs before the
bucket closes — `phase(name, block=True)` does that: assign the phase's
result to the yielded holder's `.out` and the bucket synchronizes the
card the result lies on (nothing for CPU tensors).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Optional

import torch


@contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """torch.profiler over the region when profile_dir is set, writing
    `trace-<pid>-<ns>.json` into it; a no-op otherwise."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _cuda_device(out):
    """The device of the first CUDA tensor in out (tensor, dict, list,
    tuple), or None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (list, tuple)) else ()
    for x in items:
        dev = _cuda_device(x)
        if dev is not None:
            return dev
    return None


class _PhaseResult:
    """The holder `phase()` yields: set `.out` to the phase's result and
    a block=True phase waits on it before the bucket closes."""
    __slots__ = ("out",)

    def __init__(self):
        self.out: Any = None


class PhaseTimer:
    """Named perf_counter buckets: accumulate seconds per phase, then
    `gauges()` renders them as `t_<phase>_s` record fields.

        pt = PhaseTimer()
        with pt.phase("round", block=True) as ph:
            state, metrics = step(state)
            ph.out = metrics          # synchronized before closing
        sink.emit(round_record(step=r, **pt.gauges(), ...))

    Re-entering a phase accumulates; `reset()` clears between emits."""

    def __init__(self):
        self._acc: dict = {}

    @contextmanager
    def phase(self, name: str, block: bool = False):
        holder = _PhaseResult()
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            if block and holder.out is not None:
                dev = _cuda_device(holder.out)
                if dev is not None:
                    torch.cuda.synchronize(dev)
            self._acc[name] = (self._acc.get(name, 0.0)
                               + time.perf_counter() - t0)

    def seconds(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def gauges(self) -> dict:
        return {f"t_{k}_s": round(v, 6) for k, v in self._acc.items()}

    def reset(self) -> None:
        self._acc.clear()
