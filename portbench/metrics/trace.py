"""The profiler slice of a traced run: whole rounds under torch.profiler,
kept only where the trace holds every launch of the port's kernels.

On the H100 the profiler now and then drops kernel events (the port's
`chip_smoke.py` `profiled` / `device_ms` retry for it).  A slice is
accepted when, for each of the port's seven kernels, the events named
after it number exactly the launches its wrapper counted
(`kernels.ops.launch_counts()`), and the device's busy time fits inside
the CUDA events recorded around the same rounds; else it is taken again,
at most ATTEMPTS times, with a wider quiet margin each time.
"""
from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Callable, NamedTuple, Optional

# kernel function (csrc/*.cu) -> the port kernel whose launches it counts
PORT_KERNELS = {
    "gossip_gather_kernel": "gossip_gather",
    "gossip_gather_panel_kernel": "gossip_gather",
    "gossip_scatter_kernel": "gossip_scatter",
    "pushsum_mix_kernel": "pushsum_mix",
    "topk_gather_kernel": "topk_gather",
    "topk_staged_kernel": "topk_gather",
    "head_warp_kernel": "head_gather_matmul",
    "head_tiled_kernel": "head_gather_matmul",
    "flash_attention_kernel": "flash_attention",
    "flash_attention_wgmma_kernel": "flash_attention",
    "rglru_kernel": "rglru",
}
SPANS = ("portbench.plan", "portbench.dispatch", "portbench.sync")
SLICE = "portbench.slice"
ATTEMPTS = 5
PAD_S = 0.002
TOP = 10


class Slice(NamedTuple):
    rounds: int
    wall_s: float                # the slice's host span
    busy_s: float                # union of device events inside it
    port_s: dict                 # port kernel -> [seconds of each call]
    library_s: float             # every other device event, summed
    device_ops: list             # [[name, seconds]] the TOP by time
    idle_gaps: list              # [[host activity, seconds]] the TOP
    attempts: int


def port_kernel(name: str) -> Optional[str]:
    for token in re.findall(r"\w+", name):
        if token in PORT_KERNELS:
            return PORT_KERNELS[token]
    return None


def merge(intervals: list, lo: float, hi: float) -> list:
    """Sorted disjoint union of (start, end) clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(t: float, spans: list, ops: list, starts: list) -> str:
    """What the host was doing at t (us): the benchmark's span and the
    innermost operator running then."""
    span = next((n.split(".", 1)[1] for n, s, e in spans if s <= t < e),
                "between rounds")
    best = None
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(ops[max(0, i - 400):i]):
        if e > t and (best is None or s > best[1]):
            best = (name, s)
    return span if best is None else f"{span}: {best[0][:60]}"


def reduce(events, rounds: int) -> Optional[Slice]:
    """A profiler's events -> the slice's numbers (None without a slice
    span).  Times are microseconds in the events, seconds out."""
    dev, cpu, slice_span, spans = [], [], None, []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench."):
            # the benchmark's ranges come back on the device's timeline
            # too (as annotations); only their host side is a span
            if str(e.device_type).endswith("CUDA"):
                continue
        if str(e.device_type).endswith("CUDA"):
            dev.append((e.name, s, t))
        elif e.name == SLICE:
            slice_span = (s, t)
        elif e.name in SPANS:
            spans.append((e.name, s, t))
        else:
            cpu.append((e.name, s, t))
    if slice_span is None:
        return None
    lo, hi = slice_span
    busy = merge([(s, t) for _, s, t in dev], lo, hi)
    port, library, by_name = collections.defaultdict(list), 0.0, \
        collections.Counter()
    for name, s, t in dev:
        k = port_kernel(name)
        if k is None:
            library += t - s
        else:
            port[k].append((t - s) / 1e6)
        by_name[name[:90]] += (t - s) / 1e6
    cpu.sort(key=lambda x: x[1])
    starts = [s for _, s, _ in cpu]
    cuts = sorted({x for _, s, t in spans for x in (s, t)})
    gaps = collections.Counter()
    edge = lo
    for s, t in busy + [[hi, hi]]:
        # an idle gap, cut where the benchmark's spans begin and end
        inner = [c for c in cuts if edge < c < s]
        for a, b in zip([edge] + inner, inner + [s]):
            if b > a:
                gaps[_label((a + b) / 2, spans, cpu, starts)] += (b - a) / 1e6
        edge = max(edge, t)
    return Slice(rounds, (hi - lo) / 1e6, sum(t - s for s, t in busy) / 1e6,
                 dict(port), library / 1e6,
                 [[n, v] for n, v in by_name.most_common(TOP)],
                 [[n, v] for n, v in gaps.most_common(TOP)], 0)


def take(run_rounds: Callable[[int], None], rounds: int,
         launch_counts: Callable[[], dict]) -> tuple:
    """Profile `rounds` more rounds (run_rounds(n) runs them, each ending
    in a device sync) -> (Slice or None, [why each refused slice was])."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.metrics.timer import Events
    misses = []
    for attempt in range(ATTEMPTS):
        pad = PAD_S * 4 ** attempt
        torch.cuda.synchronize()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            with record_function(SLICE), Events() as ev:
                run_rounds(rounds)
            time.sleep(pad)
        after = launch_counts()
        s = reduce(prof.events(), rounds)
        want = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        got = {} if s is None else {k: len(v) for k, v in s.port_s.items()}
        span_ms = ev.ms()
        if s is not None and got == want and s.busy_s * 1e3 <= \
                span_ms * 1.001 + 0.01:
            return s._replace(attempts=attempt + 1), misses
        misses.append(f"attempt {attempt + 1}: launches {want}, events "
                      f"{got}, busy {None if s is None else s.busy_s} s in "
                      f"{span_ms} ms of events")
    return None, misses
