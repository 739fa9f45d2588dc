"""A port kernel's share of its memory roofline: the least bytes a call
moves at the card's published bandwidth, over the call's device time in
the profiler slice."""
import statistics

from portbench.metrics import peaks


def share(run, kernel: str):
    calls = run.slice.port_s.get(kernel) if run.slice is not None else None
    need = run.kernel_bytes.get(kernel)
    if not calls or need is None:
        return None
    bound_s = need / peaks.hbm(run.device_name)
    return 100.0 * bound_s / statistics.fmean(calls)
