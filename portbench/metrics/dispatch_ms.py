"""dispatch_ms: the host time from the call of the round function
(`round_fn_flat` / `round_fn_sampled`) to its return, before the device
sync, by the benchmark's host spans in the untraced window."""
import statistics


def read(run):
    s = run.spans.get("dispatch")
    return 1e3 * statistics.fmean(s) if s else None
