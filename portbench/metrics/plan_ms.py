"""plan_ms: the round driver's host work per round (the table, its
restriction to the round's participants, the table and ids to the device,
the minibatches), by the benchmark's host spans in the untraced window."""
import statistics


def read(run):
    s = run.spans.get("plan")
    return 1e3 * statistics.fmean(s) if s else None
