"""device_idle_share: the share of the profiler slice's wall time in which
no device event ran (1 - union of device intervals / slice)."""


def read(run):
    s = run.slice
    return 100.0 * (1.0 - s.busy_s / s.wall_s) if s is not None else None
