"""round_ms: the window's wall time over the rounds it completed; each
round ends in a device sync, and the window holds nothing but rounds."""


def read(run):
    return 1e3 * run.window_s / len(run.round_s) if run.round_s else None
