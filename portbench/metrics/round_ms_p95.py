"""round_ms_p95: the 95th percentile of the window's round times (each
from the end of the round before to the end of its own device sync)."""
import numpy as np


def read(run):
    return float(np.percentile(run.round_s, 95)) * 1e3 if run.round_s \
        else None
