"""library_device_ms: device time per round of every event in the
profiler slice that is not one of the port's kernels (PyTorch's and
cuDNN's kernels of the model step and the optimizer, copies, fills)."""


def read(run):
    s = run.slice
    return 1e3 * s.library_s / s.rounds if s is not None else None
