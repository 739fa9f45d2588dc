"""setup_s: process start until the window opens (imports, the kernels'
build on a checkout's first run, inputs and weights, the program's set-up
and its first rounds, which warm every shape up)."""


def read(run):
    return run.setup_s
