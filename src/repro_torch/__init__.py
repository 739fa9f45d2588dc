"""PyTorch/CUDA port of the DFedPGP system (the JAX package `repro` is the
reference it is checked against).

Layout mirrors `repro`: `kernels/` (hand-written CUDA kernels for Hopper,
their plain-torch versions and the `ops` dispatch), `models/`, `core/`,
`optim/`, `data/`, `fl/`, `serve/`, plus `convert` (state carried across
from the reference).  Entry points run on CUDA unless the caller passes
`device="cpu"`; they raise when no GPU is present instead of falling back.
"""
