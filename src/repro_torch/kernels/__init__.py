"""Hand-written CUDA kernels for Hopper (sources in `repro_torch/csrc/`),
their plain-torch versions (`ref`) and the `ops` dispatch."""
