"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line.  Everything a cell needs is found by name: its configuration in
`configs/`, its traffic in `traffic/`, the limits of its output check in
`limits/`, its round driver in `regimes/` (the configuration's `regime`),
its plain reference in `reference/` (the configuration's `reference`) and
each per-layer metric's reader in `metrics/`.  See README.md.
"""
