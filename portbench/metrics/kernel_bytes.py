"""The least bytes a call of the port's mixing kernels moves: each input
read once, each output written once (the bounds of PERF.md's kernel
table, copied from the port's `chip_smoke.py`)."""
from __future__ import annotations


def gather(n: int, k: int, N: int, d: int, elem: int) -> int:
    """`gossip_gather`: out (n, d) = the (n, k) table over U (N, d): U
    read, out written, the table's int32 ids and f32 weights read."""
    return N * d * elem + n * d * elem + n * k * 8


def scatter(n: int, d: int, pairs: int, elem_x: int, elem_u: int) -> int:
    """`gossip_scatter` of `pairs` (X (n, d), U (m, d)) pairs: each X
    read, its n rows of U written, the int32 row ids read."""
    return pairs * n * d * (elem_x + elem_u) + n * 4
