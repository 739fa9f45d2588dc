"""CUDA compact-working-set scatter into the resident buffer
(csrc/gossip_scatter.cu), written in place, for one or up to MAX_PAIRS
(X, U) pairs that share one row table in one launch.

    U[rows[p], :] = X[p, :]                       (set)
    U[rows[p], :] = U[rows[p], :] + X[p, :]       (accumulate, f32 sum)

Replaces the Pallas TPU kernel `repro/kernels/gossip_scatter.py`
(`gossip_scatter_pallas`), whose output aliases U so the dormant rows are
never copied.  The torch form of that alias is a launch that writes into
U's own storage: U keeps its `data_ptr`, is returned, and no dormant row is
read or written.  X is rounded to U's dtype first, as in the reference.
The plain version is `kernels.ref.gossip_scatter_ref` (one pair) and
`kernels.ref.gossip_scatter_many_ref` (the pairs in turn).

Memory-bound, and launch-bound at the main path's n = 25 rows.  A block
of the (n, grid_y) grid moves chunks of `block_d` columns of its row for
every pair: chunk blockIdx.y, then every grid_y-th after it, so a row of
any width fits the grid's y extent (grid_y = min(chunks, MAX_GRID_Y); one
chunk a block wherever that covers the row, as at every Regime-A shape).
Each thread loads its X slots before the row id and moves `vecs` slots
of 4 columns per pair.  `plan` picks route and tiling by shape alone
(never on a failure):
  - "vector": a slot is one 16-byte access of f32 X (8 bytes of bf16);
    taken where d is a multiple of 4 and every base pointer is 16-byte
    aligned;
  - "scalar": a slot is 4 strided scalars, for odd widths and misaligned
    buffers.
block_d, on both: a multiple of 128 whose slots per pair (block_d / 1024,
rounded up to a power of two) times the pairs is at most MAX_SLOTS.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

MAX_PAIRS = 4                   # (X, U) pairs per launch
MAX_SLOTS = 8                   # slots of 4 columns per thread, all pairs
THREADS = 256                   # most threads of a block
MAX_GRID_Y = 65535              # the grid's y extent: blocks per row
MAX_ROWS = 2 ** 31 - 1          # the grid's x extent: rows per launch
RESIDENT_BLOCKS = 2048 // THREADS   # full blocks an SM holds at once
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


class Plan(NamedTuple):
    route: str           # "vector" or "scalar"
    block_d: int         # columns per chunk: 4 * threads * vecs
    chunks: int          # chunks per row: ceil(d / block_d)
    threads: int
    vecs: int            # 4-column slots per thread and pair: 1, 2, 4, 8
    blocks: int          # n * grid_y
    grid_y: int          # blocks per row, each striding over the chunks


def max_vecs(pairs: int) -> int:
    """The most slots per pair (a power of two) that `pairs` pairs can
    take within MAX_SLOTS."""
    v = 1
    while 2 * v * pairs <= MAX_SLOTS:
        v *= 2
    return v


@functools.lru_cache(maxsize=256)   # once per shape: calls are hot
def plan(n: int, d: int, sms: int, pairs: int = 1,
         block_d: int | None = None, *, aligned: bool = True) -> Plan:
    """Route and tiling for `pairs` pairs of X (n, d) into U (m, d) on a
    card of `sms` SMs.  aligned: every base pointer is 16-byte aligned.
    By default one slot a thread where the blocks fit one wave of the
    card (the main path), else the most slots.  Raises ValueError,
    naming the valid values, for a block_d or n the kernel cannot take."""
    if n < 1 or d < 1 or sms < 1 or not 1 <= pairs <= MAX_PAIRS:
        raise ValueError(f"plan needs n, d, sms >= 1 and 1 <= pairs <= "
                         f"{MAX_PAIRS}; got {n}, {d}, {sms}, {pairs}")
    if n > MAX_ROWS:
        raise ValueError(f"n={n} rows: one launch takes 1 to {MAX_ROWS} "
                         f"(the grid's x extent)")
    route = "vector" if aligned and d % 4 == 0 else "scalar"
    top = 4 * THREADS * max_vecs(pairs)
    if block_d is None:
        bd = min(4 * THREADS, -(-d // 128) * 128)
        if n * -(-d // bd) > sms * RESIDENT_BLOCKS:
            bd = top
    else:
        bd = int(block_d)
        if bd % 128 or not 128 <= bd <= top:
            raise ValueError(f"block_d={bd} for {pairs} pair(s): a multiple "
                             f"of 128 in [128, {top}] (at most {MAX_SLOTS} "
                             f"slots of 4 columns per thread over the pairs, "
                             f"{THREADS} threads)")
    vecs = 1
    while 4 * THREADS * vecs < bd:
        vecs *= 2
    chunks = -(-d // bd)
    grid_y = min(chunks, MAX_GRID_Y)
    return Plan(route, bd, chunks, bd // (4 * vecs), vecs, n * grid_y,
                grid_y)


class _Pairs(ctypes.Structure):
    _fields_ = [("X", ctypes.c_void_p * MAX_PAIRS),
                ("U", ctypes.c_void_p * MAX_PAIRS)]


def _name(x_dtype, u_dtype) -> str:
    return f"gossip_scatter_x{_TYPES[x_dtype]}_u{_TYPES[u_dtype]}"


def _lib() -> ctypes.CDLL:
    lib = _build.load("gossip_scatter")
    if not getattr(lib, "_repro_typed", False):
        for xt in _TYPES:
            for ut in _TYPES:
                fn = getattr(lib, _name(xt, ut))
                fn.argtypes = [ctypes.c_void_p, _Pairs] + [
                    ctypes.c_int] * 3 + [ctypes.c_longlong] + [
                    ctypes.c_int] * 6 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        consts = {"max_pairs": MAX_PAIRS, "max_slots": MAX_SLOTS,
                  "max_threads": THREADS, "max_grid_y": MAX_GRID_Y}
        for key, want in consts.items():
            got = getattr(lib, f"gossip_scatter_{key}")()
            if got != want:
                raise RuntimeError(f"csrc/gossip_scatter.cu has {key} "
                                   f"{got}, kernels/gossip_scatter.py {want}")
        lib._repro_typed = True
    return lib


def check_pairs(rows, Xs, Us) -> None:
    """What one launch takes, on either path: 1 to MAX_PAIRS pairs, the Xs
    of one dtype and the Us of one, every X (n, d) with n = len(rows) and
    every U (m, d)."""
    if not 1 <= len(Xs) == len(Us) <= MAX_PAIRS:
        raise ValueError(f"{len(Xs)} X and {len(Us)} U: want as many of "
                         f"each, 1 to {MAX_PAIRS}")
    if len({X.dtype for X in Xs}) != 1 or len({U.dtype for U in Us}) != 1:
        raise TypeError(f"the pairs must share one X and one U dtype; got "
                        f"X {[X.dtype for X in Xs]}, U "
                        f"{[U.dtype for U in Us]}")
    X0, U0 = Xs[0], Us[0]
    if rows.dim() != 1 or X0.dim() != 2 or U0.dim() != 2 \
            or X0.shape[0] != rows.shape[0] or X0.shape[1] != U0.shape[1] \
            or any(X.shape != X0.shape for X in Xs) \
            or any(U.shape != U0.shape for U in Us):
        raise ValueError(f"shapes rows {tuple(rows.shape)}, X "
                         f"{[tuple(X.shape) for X in Xs]}, U "
                         f"{[tuple(U.shape) for U in Us]}: want (n,), "
                         f"(n, d) and (m, d) for every pair")


def _check_inputs(rows, Xs, Us):
    check_pairs(rows, Xs, Us)
    ts = (rows, *Xs, *Us)
    if not all(t.is_cuda for t in ts):
        raise ValueError("gossip_scatter_cuda needs CUDA tensors (on "
                         f"{sorted({str(t.device) for t in ts})})")
    if len({t.device for t in ts}) != 1:
        raise ValueError("rows, X and U must lie on one device")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32; got {rows.dtype}")
    if Xs[0].dtype not in _TYPES or Us[0].dtype not in _TYPES:
        raise TypeError(f"X and U must be float32 or bfloat16; got "
                        f"{Xs[0].dtype}, {Us[0].dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("gossip_scatter_cuda needs contiguous rows, X and U")


def gossip_scatter_many_cuda(rows: torch.Tensor, Xs, Us,
                             accumulate: bool = False, *,
                             block_d: int | None = None) -> tuple:
    """One launch on the current stream writing every pair: rows (n,)
    int32 UNIQUE destination rows (an id outside [0, m) writes nothing),
    Xs and Us up to MAX_PAIRS tensors, each X (n, d), each U (m, d), the
    Xs of one dtype and the Us of one (f32 or bf16), all CUDA and
    contiguous.  Returns the Us themselves.  n = 0 or d = 0 returns them
    without a launch.  Counts one launch of `gossip_scatter_cuda`."""
    Xs, Us = tuple(Xs), tuple(Us)
    _check_inputs(rows, Xs, Us)
    n, d = Xs[0].shape
    m = Us[0].shape[0]
    if n == 0 or d == 0:
        return Us
    p = plan(n, d, _build.sm_count(Us[0].device), len(Xs), block_d,
             aligned=all(t.data_ptr() % 16 == 0 for t in Xs + Us))
    ptrs = _Pairs()
    for i, (X, U) in enumerate(zip(Xs, Us)):
        ptrs.X[i], ptrs.U[i] = X.data_ptr(), U.data_ptr()
    lib = _lib()
    fn = getattr(lib, _name(Xs[0].dtype, Us[0].dtype))
    with torch.cuda.device(Us[0].device):
        stream = torch.cuda.current_stream(Us[0].device).cuda_stream
        rc = fn(rows.data_ptr(), ptrs, len(Xs), n, m, d,
                int(bool(accumulate)), int(p.route == "vector"), p.chunks,
                p.grid_y, p.vecs, p.threads, stream)
    _build.check(lib, rc, f"gossip_scatter launch ({p.route} route)")
    gossip_scatter_cuda.launches += 1
    return Us


def gossip_scatter_cuda(rows: torch.Tensor, X: torch.Tensor, U: torch.Tensor,
                        accumulate: bool = False, *,
                        block_d: int | None = None) -> torch.Tensor:
    """`gossip_scatter_many_cuda` for the one pair (X, U): returns U."""
    return gossip_scatter_many_cuda(rows, (X,), (U,), accumulate,
                                    block_d=block_d)[0]


gossip_scatter_cuda.launches = 0
