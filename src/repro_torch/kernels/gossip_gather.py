"""CUDA gossip gather-mix over the flat client buffer (csrc/gossip_gather.cu).

    out[i, :] = sum_{j < k} w[i, j] * U[idx[i, j], :]        U: (N, d)

for the n rows i of the (n, k) table, over a buffer of N >= n rows (the
cross-rank matrix mix hands it its own rows plus the received halo).

Replaces the Pallas TPU kernel `repro/kernels/gossip_gather.py`
(`gossip_gather_pallas`).  Memory-bound on an H100: at the main path's
(m=100, k=11, d=13,328) f32 shape the unique bytes are U read once plus the
output written once (10.7 MB).  Every thread sums the neighbors in j order
in f32 with rounded multiply then add — so for f32 U the kernel equals
`core.gossip.mix_rows` bit for bit.  The plain version is
`kernels.ref.gossip_gather_ref`.

Two routes, chosen by shape alone in `plan` (never on a failure):
  - "panel": one block per column panel of `block_d` columns stages the
    panel for all N buffer rows in shared memory and computes every output
    row of it there, so U is read once.  Taken whenever a panel of 16
    columns of all N rows fits in a block's shared memory (N <= 3,632 in
    f32, 7,264 in bf16).  block_d: a multiple of 16 bytes of U's dtype (4 f32
    or 8 bf16 columns) whose panel fits, at most TN x PANEL_THREADS =
    4,096 (a thread owns TN columns of a panel); the default spreads the
    panels evenly over the SMs (at few rows and a wide buffer, as Regime
    B's (4, d 494,031,872), the widest: 4,096).
  - "row": one block per (output row, chunk of `block_d` columns) gathers
    its k neighbor rows from L2 (the first port's kernel); N bounds the
    ids only.  block_d: a
    multiple of 128 in [128, 4096]; default 1024.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

MAX_SMEM = 232448               # bytes of shared memory a block may use
PANEL_MIN_COLS = 16             # the panel route needs m x 16 columns
TN = 4                          # panel route: columns per thread
PANEL_THREADS = 1024            # panel route: most threads per block
BLOCK_COST_COLS = 8             # a panel block's fixed cost, in columns
ROW_BLOCK_D = 1024              # row route default (256 threads x 4)
MAX_K = 6144                    # row route: idx + w row in 48 KB of smem


class Plan(NamedTuple):
    route: str           # "panel" or "row"
    block_d: int         # columns per block
    blocks: int
    threads: int
    table: bool          # panel: neighbor table staged in shared memory
    smem: int            # bytes of dynamic shared memory
    blocks_per_sm: int   # ceil(blocks / sms)
    balance: float       # panel: the mean SM's columns over the busiest's


def _panel_bytes(rows: int, bn: int, elem_bytes: int) -> int:
    return -(-rows * bn * elem_bytes // 16) * 16


@functools.lru_cache(maxsize=256)   # once per shape: calls are hot
def plan(m: int, k: int, d: int, elem_bytes: int, sms: int,
         block_d: int | None = None, rows: int | None = None) -> Plan:
    """Route and tiling for idx (m, k) over U (N, d), N = `rows` (default
    m, at least m), with U's element size `elem_bytes` on a card of `sms`
    SMs: the panel stages N rows, the table and the output hold m.  Raises
    ValueError, naming the valid values, for a block_d its route cannot
    take."""
    N = m if rows is None else int(rows)
    if m < 1 or d < 1 or sms < 1 or k < 0 or N < m:
        raise ValueError(f"plan needs m, d, sms >= 1, k >= 0 and rows >= "
                         f"m; got {m}, {d}, {sms}, {k}, rows {N}")
    if N * PANEL_MIN_COLS * elem_bytes > MAX_SMEM:      # the row route
        bd = ROW_BLOCK_D if block_d is None else int(block_d)
        if bd % 128 or not 128 <= bd <= 4096:
            raise ValueError(f"block_d={bd} on the row route (N={N}): a "
                             f"multiple of 128 in [128, 4096] (4 columns "
                             f"per thread)")
        if k > MAX_K:
            raise ValueError(f"k={k} > {MAX_K}: the row route stages a "
                             f"neighbor table row in 48 KB of shared memory")
        chunks = -(-d // bd)
        if chunks > 65535:
            raise ValueError(f"d={d} needs more than 65535 d-chunks of "
                             f"block_d={bd}")
        blocks = m * chunks
        return Plan("row", bd, blocks, bd // 4, False, 8 * k,
                    -(-blocks // sms), 1.0)
    align = 16 // elem_bytes
    # the panel fits shared memory, and its column groups the block
    max_bd = min(MAX_SMEM // (N * elem_bytes) // align * align,
                 TN * PANEL_THREADS)
    if block_d is None:
        best = None
        for bn in range(align, min(max_bd, -(-d // align) * align) + 1,
                        align):
            cost = -(-(-(-d // bn)) // sms) * (bn + BLOCK_COST_COLS)
            if best is None or cost <= best[0]:
                best = (cost, bn)
        bn = best[1]
    else:
        bn = int(block_d)
        if bn % align or not align <= bn <= max_bd:
            raise ValueError(f"block_d={bn} on the panel route (N={N}, "
                             f"{elem_bytes}-byte U): a multiple of {align} "
                             f"in [{align}, {max_bd}], so that N x block_d "
                             f"fits {MAX_SMEM} B of shared memory and "
                             f"block_d / {TN} column groups {PANEL_THREADS} "
                             f"threads")
    threads = min(PANEL_THREADS, -(-(bn // TN * m) // 32) * 32)
    panel = _panel_bytes(N, bn, elem_bytes)
    table = panel + 8 * m * k <= MAX_SMEM
    blocks = -(-d // bn)
    per_sm = -(-blocks // sms)
    return Plan("panel", bn, blocks, threads, table,
                panel + (8 * m * k if table else 0), per_sm,
                d / (sms * per_sm * bn))


def _lib() -> ctypes.CDLL:
    lib = _build.load("gossip_gather")
    if not getattr(lib, "_repro_typed", False):
        # (idx, w, U, out, n, N, k, d, ...)
        for fn in (lib.gossip_gather_f32, lib.gossip_gather_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.gossip_gather_panel_f32, lib.gossip_gather_panel_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_inputs(idx, w, U):
    if not (idx.is_cuda and w.is_cuda and U.is_cuda):
        raise ValueError("gossip_gather_cuda needs CUDA tensors "
                         f"(idx {idx.device}, w {w.device}, U {U.device})")
    if not (idx.device == w.device == U.device):
        raise ValueError("idx, w and U must lie on one device")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and w float32; got {idx.dtype}, "
                        f"{w.dtype}")
    if U.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"U must be float32 or bfloat16; got {U.dtype}")
    if U.dim() != 2 or idx.dim() != 2 or w.shape != idx.shape \
            or idx.shape[0] > U.shape[0]:
        raise ValueError(f"shapes idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)}, U {tuple(U.shape)}: want "
                         f"(n, k), (n, k), (N, d) with N >= n")
    if not (idx.is_contiguous() and w.is_contiguous()
            and U.is_contiguous()):
        raise ValueError("gossip_gather_cuda needs contiguous idx, w and U")


def gossip_gather_cuda(idx: torch.Tensor, w: torch.Tensor, U: torch.Tensor,
                       *, block_d: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  idx (n, k) int32 neighbor
    ids in [0, N) (an id outside gives a NaN row), w (n, k) f32 weights,
    U (N, d) f32 or bf16 with N >= n — all CUDA and contiguous.  Returns a
    new (n, d) tensor in U's dtype.  n = 0 or d = 0 returns without a
    launch.  block_d: columns per block on the route `plan` takes (see
    the module docstring for the valid values)."""
    _check_inputs(idx, w, U)
    m, k = idx.shape
    N, d = U.shape
    out = torch.empty((m, d), dtype=U.dtype, device=U.device)
    if m == 0 or d == 0:
        return out
    sms = _build.sm_count(U.device)
    p = plan(m, k, d, U.element_size(), sms, block_d, N)
    lib = _lib()
    f32 = U.dtype == torch.float32
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        args = (idx.data_ptr(), w.data_ptr(), U.data_ptr(), out.data_ptr(),
                m, N, k, d)
        if p.route == "panel":
            fn = lib.gossip_gather_panel_f32 if f32 \
                else lib.gossip_gather_panel_bf16
            rc = fn(*args, p.block_d, p.threads, int(p.table), stream)
        else:
            fn = lib.gossip_gather_f32 if f32 else lib.gossip_gather_bf16
            rc = fn(*args, p.threads, stream)
    _build.check(lib, rc, f"gossip_gather launch ({p.route} route)")
    gossip_gather_cuda.launches += 1
    return out


gossip_gather_cuda.launches = 0
