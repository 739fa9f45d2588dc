"""CUDA dense push-sum mix over the stacked client axis
(csrc/pushsum_mix.cu).

    out = P @ U          P: (m, m) f32,  U: (m, d) f32 or bf16

Replaces the Pallas TPU kernel `repro/kernels/pushsum_mix.py`
(`pushsum_mix_pallas`).  A SIMT GEMM in IEEE f32 — no TF32, no tensor
cores, so it stays within f32 rounding of `kernels.ref.pushsum_mix_ref`
(its plain version).  At the main path's (m = 100, d = 13,328) it is
bound, narrowly, by f32 operations (3.98 us) over bytes (3.19 us).

`plan` chooses the tiling: one row tile of all m rows (padded to 8) when
m <= 128, else ceil(m / 128) row tiles of equal height; column panels of
`bn` columns picked so that the (row tile, panel) blocks spread evenly
over the SMs; the contraction staged 16 deep through a 4-stage cp.async
ring.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

BK, TM, TN, STAGES = 16, 8, 4, 4        # as in csrc/pushsum_mix.cu
MAX_TILE_M, MAX_BN = 128, 128
# a block's fixed cost (P tile staged, ring filled and drained) counted as
# this many columns of panel work when `plan` weighs panel widths
BLOCK_COST_COLS = 32
# widest panel when m > 128 (several blocks per SM): narrower blocks let
# two share an SM and hide each other's latency (m = 1024 on an H100:
# 64 columns beat 96-128, PERF.md)
MAX_BN_MULTI = 64


class Plan(NamedTuple):
    tile_m: int          # rows of a block tile (a multiple of TM)
    bn: int              # columns of a panel (a multiple of 8)
    row_tiles: int
    panels: int
    threads: int
    smem: int            # bytes of dynamic shared memory
    tiles_per_sm: int    # blocks the busiest SM runs: ceil(blocks / sms)
    balance: float       # the mean SM's panel columns over the busiest's


@functools.lru_cache(maxsize=256)   # once per shape: calls are hot
def plan(m: int, d: int, elem_bytes: int, sms: int) -> Plan:
    """The kernel's tiling for P (m, m) @ U (m, d) with U's element size
    `elem_bytes` on a card of `sms` SMs.  Row tiles: the fewest of at
    most 128 rows, of equal height rounded up to TM.  Panel width bn (a
    multiple of 8 up to 128, or MAX_BN_MULTI for several row tiles, and up
    to d rounded up to 8): the one whose busiest SM has the least work,
    ceil(blocks / sms) * (bn + BLOCK_COST_COLS) (ties: the wider panel)."""
    if m < 1 or d < 1 or sms < 1:
        raise ValueError(f"plan needs m, d, sms >= 1; got {m}, {d}, {sms}")
    row_tiles = -(-m // MAX_TILE_M)
    tile_m = -(-(-(-m // row_tiles)) // TM) * TM
    best = None
    widest = MAX_BN if row_tiles == 1 else MAX_BN_MULTI
    for bn in range(8, min(widest, -(-d // 8) * 8) + 1, 8):
        panels = -(-d // bn)
        cost = -(-(panels * row_tiles) // sms) * (bn + BLOCK_COST_COLS)
        if best is None or cost <= best[0]:
            best = (cost, bn, panels)
    _, bn, panels = best
    threads = -(-((tile_m // TM) * (bn // TN)) // 32) * 32
    smem = STAGES * BK * (tile_m * 4 + bn * elem_bytes)
    per_sm = -(-(panels * row_tiles) // sms)
    return Plan(tile_m, bn, row_tiles, panels, threads, smem, per_sm,
                d * row_tiles / (sms * per_sm * bn))


def _lib() -> ctypes.CDLL:
    lib = _build.load("pushsum_mix")
    if not getattr(lib, "_repro_typed", False):
        for fn in (lib.pushsum_mix_f32, lib.pushsum_mix_bf16):
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_inputs(P, U):
    if not (P.is_cuda and U.is_cuda):
        raise ValueError("pushsum_mix_cuda needs CUDA tensors (P "
                         f"{P.device}, U {U.device})")
    if P.device != U.device:
        raise ValueError("P and U must lie on one device")
    if P.dtype != torch.float32:
        raise TypeError(f"P must be float32; got {P.dtype}")
    if U.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"U must be float32 or bfloat16; got {U.dtype}")
    if U.dim() != 2 or tuple(P.shape) != (U.shape[0], U.shape[0]):
        raise ValueError(f"shapes P {tuple(P.shape)}, U {tuple(U.shape)}: "
                         f"want (m, m), (m, d)")
    if not (P.is_contiguous() and U.is_contiguous()):
        raise ValueError("pushsum_mix_cuda needs contiguous P and U")
    if -(-U.shape[0] // MAX_TILE_M) > 65535:
        raise ValueError(f"m={U.shape[0]} needs more than 65535 row tiles")


def pushsum_mix_cuda(P: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream.  P (m, m) f32, U (m, d) f32
    or bf16, both CUDA and contiguous.  Returns a new (m, d) tensor in U's
    dtype.  m = 0 or d = 0 returns without a launch."""
    _check_inputs(P, U)
    m, d = U.shape
    out = torch.empty_like(U)
    if m == 0 or d == 0:
        return out
    sms = _build.sm_count(U.device)
    p = plan(m, d, U.element_size(), sms)
    lib = _lib()
    fn = lib.pushsum_mix_f32 if U.dtype == torch.float32 \
        else lib.pushsum_mix_bf16
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        rc = fn(P.data_ptr(), U.data_ptr(), out.data_ptr(), m, d, p.tile_m,
                p.bn, stream)
    _build.check(lib, rc, "pushsum_mix launch")
    pushsum_mix_cuda.launches += 1
    return out


pushsum_mix_cuda.launches = 0
