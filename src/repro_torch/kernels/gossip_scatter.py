"""CUDA compact-working-set scatter into the resident buffer
(csrc/gossip_scatter.cu), written in place.

    U[rows[p], :] = X[p, :]                       (set)
    U[rows[p], :] = U[rows[p], :] + X[p, :]       (accumulate, f32 sum)

Replaces the Pallas TPU kernel `repro/kernels/gossip_scatter.py`
(`gossip_scatter_pallas`), whose output aliases U so the dormant rows are
never copied.  The torch form of that alias is a launch that writes into
U's own storage: U keeps its `data_ptr`, is returned, and no dormant row is
read or written.  Memory-bound (launch-bound at the main path's n = 25
rows): one block per (compact row, d-chunk), coalesced, four columns per
thread, moved as one vector where d is a multiple of 4 and the buffers are
16-byte aligned.  X is rounded to U's dtype first, as in the reference.
The plain version is `kernels.ref.gossip_scatter_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_BLOCK_D = 1024          # columns per block (256 threads x 4)
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _name(x_dtype, u_dtype) -> str:
    return f"gossip_scatter_x{_TYPES[x_dtype]}_u{_TYPES[u_dtype]}"


def _lib() -> ctypes.CDLL:
    lib = _build.load("gossip_scatter")
    if not getattr(lib, "_repro_typed", False):
        for xt in _TYPES:
            for ut in _TYPES:
                fn = getattr(lib, _name(xt, ut))
                fn.argtypes = [ctypes.c_void_p] * 3 + [
                    ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
        lib.gossip_scatter_cols_per_thread.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_inputs(rows, X, U, block_d):
    if not (rows.is_cuda and X.is_cuda and U.is_cuda):
        raise ValueError("gossip_scatter_cuda needs CUDA tensors (rows "
                         f"{rows.device}, X {X.device}, U {U.device})")
    if not (rows.device == X.device == U.device):
        raise ValueError("rows, X and U must lie on one device")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32; got {rows.dtype}")
    if X.dtype not in _TYPES or U.dtype not in _TYPES:
        raise TypeError(f"X and U must be float32 or bfloat16; got "
                        f"{X.dtype}, {U.dtype}")
    if rows.dim() != 1 or X.dim() != 2 or U.dim() != 2 \
            or X.shape[0] != rows.shape[0] or X.shape[1] != U.shape[1]:
        raise ValueError(f"shapes rows {tuple(rows.shape)}, X "
                         f"{tuple(X.shape)}, U {tuple(U.shape)}: want (n,), "
                         f"(n, d), (m, d)")
    if not (rows.is_contiguous() and X.is_contiguous()
            and U.is_contiguous()):
        raise ValueError("gossip_scatter_cuda needs contiguous rows, X and U")
    if block_d % 128 or not 128 <= block_d <= 4096:
        raise ValueError(f"block_d={block_d}: a multiple of 128 in "
                         f"[128, 4096] (4 columns per thread)")
    if -(-U.shape[1] // block_d) > 65535:
        raise ValueError(f"d={U.shape[1]} needs more than 65535 d-chunks "
                         f"of block_d={block_d}")


def gossip_scatter_cuda(rows: torch.Tensor, X: torch.Tensor, U: torch.Tensor,
                        accumulate: bool = False, *,
                        block_d: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream, writing into U.  rows (n,)
    int32 UNIQUE destination rows (an id outside [0, m) writes nothing), X
    (n, d), U (m, d) — X and U each f32 or bf16, all CUDA and contiguous.
    Returns U itself.  n = 0 or d = 0 returns U without a launch."""
    block_d = DEFAULT_BLOCK_D if block_d is None else int(block_d)
    _check_inputs(rows, X, U, block_d)
    n, d = X.shape
    if n == 0 or d == 0:
        return U
    lib = _lib()
    fn = getattr(lib, _name(X.dtype, U.dtype))
    threads = block_d // lib.gossip_scatter_cols_per_thread()
    vec = d % 4 == 0 and X.data_ptr() % 16 == 0 and U.data_ptr() % 16 == 0
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        rc = fn(rows.data_ptr(), X.data_ptr(), U.data_ptr(), n, U.shape[0],
                d, int(bool(accumulate)), int(vec), threads, stream)
    _build.check(lib, rc, "gossip_scatter launch")
    gossip_scatter_cuda.launches += 1
    return U


gossip_scatter_cuda.launches = 0
