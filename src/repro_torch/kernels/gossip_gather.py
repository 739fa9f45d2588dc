"""CUDA gossip gather-mix over the flat client buffer (csrc/gossip_gather.cu).

    out[i, :] = sum_{j < k} w[i, j] * U[idx[i, j], :]        U: (m, d)

Replaces the Pallas TPU kernel `repro/kernels/gossip_gather.py`
(`gossip_gather_pallas`).  Memory-bound on an H100: at the main path's
(m=100, k=11, d=13,328) f32 shape the unique bytes are U read once plus the
output written once (10.7 MB); the 58.6 MB the gather touches is mostly
served from L2, which holds all of U (5.3 MB).  One block per (row, d-chunk)
stages its own neighbor ids and weights, threads stride coalesced over the
chunk, and every thread sums the neighbors in j order in f32 with rounded
multiply then add — so for f32 U the kernel equals `core.gossip.mix_rows`
bit for bit.  The plain version is `kernels.ref.gossip_gather_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_BLOCK_D = 1024          # columns per block (256 threads x 4)
MAX_K = 6144                    # idx + w staging must fit 48 KB of smem


def _lib() -> ctypes.CDLL:
    lib = _build.load("gossip_gather")
    if not getattr(lib, "_repro_typed", False):
        for fn in (lib.gossip_gather_f32, lib.gossip_gather_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gossip_gather_cols_per_thread.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_inputs(idx, w, U, block_d):
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
            or idx.shape[0] != U.shape[0]:
        raise ValueError(f"shapes idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)}, U {tuple(U.shape)}: want "
                         f"(m, k), (m, k), (m, d)")
    if not (idx.is_contiguous() and w.is_contiguous()
            and U.is_contiguous()):
        raise ValueError("gossip_gather_cuda needs contiguous idx, w and U")
    if idx.shape[1] > MAX_K:
        raise ValueError(f"k={idx.shape[1]} > {MAX_K}: the neighbor table "
                         f"row is staged in 48 KB of shared memory")
    if block_d % 128 or not 128 <= block_d <= 4096:
        raise ValueError(f"block_d={block_d}: a multiple of 128 in "
                         f"[128, 4096] (4 columns per thread)")
    if -(-U.shape[1] // block_d) > 65535:
        raise ValueError(f"d={U.shape[1]} needs more than 65535 d-chunks "
                         f"of block_d={block_d}")


def gossip_gather_cuda(idx: torch.Tensor, w: torch.Tensor, U: torch.Tensor,
                       *, block_d: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  idx (m, k) int32 neighbor
    ids in [0, m), w (m, k) f32 weights, U (m, d) f32 or bf16 — all CUDA
    and contiguous.  Returns a new (m, d) tensor in U's dtype.  m = 0 or
    d = 0 returns without a launch."""
    block_d = DEFAULT_BLOCK_D if block_d is None else int(block_d)
    _check_inputs(idx, w, U, block_d)
    m, k = idx.shape
    d = U.shape[1]
    out = torch.empty_like(U)
    if m == 0 or d == 0:
        return out
    lib = _lib()
    fn = lib.gossip_gather_f32 if U.dtype == torch.float32 \
        else lib.gossip_gather_bf16
    threads = block_d // lib.gossip_gather_cols_per_thread()
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        rc = fn(idx.data_ptr(), w.data_ptr(), U.data_ptr(), out.data_ptr(),
                m, k, d, threads, stream)
    _build.check(lib, rc, "gossip_gather launch")
    gossip_gather_cuda.launches += 1
    return out


gossip_gather_cuda.launches = 0
