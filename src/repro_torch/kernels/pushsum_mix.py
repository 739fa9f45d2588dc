"""CUDA dense push-sum mix over the stacked client axis
(csrc/pushsum_mix.cu).

    out = P @ U          P: (m, m) f32,  U: (m, d) f32 or bf16

Replaces the Pallas TPU kernel `repro/kernels/pushsum_mix.py`
(`pushsum_mix_pallas`).  A tiled SIMT GEMM in IEEE f32 — no TF32, no
tensor cores, so it stays within f32 rounding of
`kernels.ref.pushsum_mix_ref` (its plain version): 64 x 128 output tiles,
the contraction staged through shared memory 16 deep, an 8 x 4 register
tile per thread.  At the main path's (m = 100, d = 13,328) it is bound,
narrowly, by f32 operations (3.98 us) over bytes (3.19 us).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("pushsum_mix")
    if not getattr(lib, "_repro_typed", False):
        for fn in (lib.pushsum_mix_f32, lib.pushsum_mix_bf16):
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
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
    if -(-U.shape[0] // 64) > 65535:
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
    lib = _lib()
    fn = lib.pushsum_mix_f32 if U.dtype == torch.float32 \
        else lib.pushsum_mix_bf16
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        rc = fn(P.data_ptr(), U.data_ptr(), out.data_ptr(), m, d, stream)
    _build.check(lib, rc, "pushsum_mix launch")
    pushsum_mix_cuda.launches += 1
    return out


pushsum_mix_cuda.launches = 0
