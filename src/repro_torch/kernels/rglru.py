"""CUDA RG-LRU linear recurrence (csrc/rglru.cu).

    h[b, t] = a[b, t] * h[b, t-1] + b[b, t],   h[b, -1] = 0    (B, S, W) f32

Replaces the Pallas TPU kernel `repro/kernels/rglru.py` (`rglru_pallas`),
which asserts S % 256 == 0 and W % 128 == 0; this one takes any S and W.
Bound by bytes (two reads and one write of 4 bytes per element: 403 MB,
0.12 ms at 3.35 TB/s at the model's (2, 4096, 4096)).  One thread per
(b, w) chain, consecutive threads on consecutive w so each step's loads
coalesce, the next `bs` time steps loaded ahead of the dependent chain
(more steps in flight hide more latency: 32 beat 16 and 8 on the card);
each step is a rounded product then a rounded sum, bit for bit the plain
version `kernels.ref.rglru_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

STEPS = (1, 2, 4, 8, 16, 32)    # time steps loaded ahead (compiled cases)
DEFAULT_STEPS = 32       # fastest at (2, 4096, 4096) on an H100
DEFAULT_THREADS = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru")
    if not getattr(lib, "_repro_typed", False):
        lib.rglru_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.rglru_f32.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_inputs(a, b, steps, threads):
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"rglru_cuda needs CUDA tensors (a {a.device}, "
                         f"b {b.device})")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32; got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}: "
                         f"want two equal (B, S, W)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_cuda needs contiguous a and b")
    if steps not in STEPS:
        raise ValueError(f"bs={steps}: time steps loaded ahead, one of "
                         f"{STEPS}")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"bw={threads}: chains per block, a multiple of "
                         f"32 in [32, 1024]")
    B, S, W = a.shape
    if B > 65535 or -(-W // threads) > 2 ** 31 - 1 or S * W >= 2 ** 62:
        raise ValueError(f"shape {tuple(a.shape)} exceeds the launch grid")


def rglru_cuda(a: torch.Tensor, b: torch.Tensor, *, bs: int | None = None,
               bw: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  a, b (B, S, W) f32, CUDA
    and contiguous.  bs: time steps loaded ahead of the chain (one of
    STEPS); bw: chains per block (bw times the kernel's registers must fit
    the SM's 65,536: bs 32 takes ~156 a thread, so at most 384 chains;
    the card refuses a larger launch and this raises).  Returns a new
    (B, S, W) f32 tensor; an empty shape returns without a launch."""
    steps = DEFAULT_STEPS if bs is None else int(bs)
    threads = DEFAULT_THREADS if bw is None else int(bw)
    _check_inputs(a, b, steps, threads)
    B, S, W = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S,
                           W, steps, threads, stream)
    _build.check(lib, rc, "rglru launch")
    rglru_cuda.launches += 1
    return out


rglru_cuda.launches = 0
