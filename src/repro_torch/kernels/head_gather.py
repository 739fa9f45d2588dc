"""CUDA fused per-user classifier gather + head matmul (csrc/head_gather.cu).

    out[r, :] = H[r, :] @ W[uid[r], :, :] + b[uid[r], :]     W: (m, d, n)

Replaces the Pallas TPU kernel `repro/kernels/head_gather.py`
(`head_gather_matmul_pallas`).  At the serve path's shape (m=100, d=64,
n=10) it moves well under a megabyte even at B=1024, so on an H100 it is
bound by its launch, not by bytes or operations.  One block per request
(times a tile of classes when n exceeds it) stages H[r] in shared memory
as f32; each thread owns one class and sums over the feature axis in f32,
then adds the bias — no (B, d, n) gathered copy of W is materialized.  The
output is always f32.  The plain version is
`kernels.ref.head_gather_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_BLOCK_N = 1024
MAX_D = 12288                   # H[r] staged as f32 in 48 KB of smem
_NAMES = {(torch.float32, torch.float32): "head_gather_f32_f32",
          (torch.bfloat16, torch.float32): "head_gather_bf16_f32",
          (torch.float32, torch.bfloat16): "head_gather_f32_bf16",
          (torch.bfloat16, torch.bfloat16): "head_gather_bf16_bf16"}


def _lib() -> ctypes.CDLL:
    lib = _build.load("head_gather")
    if not getattr(lib, "_repro_typed", False):
        for name in _NAMES.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def default_block_n(n: int) -> int:
    """Class tile: n rounded up to a warp, at most 128 threads."""
    return min(128, max(32, -(-n // 32) * 32))


def _check_inputs(uid, H, W, b, block_n):
    ts = (uid, H, W, b)
    if not all(t.is_cuda for t in ts):
        raise ValueError("head_gather_matmul_cuda needs CUDA tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("uid, H, W and b must lie on one device")
    if uid.dtype != torch.int32:
        raise TypeError(f"uid must be int32; got {uid.dtype}")
    if (H.dtype, W.dtype) not in _NAMES or b.dtype != W.dtype:
        raise TypeError(f"H, W must be float32/bfloat16 and b W's dtype; "
                        f"got H {H.dtype}, W {W.dtype}, b {b.dtype}")
    if uid.dim() != 1 or H.dim() != 2 or W.dim() != 3 or b.dim() != 2 \
            or H.shape[0] != uid.shape[0] or W.shape[1] != H.shape[1] \
            or tuple(b.shape) != (W.shape[0], W.shape[2]):
        raise ValueError(f"shapes uid {tuple(uid.shape)}, H "
                         f"{tuple(H.shape)}, W {tuple(W.shape)}, b "
                         f"{tuple(b.shape)}: want (B,), (B, d), (m, d, n), "
                         f"(m, n)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("head_gather_matmul_cuda needs contiguous inputs")
    if H.shape[1] > MAX_D:
        raise ValueError(f"d={H.shape[1]} > {MAX_D}: H[r] is staged in "
                         f"48 KB of shared memory")
    if block_n % 32 or not 32 <= block_n <= MAX_BLOCK_N:
        raise ValueError(f"block_n={block_n}: a multiple of 32 in "
                         f"[32, {MAX_BLOCK_N}]")
    if -(-W.shape[2] // block_n) > 65535:
        raise ValueError(f"n={W.shape[2]} needs more than 65535 class "
                         f"tiles of block_n={block_n}")


def head_gather_matmul_cuda(uid: torch.Tensor, H: torch.Tensor,
                            W: torch.Tensor, b: torch.Tensor, *,
                            block_n: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  uid (B,) int32 user ids in
    [0, m), H (B, d), W (m, d, n), b (m, n); H and W each f32 or bf16, b in
    W's dtype; all CUDA and contiguous.  Returns (B, n) f32."""
    B, d = H.shape
    m, _, n = W.shape
    block_n = default_block_n(n) if block_n is None else int(block_n)
    _check_inputs(uid, H, W, b, block_n)
    out = torch.empty((B, n), dtype=torch.float32, device=H.device)
    if B == 0 or n == 0:
        return out
    lib = _lib()
    fn = getattr(lib, _NAMES[(H.dtype, W.dtype)])
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = fn(uid.data_ptr(), H.data_ptr(), W.data_ptr(), b.data_ptr(),
                out.data_ptr(), B, m, d, n, block_n, stream)
    _build.check(lib, rc, "head_gather_matmul launch")
    head_gather_matmul_cuda.launches += 1
    return out


head_gather_matmul_cuda.launches = 0
