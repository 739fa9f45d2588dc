"""CUDA causal / sliding-window GQA flash attention, forward only
(csrc/flash_attention.cu).

    out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h // g]) @ v
    over j <= i (and j > i - window when window > 0), g = H / Hkv

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py`
(`flash_attention_pallas`), which asserts S % bq == 0; this one takes any
S.  Bound by operations (4 * hd flops per (query, key) pair of the band:
206 GFLOP at the hybrid model's prefill).  One block of 256 threads per
(b, h, q-tile), a loop over only the k-tiles inside the causal and window
band, K and V tiles staged in shared memory in their own dtype, f32 FMAs,
online softmax with masked logits -1e30 and acc / max(l, 1e-30), output
in q's dtype.  The plain version is `kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (32, 64, 128, 256)
DEFAULT_BQ = 64
DEFAULT_BK = 64
MAX_SMEM = 232_448              # bytes of shared memory a block may use
_NAMES = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        for name in _NAMES.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def smem_bytes(dtype: torch.dtype, hd: int, bq: int, bk: int) -> int:
    """Dynamic shared memory of one block: the f32 Q tile, the K and V
    tiles in their own dtype (rows padded against bank conflicts) and the
    f32 P tile — the layout of csrc/flash_attention.cu."""
    size = 4 if dtype == torch.float32 else 2
    kpad = 2 if size == 4 else 4
    return (bq * (hd + 2) * 4 + bk * (2 * hd + kpad) * size
            + bq * (bk + 1) * 4)


def _check_inputs(q, k, v, window, bq, bk):
    ts = (q, k, v)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_cuda needs CUDA tensors (q "
                         f"{q.device}, k {k.device}, v {v.device})")
    if len({t.device for t in ts}) != 1:
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in _NAMES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32 / "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, S, H, hd), (B, S, "
                         f"Hkv, hd) twice, H a multiple of Hkv")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("flash_attention_cuda needs contiguous, 16-byte "
                         "aligned q, k and v")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"hd={q.shape[3]}: the kernel is built for head "
                         f"dims {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window={window}: 0 (causal) or a positive size")
    for name, val in (("bq", bq), ("bk", bk)):
        if val % 16 or not 16 <= val <= 64:
            raise ValueError(f"{name}={val}: a multiple of 16 in [16, 64]")
    B, S, H, _ = q.shape
    if B > 65535 or H > 65535 or S >= 2 ** 31 - 64:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    if smem_bytes(q.dtype, q.shape[3], bq, bk) > MAX_SMEM:
        raise ValueError(f"bq={bq}, bk={bk} at hd={q.shape[3]} {q.dtype} "
                         f"need more than {MAX_SMEM} bytes of shared memory")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int = 0, scale: float | None = None,
                         bq: int | None = None,
                         bk: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  q (B, S, H, hd), k and v
    (B, S, Hkv, hd), one dtype (f32 or bf16), CUDA and contiguous; hd in
    HEAD_DIMS.  window 0 is plain causal; scale defaults to 1/sqrt(hd).
    bq / bk: query rows / keys per tile (multiples of 16 up to 64).
    Returns a new (B, S, H, hd) tensor in q's dtype."""
    bq = DEFAULT_BQ if bq is None else int(bq)
    bk = DEFAULT_BK if bk is None else int(bk)
    window = int(window)
    _check_inputs(q, k, v, window, bq, bk)
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    fn = getattr(lib, _NAMES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, k.shape[2], hd, window, scale, bq, bk, stream)
    _build.check(lib, rc, "flash_attention launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
