"""CUDA compressed gossip mix of sparse payloads (csrc/topk_gather.cu).

    out[i, c] = sum_{j < k} w[i, j] * sum_p values[idx[i, j], p]
                                        * [cols[idx[i, j], p] == c]

Replaces the Pallas TPU kernel `repro/kernels/topk_gather.py`
(`topk_gather_pallas`).  Memory-bound on an H100: at the codec path's
(m=100, k=11, K=833, d=13,328) shape the output written once dominates
(5.3 of 5.84 MB).  One block per (row, chunk of `block_d` columns) keeps
the chunk's f32 accumulator in shared memory; for each neighbor in j order
the threads scatter its K (column, value) pairs into it with rounded
products, so for f32 values and distinct columns per payload row the
kernel equals the plain version `kernels.ref.topk_gather_ref` bit for bit.
Columns are read as uint16 or int32, as they lie on the wire.

Every block reads all k*K pairs of its row and keeps those in its chunk,
so fewer chunks read less from L2 but give fewer blocks.  The default
splits a row into the fewest chunks that still give about BLOCKS_PER_SM
blocks per SM (4 chunks at m=100 on an H100, whole rows at m=1024; PERF.md
has the measured sweep).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_SMEM = 232448               # bytes of shared memory a block may use
THREADS = 256
BLOCKS_PER_SM = 3               # blocks the default chunking aims for
_ENTRIES = {(torch.float32, torch.uint16): "topk_gather_f32_u16",
            (torch.float32, torch.int32): "topk_gather_f32_i32",
            (torch.bfloat16, torch.uint16): "topk_gather_bf16_u16",
            (torch.bfloat16, torch.int32): "topk_gather_bf16_i32"}


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_gather")
    if not getattr(lib, "_repro_typed", False):
        for name in _ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_inputs(idx, w, values, cols, d):
    ts = (idx, w, values, cols)
    if not all(t.is_cuda for t in ts):
        raise ValueError("topk_gather_cuda needs CUDA tensors (" + ", ".join(
            f"{n} {t.device}" for n, t in zip(("idx", "w", "values", "cols"),
                                              ts)) + ")")
    if len({t.device for t in ts}) > 1:
        raise ValueError("idx, w, values and cols must lie on one device")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and w float32; got {idx.dtype}, "
                        f"{w.dtype}")
    if (values.dtype, cols.dtype) not in _ENTRIES:
        raise TypeError(f"values must be float32 or bfloat16 and cols uint16 "
                        f"or int32; got {values.dtype}, {cols.dtype}")
    if idx.dim() != 2 or w.shape != idx.shape or values.dim() != 2 \
            or cols.shape != values.shape or values.shape[0] != idx.shape[0]:
        raise ValueError(f"shapes idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)}, values {tuple(values.shape)}, "
                         f"cols {tuple(cols.shape)}: want (m, k), (m, k), "
                         f"(m, K), (m, K)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("topk_gather_cuda needs contiguous idx, w, values "
                         "and cols")
    if d < 0:
        raise ValueError(f"d={d} must be >= 0")


def _check_block_d(k, d, block_d):
    smem = 4 * block_d + 8 * k
    if block_d < 1 or smem > MAX_SMEM:
        raise ValueError(f"block_d={block_d} with k={k}: the f32 "
                         f"accumulator (4 B a column) and the neighbor row "
                         f"(8 B a neighbor) need {smem} B of shared memory, "
                         f"at most {MAX_SMEM}")
    if -(-d // block_d) > 65535:
        raise ValueError(f"d={d} needs more than 65535 chunks of "
                         f"block_d={block_d}")


def default_block_d(m: int, k: int, d: int, device) -> int:
    """Columns per block: ceil(d / chunks) with chunks = ceil(BLOCKS_PER_SM
    * SMs / m), at least one column per thread, capped by what fits in
    shared memory."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, -(-BLOCKS_PER_SM * sms // max(m, 1)))
    return max(1, min(max(-(-d // chunks), THREADS),
                      (MAX_SMEM - 8 * k) // 4))


def topk_gather_cuda(idx: torch.Tensor, w: torch.Tensor,
                     values: torch.Tensor, cols: torch.Tensor, d: int, *,
                     block_d: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  idx (m, k) int32 neighbor
    ids in [0, m), w (m, k) f32 weights, values (m, K) f32 or bf16, cols
    (m, K) uint16 or int32 column ids (columns outside [0, d) are dropped,
    duplicates add) — all CUDA and contiguous.  Returns a new (m, d) tensor
    in values' dtype.  m = 0 or d = 0 returns without a launch.  block_d:
    columns per block (default `default_block_d`)."""
    d = int(d)
    _check_inputs(idx, w, values, cols, d)
    m, k = idx.shape
    block_d = default_block_d(m, k, d, values.device) if block_d is None \
        else int(block_d)
    _check_block_d(k, d, block_d)
    K = values.shape[1]
    out = torch.empty((m, d), dtype=values.dtype, device=values.device)
    if m == 0 or d == 0:
        return out
    lib = _lib()
    fn = getattr(lib, _ENTRIES[(values.dtype, cols.dtype)])
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(idx.data_ptr(), w.data_ptr(), values.data_ptr(),
                cols.data_ptr(), out.data_ptr(), m, k, K, d, block_d,
                THREADS, stream)
    _build.check(lib, rc, "topk_gather launch")
    topk_gather_cuda.launches += 1
    return out


topk_gather_cuda.launches = 0
