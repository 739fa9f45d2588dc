"""CUDA compressed gossip mix of sparse payloads (csrc/topk_gather.cu).

    out[i, c] = sum_{j < k} w[i, j] * sum_p values[idx[i, j], p]
                                        * [cols[idx[i, j], p] == c]

Replaces the Pallas TPU kernel `repro/kernels/topk_gather.py`
(`topk_gather_pallas`).  Memory-bound on an H100: at the codec path's
(m=100, k=11, K=833, d=13,328) shape the output written once dominates
(5.3 of 5.84 MB).  A block owns (row, chunk of `block_d` columns) and keeps
the chunk's f32 accumulator in shared memory; for each neighbor in j order
the threads scatter its K (column, value) pairs into it with rounded
products, so for f32 values and distinct columns per payload row the
kernel equals the plain version `kernels.ref.topk_gather_ref` bit for bit.
Columns are read as uint16 or int32, as they lie on the wire.

Two routes, chosen by shape alone in `plan` (never on a failure):
  - "staged", where its blocks run in one wave: the row's neighbor payload
    rows are bulk-copied to shared memory, all in flight before the first
    wait (or through a ring of `stages` rows where k of them do not fit);
    then, neighbor by neighbor, each pair claims its column with a native
    int atomicExch and adds its product in place, a duplicate column of
    the same payload row being deferred to a shared f32 atomicAdd after
    the neighbor's barrier.  Whole rows at the codec path's m = 100.
  - "chunked", beyond one wave or where a payload row does not fit: the
    pairs read from L2 in batches and added with shared f32 atomics,
    several small blocks an SM.  Whole rows at the bench grid's m = 1024.
Every block reads all k*K pairs of its row, so more chunks read more but
give more blocks; `plan` weighs the two.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

MAX_SMEM = 232448               # bytes of shared memory a block may use
SM_SMEM = 233472                # an H100 SM's shared memory (228 KB)
BLOCK_RESERVED = 1024           # shared memory the runtime keeps per block
# a block's fixed cost (launch, copies' latency, barriers) counted as this
# many bytes when `plan` weighs chunkings
BLOCK_COST_BYTES = 8192
THREADS = 256                   # chunked route
STAGED_THREADS = 512            # staged route
CHUNKED_BLOCKS_PER_SM = 3       # blocks the chunked route's default aims for
_ENTRIES = {(torch.float32, torch.uint16): "topk_gather_f32_u16",
            (torch.float32, torch.int32): "topk_gather_f32_i32",
            (torch.bfloat16, torch.uint16): "topk_gather_bf16_u16",
            (torch.bfloat16, torch.int32): "topk_gather_bf16_i32"}


class Plan(NamedTuple):
    route: str           # "staged" or "chunked"
    block_d: int         # columns per block
    chunks: int          # blocks per row
    stages: int          # staged: payload rows in flight (ring depth)
    slot_v: int          # staged: bytes of a stage's values window
    slot_c: int          # staged: bytes of a stage's columns window
    threads: int
    smem: int            # bytes of dynamic shared memory
    blocks: int          # m * chunks
    resident: int        # blocks an SM holds at once (shared memory)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def staged_smem(k: int, K: int, block_d: int, stages: int, slot_v: int,
                slot_c: int) -> int:
    """Shared bytes of a staged block, laid out as the kernel does: the
    stages' mbarriers, the f32 accumulator (block_d + 4 slots: room to
    shift it to the output's 16-byte alignment), the column claims (block_d
    int32), the deferred duplicates (K offsets, K products, a count), the
    payload ring, the neighbor row (k ids, k weights)."""
    return (_round16(8 * stages) + _round16(4 * (block_d + 4))
            + _round16(4 * block_d) + 2 * _round16(4 * K) + 16
            + stages * (slot_v + slot_c) + 8 * k)


def _stages(k, K, block_d, slot_v, slot_c) -> int:
    """The deepest ring (at most max(k, 1) rows) that fits MAX_SMEM."""
    s = max(k, 1)
    while s and staged_smem(k, K, block_d, s, slot_v, slot_c) > MAX_SMEM:
        s -= 1
    return s


def _resident(smem: int, threads: int) -> int:
    return min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // threads)


@functools.lru_cache(maxsize=256)   # once per shape: calls are hot
def plan(m: int, k: int, K: int, d: int, val_bytes: int, col_bytes: int,
         sms: int, block_d: int | None = None) -> Plan:
    """Route and tiling for idx (m, k), values / cols (m, K) of
    `val_bytes` / `col_bytes` elements and d output columns on a card of
    `sms` SMs.  The staged route is taken where its blocks run in one wave
    (at most `resident` per SM) and a payload row fits beside a chunk's
    accumulator and claims; its default chunking minimises ceil(blocks /
    sms) x (a block's fixed cost + its payload bytes + its chunk's
    accumulator and output bytes).  Beyond one wave each staged block's
    serial copy-add-store chain repeats on every SM, and the chunked
    route's small blocks, several resident per SM, overlap instead (at
    m = 1024, k = 16 a whole row's staged block holds an H100 SM alone;
    PERF.md section 6).
    Raises ValueError, naming the valid values, for a block_d no route can
    take."""
    if m < 1 or d < 1 or sms < 1 or k < 0 or K < 0:
        raise ValueError(f"plan needs m, d, sms >= 1 and k, K >= 0; got "
                         f"{m}, {d}, {sms}, {k}, {K}")
    slot_v, slot_c = _round16(K * val_bytes) + 16, _round16(K * col_bytes) + 16
    payload = k * K * (val_bytes + col_bytes)
    if block_d is None:
        best = None
        for c in range(1, max(1, min(-(-d // 256), 4 * sms)) + 1):
            bd = min(-(-(-(-d // c)) // 8) * 8, d)   # a multiple of 8
            if _stages(k, K, bd, slot_v, slot_c) < 1:
                continue
            chunks = -(-d // bd)
            cost = -(-m * chunks // sms) * (
                BLOCK_COST_BYTES + payload + bd * (4 + val_bytes))
            if best is None or cost < best[0]:
                best = (cost, bd)
        if best is None:
            return _chunked(m, k, d, sms, None)
        bd = best[1]
    else:
        bd = int(block_d)
        if bd < 1:
            raise ValueError(f"block_d={bd}: columns per block, >= 1")
        if _stages(k, K, bd, slot_v, slot_c) < 1:
            return _chunked(m, k, d, sms, bd)
    chunks = -(-d // bd)
    if chunks > 65535:
        raise ValueError(f"d={d} needs more than 65535 chunks of "
                         f"block_d={bd}")
    stages = _stages(k, K, bd, slot_v, slot_c)
    smem = staged_smem(k, K, bd, stages, slot_v, slot_c)
    resident = _resident(smem, STAGED_THREADS)
    if m * chunks > sms * resident:                 # more than one wave
        return _chunked(m, k, d, sms, block_d)
    return Plan("staged", bd, chunks, stages, slot_v, slot_c, STAGED_THREADS,
                smem, m * chunks, resident)


def _chunked(m, k, d, sms, block_d) -> Plan:
    """The chunked route: ceil(d / chunks) columns with chunks =
    ceil(CHUNKED_BLOCKS_PER_SM * sms / m), at least one column per thread
    (or all d), at most what fits in shared memory, unless block_d is
    set."""
    if block_d is None:
        chunks = max(1, -(-CHUNKED_BLOCKS_PER_SM * sms // m))
        block_d = max(1, min(max(-(-d // chunks), THREADS), d,
                             (MAX_SMEM - 8 * k) // 4))
    smem = 4 * block_d + 8 * k
    if block_d < 1 or smem > MAX_SMEM:
        raise ValueError(f"block_d={block_d} with k={k}: the f32 "
                         f"accumulator (4 B a column) and the neighbor row "
                         f"(8 B a neighbor) need {smem} B of shared memory, "
                         f"at most {MAX_SMEM}")
    chunks = -(-d // block_d)
    if chunks > 65535:
        raise ValueError(f"d={d} needs more than 65535 chunks of "
                         f"block_d={block_d}")
    return Plan("chunked", block_d, chunks, 0, 0, 0, THREADS, smem,
                m * chunks, _resident(smem, THREADS))


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_gather")
    if not getattr(lib, "_repro_typed", False):
        head = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_longlong,
                                        ctypes.c_int]
        for name in _ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"{name}_staged")
            fn.argtypes = head + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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


def topk_gather_cuda(idx: torch.Tensor, w: torch.Tensor,
                     values: torch.Tensor, cols: torch.Tensor, d: int, *,
                     block_d: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  idx (m, k) int32 neighbor
    ids in [0, m), w (m, k) f32 weights, values (m, K) f32 or bf16, cols
    (m, K) uint16 or int32 column ids (columns outside [0, d) are dropped,
    duplicates add) — all CUDA and contiguous.  Returns a new (m, d) tensor
    in values' dtype.  m = 0 or d = 0 returns without a launch.  block_d:
    columns per block on the route `plan` takes."""
    d = int(d)
    _check_inputs(idx, w, values, cols, d)
    m, k = idx.shape
    K = values.shape[1]
    out = torch.empty((m, d), dtype=values.dtype, device=values.device)
    if m == 0 or d == 0:
        return out
    p = plan(m, k, K, d, values.element_size(), cols.element_size(),
             _build.sm_count(values.device), block_d)
    lib = _lib()
    name = _ENTRIES[(values.dtype, cols.dtype)]
    args = (idx.data_ptr(), w.data_ptr(), values.data_ptr(), cols.data_ptr(),
            out.data_ptr(), m, k, K, d, p.block_d)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        if p.route == "staged":
            rc = getattr(lib, f"{name}_staged")(
                *args, p.stages, p.slot_v, p.slot_c, p.threads, p.smem,
                stream)
        else:
            rc = getattr(lib, name)(*args, p.threads, stream)
    _build.check(lib, rc, f"topk_gather launch ({p.route} route)")
    topk_gather_cuda.launches += 1
    return out


topk_gather_cuda.launches = 0
