"""CUDA causal / sliding-window GQA flash attention, forward only
(csrc/flash_attention.cu).

    out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h // g]) @ v
    over j <= i (and j > i - window when window > 0), g = H / Hkv

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py`
(`flash_attention_pallas`), which asserts S % bq == 0; this one takes any
S.  Bound by operations (4 * hd flops per (query, key) pair of the band:
206 GFLOP at the hybrid model's prefill).  Masked logits -1e30, online
softmax, acc / max(l, 1e-30), output in q's dtype.  Two routes:

- bf16: a warp-specialized Hopper kernel.  The g query heads of a KV head
  are folded into the rows of a 128-row tile (`fold`), so one K/V tile
  feeds the whole group; TMA loads K and V in tiles of 64 keys into a
  2-stage ring; Q K^T and P V run on wgmma, P V as P_hi V + P_lo V with
  P = P_hi + P_lo split into two bf16 parts (P is f32 by definition).
  Its one tile is TC_TILES[0] = (bq 128 folded rows, bk 64 keys).  Its
  tiles are `tc_width(hd)` columns wide: hd 80 is padded to 128 (two
  64-column boxes, zero-filled past 80 by TMA, clipped on store).
- f32: one block of 256 threads per (b, h, q-tile), K and V tiles staged
  in shared memory, f32 FMAs; bq / bk are multiples of 16 up to 64.

The plain version is `kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (32, 64, 80, 128, 256)
DEFAULT_BQ = 64                 # f32 route
DEFAULT_BK = 64
TC_TILES = ((128, 64),)         # bf16 route: its (folded rows, keys)
TC_STAGES = 2                   # K/V ring stages of the bf16 route
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


def tc_width(hd: int) -> int:
    """Columns of the bf16 route's Q, K and V tiles at head dim hd: whole
    TMA boxes of 64 bf16 (32 at hd 32), so hd 80 takes 128."""
    eb = 64 if hd >= 64 else 32
    return -(-hd // eb) * eb


def fold(H: int, Hkv: int, rows: int = TC_TILES[0][0]):
    """How the bf16 route folds the g = H / Hkv query heads of a KV head
    into a tile of `rows` rows: (hb heads per tile, chunks of the group,
    P positions per tile).  Row r of a tile is position q0 + r // hb, head
    chunk * hb + r % hb of the group; rows past hb * P are idle."""
    g = H // Hkv
    hb = min(g, rows)
    return hb, -(-g // hb), rows // hb


def k_tile_range(q0: int, P: int, S: int, window: int,
                 bk: int = TC_TILES[0][1]):
    """(first k-tile, number of k-tiles) that a tile of positions q0 ..
    q0 + P - 1 visits: the union of its rows' causal / window bands."""
    q_last = min(q0 + P, S) - 1
    k_first = max(0, q0 - window + 1) if window > 0 else 0
    return k_first // bk, q_last // bk - k_first // bk + 1


def tc_visits(B: int, S: int, H: int, Hkv: int, window: int) -> int:
    """(CTA, k-tile) pairs of a bf16 launch: each loads one K and one V
    tile of bk keys."""
    hb, chunks, P = fold(H, Hkv)
    n_kt = sum(k_tile_range(qt * P, P, S, window)[1]
               for qt in range(-(-S // P)))
    return n_kt * B * Hkv * chunks


def tc_tile_flops(B: int, S: int, H: int, Hkv: int, hd: int,
                  window: int) -> int:
    """Tensor-core flops the bf16 route issues: every (tile, k-tile) pair
    it visits, masked keys and idle rows included, Q K^T once over hd and
    P V twice (P_hi and P_lo) over the tile's `tc_width(hd)` columns."""
    (rows, bk), = TC_TILES
    return 2 * rows * bk * (hd + 2 * tc_width(hd)) * tc_visits(
        B, S, H, Hkv, window)


def smem_bytes(dtype: torch.dtype, hd: int, bq: int, bk: int) -> int:
    """Dynamic shared memory of one block, as csrc/flash_attention.cu lays
    it out.  bf16: 1 KB to align the tiles to the swizzle atom, the bq-row
    Q tile, TC_STAGES K and V tiles of bk keys (all `tc_width(hd)` wide),
    128 bytes of mbarriers.  f32: the f32 Q tile, the K and V tiles (rows
    padded against bank conflicts) and the f32 P tile."""
    if dtype == torch.bfloat16:
        w = tc_width(hd)
        return 1024 + bq * w * 2 + 2 * TC_STAGES * bk * w * 2 + 128
    return bq * (hd + 2) * 4 + bk * (2 * hd + 2) * 4 + bq * (bk + 1) * 4


def tiles(dtype: torch.dtype, bq: int | None, bk: int | None):
    """The (bq, bk) a launch uses: the route's default where None, else
    the caller's, which must be a tile the route has (ValueError)."""
    if dtype == torch.bfloat16:
        (dq, dk), = TC_TILES
        bq = dq if bq is None else int(bq)
        bk = dk if bk is None else int(bk)
        if (bq, bk) not in TC_TILES:
            raise ValueError(f"bq={bq}, bk={bk}: the bf16 kernel is built "
                             f"for (bq, bk) in {TC_TILES} only")
        return bq, bk
    bq = DEFAULT_BQ if bq is None else int(bq)
    bk = DEFAULT_BK if bk is None else int(bk)
    for name, val in (("bq", bq), ("bk", bk)):
        if val % 16 or not 16 <= val <= 64:
            raise ValueError(f"{name}={val}: a multiple of 16 in [16, 64]")
    return bq, bk


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
    B, S, H, _ = q.shape
    if B > 65535 or H > 65535 or S >= 2 ** 31 - 128:
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
    bq / bk: the tile (`tiles`: the bf16 route has TC_TILES only, the f32
    route multiples of 16 up to 64).  Returns a new (B, S, H, hd) tensor
    in q's dtype."""
    bq, bk = tiles(q.dtype, bq, bk)
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
