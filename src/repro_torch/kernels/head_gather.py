"""CUDA fused per-user classifier gather + head matmul (csrc/head_gather.cu).

    out[r, :] = H[r, :] @ W[uid[r], :, :] + b[uid[r], :]     W: (m, d, n)

Replaces the Pallas TPU kernel `repro/kernels/head_gather.py`
(`head_gather_matmul_pallas`).  At the serve path's shape (m=100, d=64,
n=10) even B=1024 moves about 567 KB, so on an H100 neither bytes nor
operations set the pace: dependent trips to L2 and the launch do.  No
(B, d, n) gathered copy of W is materialized; f32 accumulate, f32 output.
The plain version is `kernels.ref.head_gather_matmul_ref`.

Two routes, chosen by shape alone in `plan` (never on a failure):
  - "warp": one warp per request, `warps` requests per block; the warp
    copies its user's whole (d, n) slab, H[r] and the bias row to shared
    memory in one burst of 16-byte cp.async, then its 32 lanes split the
    (t, c) products and add the groups' sums by shuffles.  Taken when
    n <= 32, the three copies fit WARP_SMEM_MAX bytes and there are more
    than WARP_MIN_PER_SM requests per SM (the serve path's B 1024).
  - "tiled": one block of TILED_THREADS per (request, tile of `block_n`
    classes) stages H[r] as f32 (d <= MAX_D) and splits the tile's (t, c)
    work over its threads.  Taken for every other shape (the serve path's
    B 1 and 64), and whenever the caller sets `block_n`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

MAX_D = 12288                   # tiled route: H[r] staged as f32 in 48 KB
MAX_WARPS = 8                   # warp route: requests per block
WARP_SMEM_MAX = 6144            # warp route: a warp's slab, H row and bias
# the warp route needs more than this many requests per SM: below, a
# 256-thread block per request is faster (chip_smoke.py on an H100 at m 100,
# d 64, n 10: 2.07 and 2.17 us against 2.30 and 2.29 at B 1 and 64, but
# 3.23 against 2.67 at B 1024; PERF.md section 6)
WARP_MIN_PER_SM = 2
TILED_THREADS = 256
MAX_BLOCK_N = TILED_THREADS     # tiled route: classes per block
_NAMES = {(torch.float32, torch.float32): "head_gather_f32_f32",
          (torch.bfloat16, torch.float32): "head_gather_bf16_f32",
          (torch.float32, torch.bfloat16): "head_gather_f32_bf16",
          (torch.bfloat16, torch.bfloat16): "head_gather_bf16_bf16"}


class Plan(NamedTuple):
    route: str           # "warp" or "tiled"
    warps: int           # warps per block
    blocks: int          # warp: ceil(B / warps); tiled: B (times tiles)
    tiles: int           # class tiles (warp: 1)
    block_n: int         # classes a block covers (warp: n)
    groups: int          # lanes / threads that split the features t
    smem: int            # bytes of dynamic shared memory per block
    slots: tuple         # warp: bytes of the W, H and bias windows


def _window(nbytes: int) -> int:
    """Shared bytes for the 16-byte-aligned window of `nbytes` bytes at any
    element-aligned address (one spare chunk for the misalignment)."""
    return -(-nbytes // 16) * 16 + 16


@functools.lru_cache(maxsize=256)   # once per shape: calls are hot
def plan(B: int, d: int, n: int, elem_bytes: int, sms: int,
         block_n: int | None = None) -> Plan:
    """Route and launch shape for H (B, d), W (m, d, n) with W's element
    size `elem_bytes` (H is budgeted as f32) on a card of `sms` SMs.
    block_n, when set, takes the tiled route with that class tile.
    Raises ValueError, naming the valid values, for a knob or shape the
    kernel cannot take."""
    if B < 1 or n < 1 or d < 0 or sms < 1:
        raise ValueError(f"plan needs B, n, sms >= 1 and d >= 0; got {B}, "
                         f"{n}, {sms}, {d}")
    slots = (_window(d * n * elem_bytes), _window(4 * d),
             _window(n * elem_bytes))
    if block_n is None and n <= 32 and sum(slots) <= WARP_SMEM_MAX \
            and B > WARP_MIN_PER_SM * sms:
        warps = min(MAX_WARPS, -(-B // sms))
        return Plan("warp", warps, -(-B // warps), 1, n, 32 // n,
                    warps * sum(slots), slots)
    if d > MAX_D:
        raise ValueError(f"d={d} > {MAX_D}: the tiled route stages H[r] as "
                         f"f32 in 48 KB of shared memory")
    if block_n is None:
        block_n = -(-n // -(-n // MAX_BLOCK_N))
    block_n = int(block_n)
    if not 1 <= block_n <= MAX_BLOCK_N:
        raise ValueError(f"block_n={block_n}: classes per block of the tiled "
                         f"route, in [1, {MAX_BLOCK_N}]")
    tiles = -(-n // block_n)
    if tiles > 65535:
        raise ValueError(f"n={n} needs more than 65535 class tiles of "
                         f"block_n={block_n}")
    return Plan("tiled", TILED_THREADS // 32, B, tiles, block_n,
                TILED_THREADS // block_n, 4 * max(d, TILED_THREADS), ())


def _lib() -> ctypes.CDLL:
    lib = _build.load("head_gather")
    if not getattr(lib, "_repro_typed", False):
        for name in _NAMES.values():
            warp = getattr(lib, f"{name}_warp")
            warp.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            warp.restype = ctypes.c_int
            tiled = getattr(lib, f"{name}_tiled")
            tiled.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            tiled.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_inputs(uid, H, W, b):
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


def head_gather_matmul_cuda(uid: torch.Tensor, H: torch.Tensor,
                            W: torch.Tensor, b: torch.Tensor, *,
                            block_n: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream.  uid (B,) int32 user ids in
    [0, m), H (B, d), W (m, d, n), b (m, n); H and W each f32 or bf16, b in
    W's dtype; all CUDA and contiguous.  Returns (B, n) f32.  block_n:
    classes per block of the tiled route (setting it takes that route)."""
    _check_inputs(uid, H, W, b)
    B, d = H.shape
    m, _, n = W.shape
    out = torch.empty((B, n), dtype=torch.float32, device=H.device)
    if B == 0 or n == 0:
        return out
    p = plan(B, d, n, W.element_size(), _build.sm_count(H.device), block_n)
    lib = _lib()
    name = _NAMES[(H.dtype, W.dtype)]
    args = (uid.data_ptr(), H.data_ptr(), W.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, m, d, n)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        if p.route == "warp":
            rc = getattr(lib, f"{name}_warp")(
                *args, p.warps, sum(p.slots), p.slots[0], p.slots[1],
                stream)
        else:
            rc = getattr(lib, f"{name}_tiled")(*args, p.block_n,
                                               TILED_THREADS, stream)
    _build.check(lib, rc, f"head_gather_matmul launch ({p.route} route)")
    head_gather_matmul_cuda.launches += 1
    return out


head_gather_matmul_cuda.launches = 0
