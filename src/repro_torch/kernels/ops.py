"""Dispatching wrappers for the port's CUDA kernels.

Counterpart of `repro/kernels/ops.py`.  Each op picks its path from
`force`:
  - "auto": the CUDA kernel for CUDA tensors, the plain torch version
    (`kernels.ref`) for CPU tensors;
  - "cuda": the kernel; a CPU tensor raises (there is no interpret mode);
  - "ref":  the plain version on any device (tests and chip_smoke.py).
A CUDA tensor on the "auto" path launches the kernel or raises — nothing
falls back.

Loud-knob rule: every knob that only tunes a kernel (block sizes) raises
when the call dispatches to the plain version instead of being ignored.

`flash_attention` and `rglru` are forward-only kernels (the TPU kernels
have no backward either): their kernel path raises when an input
requires grad under autograd instead of detaching it.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_cuda
from .gossip_gather import gossip_gather_cuda
from .gossip_scatter import (check_pairs, gossip_scatter_cuda,
                             gossip_scatter_many_cuda)
from .head_gather import head_gather_matmul_cuda
from .pushsum_mix import pushsum_mix_cuda
from .rglru import rglru_cuda
from .topk_gather import topk_gather_cuda

FORCES = ("auto", "cuda", "ref")
KERNELS = {"flash_attention": flash_attention_cuda,
           "gossip_gather": gossip_gather_cuda,
           "gossip_scatter": gossip_scatter_cuda,
           "head_gather_matmul": head_gather_matmul_cuda,
           "pushsum_mix": pushsum_mix_cuda,
           "rglru": rglru_cuda,
           "topk_gather": topk_gather_cuda}


def _use_kernel(force: str, t) -> bool:
    if force not in FORCES:
        raise ValueError(f"force={force!r}; known: {FORCES}")
    if force == "ref":
        return False
    if t.is_cuda:
        return True
    if force == "cuda":
        raise ValueError(f"force='cuda' launches the CUDA kernel, but the "
                         f"input lies on {t.device}; move it to a GPU or "
                         f"use force='auto'/'ref'")
    return False


def _reject_ref_knobs(**knobs):
    """Raise if any kernel-only knob is set on a plain-version dispatch."""
    stray = [k for k, v in knobs.items() if v is not None]
    if stray:
        raise ValueError(
            f"{', '.join(stray)} tune(s) the CUDA kernel; this call "
            f"dispatched to the plain torch version (pass CUDA tensors with "
            f"force='auto' or 'cuda' to run the kernel)")


def _reject_grad(name: str, *ts) -> None:
    """Raise if autograd would track a forward-only kernel's inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; an input requires "
            f"grad (run under torch.no_grad() or detach the inputs)")


def flash_attention(q, k, v, *, window: int = 0, scale=None,
                    force: str = "auto", bq: int | None = None,
                    bk: int | None = None):
    """Causal (optionally sliding-window) GQA attention, f32 online
    softmax, output in q's dtype: q (B, S, H, hd), k and v (B, S, Hkv,
    hd).  bq / bk tune the kernel's query / key tile (kernel only)."""
    if _use_kernel(force, q):
        _reject_grad("flash_attention", q, k, v)
        return flash_attention_cuda(q, k, v, window=window, scale=scale,
                                    bq=bq, bk=bk)
    _reject_ref_knobs(bq=bq, bk=bk)
    return ref.flash_attention_ref(q, k, v, window=window, scale=scale)


def rglru(a, b, force: str = "auto", bs: int | None = None,
          bw: int | None = None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over
    (B, S, W), f32 out.  bs / bw tune the kernel's time steps loaded ahead
    and chains per block (kernel only)."""
    if _use_kernel(force, a):
        _reject_grad("rglru", a, b)
        return rglru_cuda(a, b, bs=bs, bw=bw)
    _reject_ref_knobs(bs=bs, bw=bw)
    return ref.rglru_ref(a, b)


def pushsum_mix(P, U, force: str = "auto"):
    """U' = P @ U over the stacked client axis — the dense push-sum mix;
    f32 accumulate, output in U's dtype."""
    if _use_kernel(force, U):
        return pushsum_mix_cuda(P, U)
    return ref.pushsum_mix_ref(P, U)


def gossip_gather(idx, w, U, force: str = "auto", block_d: int | None = None):
    """out[i] = sum_j w[i,j] * U[idx[i,j]] — the sparse gossip transmission
    over the flat client buffer; f32 accumulate, output in U's dtype.
    block_d tunes the kernel's columns per block (kernel only)."""
    if _use_kernel(force, U):
        return gossip_gather_cuda(idx, w, U, block_d=block_d)
    _reject_ref_knobs(block_d=block_d)
    return ref.gossip_gather_ref(idx, w, U)


def topk_gather(idx, w, values, cols, d: int, force: str = "auto",
                block_d: int | None = None):
    """out[i] = sum_j w[i,j] * decode(payload[idx[i,j]]) for sparse
    (column, value) payloads — the compressed gossip mix, without a dense
    decode on the kernel path; f32 accumulate, output in values' dtype.
    block_d tunes the kernel's columns per block (kernel only)."""
    if _use_kernel(force, values):
        return topk_gather_cuda(idx, w, values, cols, d, block_d=block_d)
    _reject_ref_knobs(block_d=block_d)
    return ref.topk_gather_ref(idx, w, values, cols, d)


def gossip_scatter(rows, X, U, accumulate: bool = False, force: str = "auto",
                   block_d: int | None = None):
    """U[rows] = X (or += X summed in f32) — the write-back of the compact
    partial-participation working set into the resident buffer, IN PLACE
    on both paths: U is written and returned, its dormant rows untouched.
    block_d tunes the kernel's columns per block (kernel only)."""
    if _use_kernel(force, U):
        return gossip_scatter_cuda(rows, X, U, accumulate, block_d=block_d)
    _reject_ref_knobs(block_d=block_d)
    return ref.gossip_scatter_ref(rows, X, U, accumulate)


def gossip_scatter_many(rows, Xs, Us, accumulate: bool = False,
                        force: str = "auto", block_d: int | None = None):
    """`gossip_scatter` for up to 4 pairs (X, U) that share one row table:
    every U written in place, in ONE kernel launch on the kernel path.
    The Xs must share one dtype, the Us one dtype, and every pair one
    shape, X (n, d) with n = len(rows) and U (m, d); anything else raises
    on both paths.  Returns the Us.  block_d tunes the kernel's columns
    per block (kernel only)."""
    Xs, Us = tuple(Xs), tuple(Us)
    if Us and _use_kernel(force, Us[0]):
        return gossip_scatter_many_cuda(rows, Xs, Us, accumulate,
                                        block_d=block_d)
    check_pairs(rows, Xs, Us)
    _reject_ref_knobs(block_d=block_d)
    return ref.gossip_scatter_many_ref(rows, Xs, Us, accumulate)


def head_gather_matmul(uid, H, W, b, force: str = "auto",
                       block_n: int | None = None):
    """out[r] = H[r] @ W[uid[r]] + b[uid[r]] — the fused per-user head of
    the serve path; always f32.  block_n sets the kernel's class tile and
    takes its tiled route (kernel only)."""
    if _use_kernel(force, H):
        return head_gather_matmul_cuda(uid, H, W, b, block_n=block_n)
    _reject_ref_knobs(block_n=block_n)
    return ref.head_gather_matmul_ref(uid, H, W, b)


def launch_counts() -> dict:
    """{kernel name: launches so far} — each wrapper counts only the calls
    that launched its kernel."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
