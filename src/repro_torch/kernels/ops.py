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
"""
from __future__ import annotations

from . import ref
from .gossip_gather import gossip_gather_cuda
from .gossip_scatter import gossip_scatter_cuda
from .head_gather import head_gather_matmul_cuda
from .pushsum_mix import pushsum_mix_cuda

FORCES = ("auto", "cuda", "ref")
KERNELS = {"gossip_gather": gossip_gather_cuda,
           "gossip_scatter": gossip_scatter_cuda,
           "head_gather_matmul": head_gather_matmul_cuda,
           "pushsum_mix": pushsum_mix_cuda}


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


def head_gather_matmul(uid, H, W, b, force: str = "auto",
                       block_n: int | None = None):
    """out[r] = H[r] @ W[uid[r]] + b[uid[r]] — the fused per-user head of
    the serve path; always f32.  block_n tunes the kernel's class tile
    (kernel only)."""
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
