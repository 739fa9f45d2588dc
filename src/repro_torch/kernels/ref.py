"""Plain PyTorch versions of the port's kernels (the allclose targets).

Counterpart of `repro/kernels/ref.py` for the ops this slice ports.  The
wrappers in `ops` take these for tensors that lie on the CPU, the tests
compare them with the JAX reference, and `chip_smoke.py` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import torch


def gossip_gather_ref(idx: torch.Tensor, w: torch.Tensor,
                      U: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j w[i,j] * U[idx[i,j]] — f32 accumulate, output in U's
    dtype.  The neighbor sum runs in j order, each product rounded before
    it is added, which is the arithmetic of the CUDA kernel
    (csrc/gossip_gather.cu): for f32 U the two agree bit for bit, and both
    equal `core.gossip.mix_rows`."""
    m, k = idx.shape
    wf = w.to(torch.float32)
    out = torch.zeros((m,) + tuple(U.shape[1:]), dtype=torch.float32,
                      device=U.device)
    for j in range(k):
        term = wf[:, j, None] * U[idx[:, j].long()].to(torch.float32)
        out = term if j == 0 else out + term
    return out.to(U.dtype)


def head_gather_matmul_ref(uid: torch.Tensor, H: torch.Tensor,
                           W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[r] = H[r] @ W[uid[r]] + b[uid[r]] — the personalized-head serve
    oracle; any float H and W, f32 accumulate, f32 out."""
    u = uid.long()
    Wg = W[u].to(torch.float32)                              # (B, d, n)
    bg = b[u].to(torch.float32)                              # (B, n)
    return torch.einsum("bd,bdn->bn", H.to(torch.float32), Wg) + bg
