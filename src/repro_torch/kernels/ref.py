"""Plain PyTorch versions of the port's kernels (the allclose targets).

Counterpart of `repro/kernels/ref.py` for the ops ported so far.  The
wrappers in `ops` take these for tensors that lie on the CPU, the tests
compare them with the JAX reference, and `chip_smoke.py` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import math

import torch


def pushsum_mix_ref(P: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """U' = P @ U — f32 product, output in U's dtype.  A CUDA caller wants
    torch.backends.cuda.matmul.allow_tf32 False for a full-f32 product."""
    return (P.to(torch.float32) @ U.to(torch.float32)).to(U.dtype)


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


def topk_gather_ref(idx: torch.Tensor, w: torch.Tensor,
                    values: torch.Tensor, cols: torch.Tensor,
                    d: int) -> torch.Tensor:
    """out[i, c] = sum_j w[i,j] * sum_p values[idx[i,j], p] *
    [cols[idx[i,j], p] == c] — the compressed gossip mix of sparse
    (column, value) payloads; f32 accumulate, output in values' dtype.
    Decodes densely into f32 (duplicate columns add, columns outside
    [0, d) are dropped), then runs `gossip_gather_ref`: the neighbor sum in
    j order with each product rounded, which is the CUDA kernel's
    arithmetic (csrc/topk_gather.cu) — bit for bit where a payload row's
    columns are distinct."""
    return gossip_gather_ref(idx, w, decode_sparse(values, cols, d)
                             ).to(values.dtype)


def decode_sparse(values: torch.Tensor, cols: torch.Tensor,
                  d: int) -> torch.Tensor:
    """Dense (m, d) f32 decode of (column, value) rows: duplicate columns
    add, columns outside [0, d) are dropped (the reference's
    mode="drop")."""
    m = values.shape[0]
    c = cols.long()
    # dropped entries land in a spare column d, sliced off after
    c = torch.where((c >= 0) & (c < d), c, d)
    out = torch.zeros((m, d + 1), dtype=torch.float32, device=values.device)
    out.scatter_add_(1, c, values.to(torch.float32))
    return out[:, :d]


def gossip_scatter_ref(rows: torch.Tensor, X: torch.Tensor, U: torch.Tensor,
                       accumulate: bool = False) -> torch.Tensor:
    """U[rows] = X — or U[rows] += X summed in f32 when accumulate — written
    INTO U, which is returned (the in-place write of the CUDA kernel, the
    torch form of the reference's aliased output).  X is cast to U's dtype
    first, as the reference does; rows must be unique."""
    r = rows.long()
    Xc = X.to(U.dtype)
    if accumulate:
        Xc = (U[r].to(torch.float32) + Xc.to(torch.float32)).to(U.dtype)
    return U.index_copy_(0, r, Xc)


def gossip_scatter_many_ref(rows: torch.Tensor, Xs, Us,
                            accumulate: bool = False) -> tuple:
    """`gossip_scatter_ref` for each pair (X, U) in turn, every U written
    in place; returns the Us."""
    return tuple(gossip_scatter_ref(rows, X, U, accumulate)
                 for X, U in zip(Xs, Us))


def head_gather_matmul_ref(uid: torch.Tensor, H: torch.Tensor,
                           W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[r] = H[r] @ W[uid[r]] + b[uid[r]] — the personalized-head serve
    oracle; any float H and W, f32 accumulate, f32 out."""
    u = uid.long()
    Wg = W[u].to(torch.float32)                              # (B, d, n)
    bg = b[u].to(torch.float32)                              # (B, n)
    return torch.einsum("bd,bdn->bn", H.to(torch.float32), Wg) + bg


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, scale=None) -> torch.Tensor:
    """Causal (optionally sliding-window: kpos > qpos - window) GQA
    attention, full-matrix math in f32: q (B, S, H, hd), k and v
    (B, S, Hkv, hd) in any float dtype, query head h reads kv head
    h // (H / Hkv); masked logits -1e30; output in q's dtype.  A CUDA
    caller wants torch.backends.cuda.matmul.allow_tf32 False."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.to(torch.float32).reshape(B, S, Hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                          k.to(torch.float32)) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full((), -1e30,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def rglru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gated linear recurrence h_t = a_t * h_{t-1} + b_t with h_{-1} = 0
    over (B, S, W), sequential in t; f32 out.  Each step rounds the product
    and then the sum, which is the arithmetic of the CUDA kernel
    (csrc/rglru.cu): the two agree bit for bit on the card."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    B, S, W = af.shape
    out = torch.empty_like(af)
    h = torch.zeros((B, W), dtype=torch.float32, device=af.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out
