"""Qwen2's decoder (arXiv:2407.10671), one client, plain PyTorch.

Pre-norm blocks: RMSNorm -> grouped-query attention (biases on the Q, K
and V projections, rotary positions on Q and K, causal softmax) ->
residual; RMSNorm -> SwiGLU MLP -> residual; a final RMSNorm and the
vocabulary head; next-token cross-entropy.  Parameters are f32, keyed by
path, each layer's leaves stacked over the layers ('layers/attn/wq' is
(n_layers, d, H hd)); the head is its own leaf ('lm_head'), as the
personalized model keeps it.  Activations and matrix products run in
`dtype`: float32 for the reference (TF32 off: the harness turns it off
around the reference); norms, rotary angles, the softmax and the loss
always in f32.

`fp8=True`, with `dtype` the configuration's bfloat16, is the control:
every product with a weight matrix takes its two operands through
float8 e4m3, each scaled by its own absolute maximum (a straight-through
cast: the backward sees the rounded operands' product and passes the
gradient on unrounded).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.detach().abs().amax().to(torch.float32),
                        min=1e-12) / FP8_MAX
    q = (x.detach().to(torch.float32) / scale).to(torch.float8_e4m3fn)
    q = (q.to(torch.float32) * scale).to(x.dtype)
    return x + (q - x.detach())


def _rms_norm(x, w, eps, dtype):
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * w).to(dtype)


def _rope(x, cos, sin):
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def loss(p: dict, batch: dict, cfg: dict, dtype=torch.float32,
         fp8: bool = False):
    """Mean next-token cross-entropy of one client's {'tokens': (B, S),
    'labels': (B, S)}."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    tokens = batch["tokens"]
    B, S = tokens.shape

    def mm(a, w):
        w = w.to(dtype)
        if fp8:
            a, w = _fp8(a), _fp8(w)
        return a @ w

    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=tokens.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=tokens.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    causal = torch.ones(S, S, dtype=torch.bool,
                        device=tokens.device).tril()

    x = p["embed"][tokens].to(dtype)
    for i in range(L):
        def lp(name):
            return p[f"layers/{name}"][i]

        h = _rms_norm(x, lp("ln1"), eps, dtype)
        q = (mm(h, lp("attn/wq")) + lp("attn/bq").to(dtype)).reshape(
            B, S, H, hd)
        k = (mm(h, lp("attn/wk")) + lp("attn/bk").to(dtype)).reshape(
            B, S, Hkv, hd)
        v = (mm(h, lp("attn/wv")) + lp("attn/bv").to(dtype)).reshape(
            B, S, Hkv, hd)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        scores = scores.to(torch.float32).masked_fill(~causal, -math.inf)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D)
        x = x + mm(a, lp("attn/wo"))
        h = _rms_norm(x, lp("ln2"), eps, dtype)
        x = x + mm(F.silu(mm(h, lp("mlp/wg"))) * mm(h, lp("mlp/wu")),
                   lp("mlp/wd"))
    x = _rms_norm(x, p["final_norm"], eps, dtype)
    logits = mm(x, p["lm_head"]).to(torch.float32)
    return F.cross_entropy(logits.reshape(B * S, -1),
                           batch["labels"].reshape(-1))
