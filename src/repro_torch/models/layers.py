"""Shared building blocks of `repro/models/layers.py`: the CNN's helpers
and what the hybrid (Griffin / RecurrentGemma), dense, moe, vlm, ssm
(xLSTM) and encdec (Whisper) families use.

Parameters are plain nested dicts of tensors, weights (in, out) as the
reference keeps them.  Every block casts its weights to the activation's
dtype before use, as the reference does, so f32 parameters run a bf16
compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..tree import from_paths, paths
from .config import ModelConfig


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale: Optional[float] = None, device="cpu") -> torch.Tensor:
    """LeCun-normal style init on the penultimate dim (leading batch dims
    of `shape` beyond the weight's own two are allowed).  Drawn on the
    generator's device, then moved to `device`."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device).mul_(s)
    return x.to(dtype=dtype, device=device)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device).mul_(0.02)
    return x.to(dtype=dtype, device=device)


def unstack(stacked: dict) -> list:
    """The per-layer trees of weights stacked on a leading (n, ...) dim:
    one `unbind` per leaf, whose backward stacks the layers' gradients
    into one tensor.  Indexing each layer out instead costs, in the
    backward, a zero-filled copy of the whole stack per layer and the sum
    of them (the same values: each element gets one layer's gradient)."""
    per_leaf = [(p, a.unbind(0)) for p, a in paths(stacked)]
    n = len(per_leaf[0][1])
    return [from_paths((p, views[i]) for p, views in per_leaf)
            for i in range(n)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 as the reference writes it (the variance as the
    mean of (x - mu)^2; `F.layer_norm` rounds differently)."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dt)


# ---------------------------------------------------------------------------
# RoPE (split-half, angles in f32)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_streams(hd: int, sections, device=None) -> torch.Tensor:
    """(hd/2,) stream (0 t, 1 h, 2 w) of each frequency slot: stream i
    repeated sections[i] times, truncated to hd/2 or padded with the last
    stream (`jnp.repeat`'s total_repeat_length)."""
    sec = torch.repeat_interleave(torch.arange(3, device=device),
                                  torch.as_tensor(sections, device=device),
                                  output_size=int(sum(sections)))
    n = hd // 2
    if sec.numel() < n:
        sec = torch.cat([sec, sec[-1:].expand(n - sec.numel())])
    return sec[:n]


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191): each of the hd/2
    frequency slots takes its position from the stream `sections` assigns
    it.  x: (..., S, H, hd); positions3: (3, ..., S) int for the (t, h, w)
    streams."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    sec = mrope_streams(hd, sections, x.device)
    pos = torch.movedim(positions3, 0, -1).to(torch.float32)  # (..., S, 3)
    ang = pos[..., sec] * freqs                               # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """(n_pos, dim) f32 sinusoidal embeddings: sin at the even columns,
    cos at the odd, angle pos * exp(-2i ln(10^4) / dim)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((n_pos, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def init_attention(generator: torch.Generator, cfg: ModelConfig, lead=(),
                   device="cpu") -> dict:
    """Attention weights; `lead` stacks them over leading (layer) dims."""
    D = cfg.d_model
    hd = cfg.hd
    lead = tuple(lead)

    def w(shape):
        return dense_init(generator, lead + shape, cfg.pdtype, device=device)

    p = {"wq": w((D, cfg.n_heads * hd)), "wk": w((D, cfg.n_kv_heads * hd)),
         "wv": w((D, cfg.n_kv_heads * hd)), "wo": w((cfg.n_heads * hd, D))}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(lead + (n * hd,), dtype=cfg.pdtype,
                                  device=device)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, scale: Optional[float] = None):
    """Grouped-query attention without materialising repeated KV.  Scores
    in the compute dtype, softmax in f32, probabilities cast back before
    P V (the reference's rounding points).  q: (B, Sq, H, hd), k/v:
    (B, Sk, Hkv, hd), mask broadcastable to (B, Hkv, g, Sq, Sk).  Returns
    (B, Sq, H, vh), vh = v.shape[-1] (MLA's V head dim differs)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qf = q.reshape(B, Sq, Hkv, g, hd)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k) * scale
    scores = torch.where(mask, scores.to(torch.float32),
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def causal_mask(sq: int, sk: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """(sq, sk) boolean mask; offset = absolute position of query 0 minus
    key 0."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, scale: Optional[float] = None,
                    q_block: int = 1024) -> torch.Tensor:
    """Memory-bounded causal (optionally sliding-window) GQA attention:
    a Python loop over query blocks, each attending through `gqa_attend`
    to the key slice it can see ([0, q_hi) causal, the trailing `window +
    block` band windowed), so no (S, S) mask or score tensor exists.
    q, k: (B, S, H, hd) / (B, S, Hkv, hd); v: (B, S, Hkv, vh) -> (B, S,
    H, vh): the V head dim may differ from the QK one (MLA)."""
    S = q.shape[1]
    qb = min(q_block, S)
    outs = []
    for q0 in range(0, S, qb):
        q1 = min(q0 + qb, S)
        k0 = max(0, q1 - window - (q1 - q0)) if window else 0
        mask = causal_mask(q1 - q0, q1 - k0, window=window, offset=q0 - k0,
                           device=q.device)
        outs.append(gqa_attend(q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], mask,
                               scale=scale))
    return torch.cat(outs, dim=1)


# sequences at or above this length take the blocked path in training
BLOCK_ATTN_MIN_SEQ = 2048
# the two routes of attention_train: "kernel" = ops.flash_attention (the
# CUDA kernel on the card; prefill), "plain" = the reference's own
# branches under autograd (training)
ROUTES = ("kernel", "plain")


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int = 0, scale: Optional[float] = None):
    """The training route: the reference's `attend_auto` branch for
    branch, plain torch under autograd.  Below BLOCK_ATTN_MIN_SEQ
    `gqa_attend` under `causal_mask`, at or above it `block_attention`;
    both round scores and probabilities to the compute dtype as the
    reference does (the kernel's f32 softmax is another function).  v's
    head dim may differ from q's and k's (MLA): the output takes v's."""
    if q.shape[1] >= BLOCK_ATTN_MIN_SEQ:
        return block_attention(q, k, v, window=window, scale=scale)
    mask = causal_mask(q.shape[1], k.shape[1], window=window,
                       device=q.device)
    return gqa_attend(q, k, v, mask, scale=scale)


def attend_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int = 0, scale: Optional[float] = None):
    """The kernel route: causal (sliding-window) attention through
    `ops.flash_attention` at every length, the CUDA kernel on the card,
    its plain version on the CPU.  Forward only: the kernel keeps scores,
    softmax and P V in f32 and has no backward (training takes
    `attend_plain`)."""
    return ops.flash_attention(q, k, v, window=window, scale=scale)


def qkv_shard(p: dict, x: torch.Tensor, cfg: ModelConfig, tp):
    """`_qkv` of model rank t's shard (`launch.tp.ModelShards`): x enters
    through `tp.copy`, the rank's H / T query heads, and the KV heads they
    read (`tp.kv`: the rank's own, or gathered where the plan cuts K / V
    inside a head).  cfg: the full config."""
    B, S, _ = x.shape
    x = tp.copy(x)
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k, v = tp.kv(k, v, cfg)
    return q.reshape(B, S, cfg.n_heads // tp.T, cfg.hd), k, v


def attention_train(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, window: int = 0,
                    theta: Optional[float] = None,
                    route: str = "kernel", tp=None) -> torch.Tensor:
    """Full-sequence attention block; `route` picks the attention
    (`ROUTES`): the caller states it, nothing falls back.  With `tp` (a
    `launch.tp.ModelShards`) p holds one tensor-parallel shard: wq / wk /
    wv and their biases column-parallel (`qkv_shard`), wo row-parallel;
    the partial output leaves through `tp.reduce`."""
    if route not in ROUTES:
        raise ValueError(f"route={route!r}; known: {ROUTES}")
    if tp is None:
        q, k, v = _qkv(p, x, cfg)
    else:
        q, k, v = qkv_shard(p, x, cfg, tp)
    th = theta if theta is not None else cfg.rope_theta
    if th > 0:
        q = apply_rope(q, positions, th)
        k = apply_rope(k, positions, th)
    if route == "plain":
        out = attend_plain(q, k, v, window=window)
    else:
        out = attend_auto(q, k, v, window=window)
    out = out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)
    return out if tp is None else tp.reduce(out)


def decode_slot(pos: int, C: int, window: int) -> int:
    """The cache slot a decode step at absolute position `pos` writes: a
    ring of C slots with a window, else the last slot once the cache is
    full."""
    return pos % C if window else min(pos, C - 1)


def decode_valid(pos: int, C: int, window: int, device=None) -> torch.Tensor:
    """(C,) mask of the cache slots a query at `pos` attends to, from the
    keys' absolute positions (the ring's slots hold the last C of them)."""
    idx = torch.arange(C, device=device)
    if window:
        n_wraps = pos // C
        kpos = torch.where(idx <= pos % C, idx + n_wraps * C,
                           idx + (n_wraps - 1) * C)
        return (kpos >= 0) & (kpos <= pos) & (kpos > pos - window)
    return idx <= min(pos, C - 1)


def attention_decode_into(p: dict, x: torch.Tensor, pos: int,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          cfg: ModelConfig, window: int = 0,
                          theta: Optional[float] = None) -> torch.Tensor:
    """One-token decode that writes the new key and value into their slot
    of cache_k / cache_v (B, C, Hkv, hd) in place.  x: (B, 1, D); pos:
    int; a ring buffer if window.  Returns y (B, 1, D)."""
    pos = int(pos)
    q, k, v = _qkv(p, x, cfg)
    th = theta if theta is not None else cfg.rope_theta
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    if th > 0:
        q = apply_rope(q, posv, th)
        k = apply_rope(k, posv, th)
    C = cache_k.shape[1]
    slot = decode_slot(pos, C, window)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    valid = decode_valid(pos, C, window, x.device)
    out = gqa_attend(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                     valid[None, :])
    return out.reshape(x.shape[0], 1, -1) @ p["wo"].to(x.dtype)


def attention_decode(p: dict, x: torch.Tensor, pos: int,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cfg: ModelConfig, window: int = 0,
                     theta: Optional[float] = None):
    """attention_decode_into on copies of the caches: returns (y, new
    cache_k, new cache_v); the caches passed in are not modified."""
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    y = attention_decode_into(p, x, pos, cache_k, cache_v, cfg, window,
                              theta)
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs and the loss
# ---------------------------------------------------------------------------
def init_swiglu(generator: torch.Generator, d: int, f: int,
                dtype=torch.float32, lead=(), device="cpu") -> dict:
    lead = tuple(lead)
    return {"wg": dense_init(generator, lead + (d, f), dtype, device=device),
            "wu": dense_init(generator, lead + (d, f), dtype, device=device),
            "wd": dense_init(generator, lead + (f, d), dtype, device=device)}


def swiglu(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SiLU(x Wg) * (x Wu) Wd.  With `tp` (`launch.tp.ModelShards`) p
    holds model rank t's shard: Wg / Wu column-parallel and Wd
    row-parallel, x through `tp.copy` and the partial output through
    `tp.reduce`; or, where the plan relocated the split to d_model (a
    hidden width T does not divide: Wd's shard shape is in
    `tp.mlp_d_model`), Wg / Wu over the rank's input rows with their
    partial products reduced before the gate, and Wd's output columns
    all-gathered."""
    if tp is not None and tuple(p["wd"].shape[-2:]) in tp.mlp_d_model:
        xc = tp.own(tp.copy(x))
        g = tp.reduce(xc @ p["wg"].to(x.dtype))
        u = tp.reduce(xc @ p["wu"].to(x.dtype))
        h = tp.copy(F.silu(g) * u)
        return tp.gather(h @ p["wd"].to(x.dtype))
    if tp is not None:
        x = tp.copy(x)
    h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wu"].to(x.dtype))
    out = h @ p["wd"].to(x.dtype)
    return out if tp is None else tp.reduce(out)


def init_gelu_mlp(generator: torch.Generator, d: int, f: int,
                  dtype=torch.float32, lead=(), device="cpu") -> dict:
    lead = tuple(lead)
    return {"w1": dense_init(generator, lead + (d, f), dtype, device=device),
            "b1": torch.zeros(lead + (f,), dtype=dtype, device=device),
            "w2": dense_init(generator, lead + (f, d), dtype, device=device),
            "b2": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def gelu_mlp(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x W1 + b1, GELU (tanh form: `jax.nn.gelu`'s default), then W2 +
    b2.  With `tp` (`launch.tp.ModelShards`) W1 / b1 column-parallel and
    W2 row-parallel: x through `tp.copy`, the partial product through
    `tp.reduce`, then the replicated b2."""
    if tp is not None:
        x = tp.copy(x)
    h = F.gelu(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype),
               approximate="tanh")
    out = h @ p["w2"].to(x.dtype)
    if tp is not None:
        out = tp.reduce(out)
    return out + p["b2"].to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: int = -100) -> torch.Tensor:
    """Mean token cross-entropy; labels == ignore are masked out.  Computed
    in f32, or in the logits' dtype where that is wider (f64)."""
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    w = (labels != ignore).to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


# ---------------------------------------------------------------------------
# the embedding, the head and the loss of every family
# ---------------------------------------------------------------------------
def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
          tp=None) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype: gather, then cast (the
    reference's cast-then-gather without a (vocab, d_model) temporary);
    with `tp` from the rank's shard of the table."""
    table = params["embed"]
    x = table[tokens] if tp is None else tp.embed(table, tokens)
    return x.to(cfg.cdtype)


def head(params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Features -> logits through lm_head (with `tp`: the rank's logits,
    `launch.tp.ModelShards.logits`)."""
    if tp is None:
        return x @ params["lm_head"].to(x.dtype)
    return tp.logits(x, params["lm_head"])


def xent(logits: torch.Tensor, labels: torch.Tensor, tp=None):
    """`softmax_xent`, or its tensor-parallel form over the rank's
    logits (`launch.tp.ModelShards.xent`)."""
    if tp is None:
        return softmax_xent(logits, labels)
    return tp.xent(logits, labels)
