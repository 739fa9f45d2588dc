"""Mixture-of-Experts decoder family.

Port of `repro/models/moe.py`.  Covers deepseek-moe-16b
[arXiv:2401.06066] (fine-grained experts: 64 routed, top-6, 2 shared,
d_expert 1408; GQA attention) and deepseek-v2-236b [arXiv:2405.04434]
(MLA, kv_lora 512, + 160 routed / top-6 / 2 shared experts).

Routing is the reference's sort-based capacity dispatch: an f32 router,
softmax, top-k and the deepseek renormalisation; a stable sort of the
(token, choice) pairs by expert, each pair's position within its expert,
capacity C (rounded up to 8) and the `keep` mask; the tokens written into
an (E, C, D) buffer, the experts' SwiGLU as batched products
(`torch.bmm`), and the weighted combine.  All of it is stock torch, as
it is stock `jnp` in the reference (no Pallas kernel on this path).

Two sums of the reference are written so that their order is fixed:
- the dispatch adds, into slot (e, min(pos, C-1)), each pair's token
  times keep: one kept token and exact zeros from the dropped ones.  The
  port writes the kept tokens only (a plain indexed write; the dropped
  pairs go to one spare row past the buffer, which is cut off), the same
  values.  An accumulating `index_put_` would give them too, but on the
  card it sorts its indices and took ~2 ms a dispatch at deepseek-moe-16b's
  chunk of 4,096 tokens, 28% of the prefill;
- the combine gathers each token's K weighted expert outputs into (T, K,
  D) in ascending expert order and sums them left to right from zero:
  the order of the reference's `y.at[st].add(vals)` as XLA's sequential
  scatter applies it (the updates are sorted by expert), and the same on
  every run (an atomic `index_add_` on the card would not be).

The reference's `_constrain_dispatch` pins the dispatch buffer's sharding
over a device mesh and does no arithmetic: on one device it has no
counterpart.

Attention: GQA layers take the port's two routes as `dense.py` does
("kernel", `ops.flash_attention`, for prefill; "plain" under autograd for
`loss_fn`).  MLA (cfg.kv_lora > 0) always takes `layers.attend_plain`:
its QK head dim (nope + rope: 24 at reduced(), 192 at full width) differs
from its V head dim and is not among the flash kernel's HEAD_DIMS.  The
route is chosen by the config, never by catching an error.  MLA decode is
the absorbed-matrix form over the compressed `c` / `r` caches, in the
reference's association (`qc` first, then the scores).

The layer weights are stacked on a leading dim (`dense_layers`,
`moe_layers`) as in the reference, and the layers run as a Python loop
(the reference's `lax.scan`; `scan_unroll` is not read).  `remat`
rematerializes every dense and moe block on the training route
(`remat.py`), except when the caller collects or hands in the routes
(`routes`, `given`: a recompute would record or consume them twice).
`moe_seq_chunk` becomes a Python loop over the chunks.

With `tp` (`launch.tp.ModelShards`, the training route) the blocks hold
model rank t's shard: the E / T experts [t E / T, (t+1) E / T) of
`moe/w[gud]`; the router, its routing, capacity and drops and the aux
loss replicated (every rank computes them from all the tokens); each
rank dispatches and runs only its experts' slots, the tokens and combine
weights entering through `tp.copy`, and its partial combine leaves
through `tp.reduce`.  The shared experts and the dense MLP go through
`layers.swiglu`; GQA attention through `layers.attention_train`; MLA
with wq_a column-parallel (cq all-gathered before q_norm), wq_b / wkv_b
over the rank's H / T heads, wkv_a replicated (c_kv and k_rope enter
through `tp.copy`) and wo row-parallel.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..tree import tree_map
from . import layers as L
from . import remat
from .config import ModelConfig


# ---------------------------------------------------------------------------
# routed experts
# ---------------------------------------------------------------------------
def init_moe_ffn(generator: torch.Generator, cfg: ModelConfig, lead=(),
                 device="cpu") -> dict:
    lead = tuple(lead)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_expert

    def w(shape, dtype=cfg.pdtype, scale=None):
        return L.dense_init(generator, lead + shape, dtype, scale=scale,
                            device=device)

    p = {"router": w((D, E), torch.float32, scale=0.02),
         "wg": w((E, D, Fe)), "wu": w((E, D, Fe)), "wd": w((E, Fe, D))}
    if cfg.n_shared_experts:
        p["shared"] = L.init_swiglu(generator, D, cfg.n_shared_experts * Fe,
                                    cfg.pdtype, lead, device)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            routes: Optional[list] = None, given: Optional[Iterator] = None,
            tp=None):
    """x: (B, S, D) -> (y, aux_loss).  A sequence longer than a positive
    `moe_seq_chunk` that it divides runs through the dispatch chunk by
    chunk (capacity applies per chunk), aux the chunks' mean.  `routes`,
    a list, receives each dispatch's (T, K) expert ids; `given`, an
    iterator of such ids, hands each dispatch the experts to take in place
    of its own top-k (their weights the router's probabilities there,
    renormalised), so that a comparison can run on another run's routes.
    The expert stacks are cast to the compute dtype once, for every
    chunk.  With `tp` p holds the rank's experts (see the module
    docstring)."""
    B, S, D = x.shape
    w = {k: p[k].to(x.dtype) for k in ("wg", "wu", "wd")}
    ch = cfg.moe_seq_chunk
    if ch and S > ch and S % ch == 0:
        n = S // ch
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for i in range(n):
            y, a = _moe_ffn_dispatch(p, w, x[:, i * ch:(i + 1) * ch], cfg,
                                     routes, given, tp)
            aux = aux + a
            ys.append(y)
        return torch.cat(ys, dim=1), aux / n
    return _moe_ffn_dispatch(p, w, x, cfg, routes, given, tp)


def _moe_ffn_dispatch(p: dict, w: dict, x: torch.Tensor, cfg: ModelConfig,
                      routes: Optional[list] = None,
                      given: Optional[Iterator] = None, tp=None):
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    dt, dev = x.dtype, x.device
    xt = x.reshape(T, D)

    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    if given is None:
        topv, topi = torch.topk(probs, K, dim=-1)                   # (T, K)
    else:
        topi = next(given).to(device=dev, dtype=torch.long)
        topv = probs.gather(1, topi)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)  # deepseek renorm
    if routes is not None:
        routes.append(topi)

    # load-balance aux loss (Switch-style)
    me = torch.mean(probs, dim=0)                                   # (E,)
    one_hot_top1 = topi[:, :1] == torch.arange(E, device=dev)       # (T, E)
    ce = torch.mean(one_hot_top1.to(torch.float32), dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    # ---- sort-based dispatch ----
    flat_e = topi.reshape(-1)                                       # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], topv.reshape(-1)[order]
    # first sorted index of each expert: cumsum(counts) - counts, without
    # bincount's host sync on the card
    offsets = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - offsets[se]
    C = _capacity(T, cfg)
    slot = torch.clamp(pos, max=C - 1)
    xs = xt
    if tp is not None:
        # the rank's experts [e0, e0 + E / T): local ids, the other
        # experts' pairs dropped here (their weight 0; another rank's)
        n_e = w["wg"].shape[0]
        e0 = tp.t * n_e
        se = se - e0
        mine = (se >= 0) & (se < n_e)
        E = n_e
        keep = ((pos < C) & mine).to(dt)
        xs, sw = tp.copy(xt), tp.copy(sw)
        se_row = se.clamp(0, n_e - 1)
    else:
        keep = (pos < C).to(dt)
        se_row = se

    buf = dispatch(xs, se, st, pos, E, C)
    # batched expert SwiGLU: (E, C, D) x (E, D, F)
    h = F.silu(torch.bmm(buf, w["wg"]))
    h = h * torch.bmm(buf, w["wu"])
    out_buf = torch.bmm(h, w["wd"])

    vals = out_buf[se_row, slot] * (sw.to(dt) * keep)[:, None]      # (T*K, D)
    y = combine(vals, order, topi)
    if tp is not None:
        y = tp.reduce(y)
    if "shared" in p:
        y = y + L.swiglu(p["shared"], xt, tp=tp)
    return y.reshape(B, S, D), aux


def dispatch(xt: torch.Tensor, se: torch.Tensor, st: torch.Tensor,
             pos: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The (E, C, D) dispatch buffer: the token st of each sorted pair
    whose position pos within its expert se is below C in row (se, pos),
    zeros elsewhere.  Written through the flat (E * C + 1, D) buffer whose
    spare last row takes every dropped pair, and every pair of an expert
    outside [0, E) (another rank's), and is cut off."""
    row = torch.where((pos < C) & (se >= 0) & (se < E), se * C + pos, E * C)
    buf = torch.zeros((E * C + 1, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    return buf.index_put((row,), xt[st])[:E * C].view(E, C, xt.shape[1])


def combine(vals: torch.Tensor, order: torch.Tensor,
            topi: torch.Tensor) -> torch.Tensor:
    """The weighted combine: vals (T*K, D), the (token, choice) pairs'
    contributions in the sorted order `order` of the flat expert ids, ->
    y (T, D), each token's K contributions gathered in ascending expert
    order (their order in the sorted list) and summed left to right from
    zero: the order in which XLA's sequential scatter-add applies the
    reference's `zeros.at[st].add(vals)`, fixed from run to run."""
    T, K = topi.shape
    at = torch.argsort(order)            # each pair's place in the sorted list
    by_expert = at.view(T, K).gather(1, torch.argsort(topi, dim=1))
    contrib = vals[by_expert]                                       # (T, K, D)
    y = torch.zeros((T, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for j in range(K):
        y = y + contrib[:, j]
    return y


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2)
# ---------------------------------------------------------------------------
def init_mla(generator: torch.Generator, cfg: ModelConfig, lead=(),
             device="cpu") -> dict:
    lead = tuple(lead)
    D, H = cfg.d_model, cfg.n_heads
    nh, rh, vh, kl, ql = (cfg.nope_head_dim, cfg.rope_head_dim,
                          cfg.v_head_dim, cfg.kv_lora, cfg.q_lora)

    def w(shape):
        return L.dense_init(generator, lead + shape, cfg.pdtype, device=device)

    def ones(n):
        return torch.ones(lead + (n,), dtype=cfg.pdtype, device=device)

    p = {"wkv_a": w((D, kl + rh)), "kv_norm": ones(kl),
         "wkv_b": w((kl, H, nh + vh)), "wo": w((H * vh, D))}
    if ql:
        p["wq_a"] = w((D, ql))
        p["q_norm"] = ones(ql)
        p["wq_b"] = w((ql, H, nh + rh))
    else:
        p["wq"] = w((D, H, nh + rh))
    return p


def _mla_q(p: dict, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """(q_nope, q_rope) of the heads of wq_b's shard.  With `tp` wq_a is
    column-parallel: x enters through `tp.copy`, the rank's columns of cq
    are all-gathered for q_norm (over all of q_lora), and the normed cq
    enters the rank's heads through `tp.copy`."""
    if "wq_a" in p:
        if tp is None:
            cq = x @ p["wq_a"].to(x.dtype)
        else:
            cq = tp.gather(tp.copy(x) @ p["wq_a"].to(x.dtype))
        cq = L.rms_norm(cq, p["q_norm"].to(x.dtype))
        if tp is not None:
            cq = tp.copy(cq)
        q = torch.einsum("bsl,lhd->bshd", cq, p["wq_b"].to(x.dtype))
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    return torch.split(q, [cfg.nope_head_dim, cfg.rope_head_dim],
                       dim=-1)                                 # q_nope, q_rope


def _mla_kv_a(p: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig):
    """The compressed kv (B, S, kv_lora), normed, and the shared rotary
    key (B, S, 1, rope_hd)."""
    ckv = x @ p["wkv_a"].to(x.dtype)                             # (B,S,kl+rh)
    c_kv, k_rope = torch.split(ckv, [cfg.kv_lora, cfg.rope_head_dim], dim=-1)
    c_kv = L.rms_norm(c_kv, p["kv_norm"].to(x.dtype))
    return c_kv, L.apply_rope(k_rope[:, :, None, :], positions,
                              cfg.rope_theta)


def mla_train(p: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Full-sequence MLA, always through `layers.attend_plain` (QK head
    dim nope + rope, V head dim v_head_dim).  With `tp` (see the module
    docstring) the rank's H / T heads; the partial output leaves through
    `tp.reduce`."""
    B, S, D = x.shape
    H = cfg.n_heads if tp is None else cfg.n_heads // tp.T
    nh, rh, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, tp)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _mla_kv_a(p, x, positions, cfg)
    if tp is not None:
        c_kv, k_rope = tp.copy(c_kv), tp.copy(k_rope)
    kv = torch.einsum("bsl,lhd->bshd", c_kv, p["wkv_b"].to(x.dtype))
    k_nope, v = torch.split(kv, [nh, vh], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rh)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = L.attend_plain(q, k, v, scale=1.0 / math.sqrt(nh + rh))
    out = out.reshape(B, S, H * vh) @ p["wo"].to(x.dtype)
    return out if tp is None else tp.reduce(out)


def mla_decode_into(p: dict, x: torch.Tensor, pos: int,
                    c_cache: torch.Tensor, r_cache: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The reference's `mla_decode`, writing in place: absorbed-matrix
    MLA decode over the compressed cache, the new entries into slot
    min(pos, C-1) of c_cache (B, C, kv_lora) and r_cache (B, C, rope_hd).
    x: (B, 1, D) -> y (B, 1, D)."""
    pos = int(pos)
    B = x.shape[0]
    H = cfg.n_heads
    nh, rh, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg)                           # (B,1,H,·)
    q_rope = L.apply_rope(q_rope, posv, cfg.rope_theta)
    c_kv, k_rope = _mla_kv_a(p, x, posv, cfg)

    C = c_cache.shape[1]
    slot = min(pos, C - 1)
    c_cache[:, slot] = c_kv[:, 0].to(c_cache.dtype)
    r_cache[:, slot] = k_rope[:, 0, 0].to(r_cache.dtype)

    w_uk, w_uv = torch.split(p["wkv_b"].to(x.dtype), [nh, vh], dim=-1)
    qc = torch.einsum("bqhn,khn->bqhk", q_nope, w_uk)              # (B,1,H,kl)
    scores = (torch.einsum("bqhk,bck->bhqc", qc, c_cache.to(x.dtype))
              + torch.einsum("bqhr,bcr->bhqc", q_rope, r_cache.to(x.dtype)))
    scores = scores * (1.0 / math.sqrt(nh + rh))
    valid = (torch.arange(C, device=x.device) <= slot)[None, None, None, :]
    scores = torch.where(valid, scores.to(torch.float32),
                         torch.full((), -1e30, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqc,bck->bqhk", probs, c_cache.to(x.dtype))
    out = torch.einsum("bqhk,khv->bqhv", ctx, w_uv)                # (B,1,H,vh)
    return out.reshape(B, 1, H * vh) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# blocks / model
# ---------------------------------------------------------------------------
def _init_attn(generator, cfg: ModelConfig, lead, device) -> dict:
    if cfg.kv_lora:
        return init_mla(generator, cfg, lead, device)
    return L.init_attention(generator, cfg, lead=lead, device=device)


def init_moe_layer(generator: torch.Generator, cfg: ModelConfig, lead=(),
                   device="cpu") -> dict:
    """One MoE block's weights, stacked over the leading dims `lead`."""
    lead = tuple(lead)
    ones = torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype, device=device)
    return {"ln1": ones, "attn": _init_attn(generator, cfg, lead, device),
            "ln2": ones.clone(),
            "moe": init_moe_ffn(generator, cfg, lead, device)}


def init_dense_layer(generator: torch.Generator, cfg: ModelConfig, lead=(),
                     device="cpu") -> dict:
    """One dense block's weights (SwiGLU of dense_ff, else 4 d_model),
    stacked over the leading dims `lead`."""
    lead = tuple(lead)
    ones = torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype, device=device)
    return {"ln1": ones, "attn": _init_attn(generator, cfg, lead, device),
            "ln2": ones.clone(),
            "mlp": L.init_swiglu(generator, cfg.d_model,
                                 cfg.dense_ff or 4 * cfg.d_model, cfg.pdtype,
                                 lead, device)}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> dict:
    """Random parameters drawn from `generator` on its own device (pass a
    generator on the target device: deepseek-moe-16b holds 16.4 B f32
    parameters), stored on `device`.  As in the reference, max(1,
    first_dense_layers) dense layers are drawn.  The draws cannot replay
    the reference's `jax.random` init; parity runs carry that init across
    with `convert.params_from_reference`."""
    device = resolve_device(device)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    n_dense = max(cfg.first_dense_layers, 1)
    return {
        "embed": L.embed_init(generator, (cfg.vocab, cfg.d_model), cfg.pdtype,
                              device),
        "dense_layers": init_dense_layer(generator, cfg, (n_dense,), device),
        "moe_layers": init_moe_layer(generator, cfg, (n_moe,), device),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                                 device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                cfg.pdtype, device=device),
    }


def _attn_train(lp: dict, h: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, route: str, tp=None) -> torch.Tensor:
    if cfg.kv_lora:
        return mla_train(lp["attn"], h, positions, cfg, tp)
    return L.attention_train(lp["attn"], h, positions, cfg, route=route,
                             tp=tp)


def _dense_block(lp, x, positions, cfg: ModelConfig, route: str, tp=None):
    h = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
    x = x + _attn_train(lp, h, positions, cfg, route, tp)
    h = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h, tp=tp)


def _moe_block(lp, x, positions, cfg: ModelConfig, route: str, routes,
               given, tp=None):
    h = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
    x = x + _attn_train(lp, h, positions, cfg, route, tp)
    h = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
    y, aux = moe_ffn(lp["moe"], h, cfg, routes, given, tp)
    return x + y, aux


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  positions=None, last_only: bool = False,
                  route: str = "kernel", routes: Optional[list] = None,
                  given: Optional[Iterator] = None, tp=None):
    """-> (logits (B, S, vocab), or (B, 1, vocab) with last_only, in the
    compute dtype; the summed router aux loss, f32).  route: the GQA
    attention's (`layers.ROUTES`; "plain" is the training route; MLA is
    always plain).  `routes`, a list, receives every dispatch's (T, K)
    expert ids, layer by layer; `given` hands them in (`moe_ffn`).  With
    `tp` (`launch.tp.ModelShards`) params hold model rank t's shards and
    the logits are the rank's, as in `dense.forward_train`."""
    if route not in L.ROUTES:
        raise ValueError(f"route={route!r}; known: {L.ROUTES}")
    x = L.embed(params, tokens, cfg, tp)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    on = remat.enabled(cfg, route) and routes is None and given is None
    if cfg.first_dense_layers:
        for lp in L.unstack(params["dense_layers"]):
            x = remat.maybe(on, _dense_block, lp, x, positions, cfg, route,
                            tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in L.unstack(params["moe_layers"]):
        x, a = remat.maybe(on, _moe_block, lp, x, positions, cfg, route,
                           routes, given, tp)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return L.head(params, x, tp), aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            given: Optional[Iterator] = None, tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy plus the router aux loss, on the
    training route (plain attention under autograd); `given` as in
    `moe_ffn`; with `tp` over model rank t's shards, the same value on
    every rank of the model group."""
    logits, aux = forward_train(params, batch["tokens"], cfg, route="plain",
                                given=given, tp=tp)
    return L.xent(logits, batch["labels"], tp) + aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """{"dense": ..., "moe": ...} of (n_layers, B, C, ...) caches in the
    compute dtype: MLA's compressed `c` (kv_lora) and rotary key `r`
    (rope_hd), else GQA's `k` / `v` (Hkv, hd)."""
    device = resolve_device(device)
    sizes = {"dense": max(cfg.first_dense_layers, 1),
             "moe": cfg.n_layers - cfg.first_dense_layers}
    if cfg.kv_lora:
        tails = {"c": (cfg.kv_lora,), "r": (cfg.rope_head_dim,)}
    else:
        tails = {"k": (cfg.n_kv_heads, cfg.hd), "v": (cfg.n_kv_heads, cfg.hd)}
    return {part: {name: torch.zeros((n, batch, cache_len) + tail,
                                     dtype=cfg.cdtype, device=device)
                   for name, tail in tails.items()}
            for part, n in sizes.items()}


def _attn_decode_into(lp: dict, h: torch.Tensor, pos: int, c0, c1,
                      cfg: ModelConfig) -> torch.Tensor:
    if cfg.kv_lora:
        return mla_decode_into(lp["attn"], h, pos, c0, c1, cfg)
    return L.attention_decode_into(lp["attn"], h, pos, c0, c1, cfg)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig, routes: Optional[list] = None,
                given: Optional[Iterator] = None):
    """One token per sequence.  tokens: (B, 1); pos: the tokens' absolute
    position.  -> (logits (B, 1, vocab), new cache); the cache passed in
    is not modified.  Every stored dense layer runs, as in the
    reference's decode.  `routes` / `given` as in `moe_ffn`."""
    pos = int(pos)
    x = params["embed"][tokens].to(cfg.cdtype)
    keys = ("c", "r") if cfg.kv_lora else ("k", "v")
    new = tree_map(lambda t: t.clone(), cache)
    for part, stack in (("dense", "dense_layers"), ("moe", "moe_layers")):
        c0, c1 = (new[part][k] for k in keys)
        for i, lp in enumerate(L.unstack(params[stack])):
            hn = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
            x = x + _attn_decode_into(lp, hn, pos, c0[i], c1[i], cfg)
            hn = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
            if part == "dense":
                x = x + L.swiglu(lp["mlp"], hn)
            else:
                x = x + moe_ffn(lp["moe"], hn, cfg, routes, given)[0]
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), new
