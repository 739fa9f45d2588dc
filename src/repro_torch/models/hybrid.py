"""Hybrid recurrent/attention family — RecurrentGemma / Griffin.

Port of `repro/models/hybrid.py`.  recurrentgemma-9b [arXiv:2402.19427]:
38 layers, pattern (RG-LRU, RG-LRU, local-attn) repeating.  The forward
takes one of two routes, named by the caller (`layers.ROUTES`): "kernel"
runs the RG-LRU's linear recurrence through `ops.rglru` and local
attention (MQA with a sliding window) through `ops.flash_attention` (the
CUDA kernels on the card; prefill), "plain" through `associative_scan`,
the reference's `jax.lax.associative_scan` order ported, and the
reference's `gqa_attend` / `block_attention`, under autograd (`loss_fn`,
the training route: neither kernel has a backward).

With `tp` (`launch.tp.ModelShards`, the training route) the blocks hold
model rank t's shard: the RG-LRU's w_in_x / w_in_y, conv_w, w_a / w_i and
b_a / b_i / lam split over the W channels (the depthwise conv and the
recurrence on the rank's W / T of them; the (W, W) gate matrices read
all of xi, all-gathered), w_out row-parallel; the local attention's
query heads split, its one MQA head's K / V all-gathered where the plan
cuts them inside it (`layers.qkv_shard`); the MLP as `layers.swiglu`.

Parameters keep the reference's layout: periods of (2 recurrent + 1
attention) layers stacked on leading dims (`period_lru` (P, 2, ...),
`period_attn` (P, ...)) and the non-multiple tail (`tail_lru`
(tail, ...)).  Layers run as a Python loop over those dims, the port's
counterpart of `lax.scan`; `remat` rematerializes each period on the
training route (`remat.py`), as the reference checkpoints its period
body.  `lm_head` is its own leaf, as in the reference, although the
config says `tie_embeddings=True`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import ops
from ..tree import tree_map
from . import layers as L
from . import remat
from .config import ModelConfig

_C_RGLRU = 8.0


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------
def init_rglru_block(generator: torch.Generator, cfg: ModelConfig, lead=(),
                     device="cpu") -> dict:
    D, W = cfg.d_model, cfg.lru_width or cfg.d_model
    lead = tuple(lead)
    # Λ init so that a = exp(-8*softplus(Λ)*r) lands in [0.9, 0.999] at r=0.5
    lam = torch.rand(lead + (W,), generator=generator,
                     device=generator.device).mul_(0.1 - 0.0001).add_(0.0001)

    def w(shape, scale=None):
        return L.dense_init(generator, lead + shape, cfg.pdtype, scale=scale,
                            device=device)

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=cfg.pdtype, device=device)

    return {"w_in_x": w((D, W)), "w_in_y": w((D, W)),
            "conv_w": w((cfg.conv1d_width, W), 0.5),
            "w_a": w((W, W), 0.01), "b_a": zeros(W),
            "w_i": w((W, W), 0.01), "b_i": zeros(W),
            "lam": lam.to(dtype=torch.float32, device=device),
            "w_out": w((W, D))}


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv.  x: (B, S, W); w: (cw, W); state:
    (B, cw-1, W) or None.  The cw shifted products are summed in x's dtype
    in tap order, as the reference does (bf16 rounds at each add)."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    new_state = xp[:, -(cw - 1):] if cw > 1 else None
    return out, new_state


def _rglru_gates(p: dict, xi: torch.Tensor, tp=None):
    """(a, gated x) of the channels of w_a / w_i's columns: xi holds every
    channel the gate matrices read; they gate xi's channels, or with `tp`
    the rank's (`tp.own`, taken where it is used: its gradient then
    arrives in the plain order)."""
    r = torch.sigmoid(xi @ p["w_a"].to(xi.dtype) + p["b_a"].to(xi.dtype))
    i = torch.sigmoid(xi @ p["w_i"].to(xi.dtype) + p["b_i"].to(xi.dtype))
    log_a = -_C_RGLRU * F.softplus(p["lam"]) * r.to(torch.float32)
    a = torch.exp(log_a)
    own = xi if tp is None else tp.own(xi)
    gated_x = (i * own).to(torch.float32) * torch.sqrt(
        torch.clamp(1.0 - a * a, min=1e-12))
    return a, gated_x


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """out[0::2] = a, out[1::2] = b along `dim` (len a = len b or +1)."""
    n = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1).flatten(
        dim, dim + 1)
    if a.shape[dim] == n:
        return pairs
    return torch.cat([pairs, a.narrow(dim, n, 1)], dim=dim)


def _every_other(x: torch.Tensor, dim: int, start: int,
                 stop=None) -> torch.Tensor:
    sl = [slice(None)] * x.dim()
    sl[dim] = slice(start, stop, 2)
    return x[tuple(sl)]


def associative_scan(combine, elems: list, dim: int) -> list:
    """Inclusive scan of `elems` (tensors sharing their `dim` extent)
    under the associative `combine`, in `jax.lax.associative_scan`'s order
    (the odd/even recursion of Blelloch 1990): adjacent pairs combined,
    the half-size scan recursed, the even outputs combined from the odd
    ones, interleaved.  The same combines in the same order as the
    reference's: its f32 results differ only where XLA fuses a multiply
    and an add into one rounding (tests/test_torch_regime_b.py bounds
    it).  log2(S) levels of whole-tensor ops, differentiable."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine([_every_other(e, dim, 0, n - 1) for e in elems],
                      [_every_other(e, dim, 1) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([e.narrow(dim, 0, e.shape[dim] - 1) for e in odd],
                       [_every_other(e, dim, 2) for e in elems])
    else:
        even = combine(odd, [_every_other(e, dim, 2) for e in elems])
    even = [torch.cat([e.narrow(dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _linear_combine(c1, c2):
    (a1, b1), (a2, b2) = c1, c2
    return [a1 * a2, a2 * b1 + b2]


def rglru_scan(p: dict, xi: torch.Tensor, h0=None,
               route: str = "kernel", tp=None) -> torch.Tensor:
    """xi: (B, S, W).  h_t = a_t h_{t-1} + b_t in f32, through
    `ops.rglru` (route "kernel") or `associative_scan` (route "plain",
    differentiable); an initial state h0 folds into b_0 as a_0 * h0.
    With `tp` xi holds the rank's W / T channels: all of them are
    all-gathered for the gate matrices and enter through `tp.copy`, and
    the recurrence runs on the rank's."""
    if route not in L.ROUTES:
        raise ValueError(f"route={route!r}; known: {L.ROUTES}")
    if tp is None:
        a, b = _rglru_gates(p, xi)                   # (B, S, W) f32 each
    else:
        a, b = _rglru_gates(p, tp.copy(tp.gather(xi)), tp)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.to(torch.float32)
    if route == "plain":
        return associative_scan(_linear_combine, [a, b], 1)[1].to(xi.dtype)
    return ops.rglru(a, b).to(xi.dtype)


def rglru_step(p: dict, xi: torch.Tensor, h: torch.Tensor):
    """One decode step.  xi: (B, 1, W); h: (B, W) -> (y (B, 1, W), h')."""
    a, b = _rglru_gates(p, xi)
    hn = a[:, 0] * h.to(torch.float32) + b[:, 0]
    return hn.to(xi.dtype)[:, None, :], hn.to(h.dtype)


def recurrent_block(p: dict, x: torch.Tensor, cfg: ModelConfig, state=None,
                    route: str = "kernel", tp=None):
    """Griffin recurrent temporal block.  state: None | (h, conv_state);
    route: the full-sequence recurrence's (`rglru_scan`).  With `tp` (a
    full sequence) p holds model rank t's channels: x enters through
    `tp.copy` and the partial output leaves through `tp.reduce`."""
    if tp is not None:
        x = tp.copy(x)
    y = F.gelu(x @ p["w_in_y"].to(x.dtype), approximate="tanh")
    xi = x @ p["w_in_x"].to(x.dtype)
    if state is None:
        xi, _ = _causal_conv1d(xi, p["conv_w"])
        h = rglru_scan(p, xi, route=route, tp=tp)
        out = (h * y) @ p["w_out"].to(x.dtype)
        return (out if tp is None else tp.reduce(out)), None
    h0, conv_state = state
    xi, conv_state = _causal_conv1d(xi, p["conv_w"], conv_state)
    hseq, hn = rglru_step(p, xi, h0)
    return (hseq * y) @ p["w_out"].to(x.dtype), (hn, conv_state)


# ---------------------------------------------------------------------------
# layer inits
# ---------------------------------------------------------------------------
def init_lru_layer(generator: torch.Generator, cfg: ModelConfig, lead=(),
                   device="cpu") -> dict:
    lead = tuple(lead)
    ones = torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype, device=device)
    return {"ln1": ones, "rec": init_rglru_block(generator, cfg, lead, device),
            "ln2": ones.clone(),
            "mlp": L.init_swiglu(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                 lead, device)}


def init_attn_layer(generator: torch.Generator, cfg: ModelConfig, lead=(),
                    device="cpu") -> dict:
    lead = tuple(lead)
    ones = torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype, device=device)
    return {"ln1": ones,
            "attn": L.init_attention(generator, cfg, lead=lead, device=device),
            "ln2": ones.clone(),
            "mlp": L.init_swiglu(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                 lead, device)}


def _layout(cfg: ModelConfig):
    """(n_periods, n_tail_lru).  Pattern fixed: (rglru, rglru, attn)."""
    P = cfg.n_layers // 3
    return P, cfg.n_layers - 3 * P


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> dict:
    """Random parameters drawn from `generator` on its own device (pass a
    generator on the target device: recurrentgemma-9b holds 10.4 B f32
    parameters), stored on `device`.  The draws cannot replay the
    reference's `jax.random` init; parity runs carry that init across
    with `convert.params_from_reference`."""
    device = resolve_device(device)
    P, tail = _layout(cfg)
    params = {
        "embed": L.embed_init(generator, (cfg.vocab, cfg.d_model), cfg.pdtype,
                              device),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                                 device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                cfg.pdtype, device=device),
    }
    if P:
        params["period_lru"] = init_lru_layer(generator, cfg, (P, 2), device)
        params["period_attn"] = init_attn_layer(generator, cfg, (P,), device)
    if tail:
        params["tail_lru"] = init_lru_layer(generator, cfg, (tail,), device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _lru_layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig, state=None,
                   route: str = "kernel", tp=None):
    h = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
    r, state = recurrent_block(lp["rec"], h, cfg, state, route, tp)
    x = x + r
    h = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h, tp=tp), state


def _attn_layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, route: str, tp=None) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
    x = x + L.attention_train(lp["attn"], h, positions, cfg,
                              window=cfg.local_window, route=route, tp=tp)
    h = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h, tp=tp)


def _period_fwd(lru: dict, attn: dict, x: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                route: str, tp=None) -> torch.Tensor:
    """One period of the pattern: two RG-LRU layers, then local attention
    (the reference's rematerialized unit)."""
    for lj in L.unstack(lru):
        x, _ = _lru_layer_fwd(lj, x, cfg, route=route, tp=tp)
    return _attn_layer_fwd(attn, x, positions, cfg, route, tp)


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  positions=None, last_only: bool = False,
                  route: str = "kernel", tp=None) -> torch.Tensor:
    """Logits (B, S, vocab), or (B, 1, vocab) with last_only, in the
    compute dtype.  route: the recurrence's and the attention's
    (`layers.ROUTES`); "plain" is the training route.  With `tp`
    (`launch.tp.ModelShards`) params hold model rank t's shards and the
    logits are the rank's, as in `dense.forward_train`."""
    x = L.embed(params, tokens, cfg, tp)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    P, tail = _layout(cfg)
    on = remat.enabled(cfg, route)      # each period, as the reference
    if P:
        for lru, attn in zip(L.unstack(params["period_lru"]),
                             L.unstack(params["period_attn"])):
            x = remat.maybe(on, _period_fwd, lru, attn, x, positions, cfg,
                            route, tp)
    if tail:
        for lt in L.unstack(params["tail_lru"]):
            x, _ = _lru_layer_fwd(lt, x, cfg, route=route, tp=tp)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return L.head(params, x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy on the training route; with `tp`
    over model rank t's shards, the same value on every rank of the model
    group."""
    logits = forward_train(params, batch["tokens"], cfg, route="plain",
                           tp=tp)
    return L.xent(logits, batch["labels"], tp)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """Recurrent states (f32), conv states and a ring of C = min(cache_len,
    local_window) keys and values per attention layer."""
    device = resolve_device(device)
    P, tail = _layout(cfg)
    W = cfg.lru_width or cfg.d_model
    C = min(cache_len, cfg.local_window)
    cw = cfg.conv1d_width

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = {}
    if P:
        cache["p_h"] = z((P, 2, batch, W), torch.float32)
        cache["p_conv"] = z((P, 2, batch, cw - 1, W), cfg.cdtype)
        cache["p_k"] = z((P, batch, C, cfg.n_kv_heads, cfg.hd), cfg.cdtype)
        cache["p_v"] = z((P, batch, C, cfg.n_kv_heads, cfg.hd), cfg.cdtype)
    if tail:
        cache["t_h"] = z((tail, batch, W), torch.float32)
        cache["t_conv"] = z((tail, batch, cw - 1, W), cfg.cdtype)
    return cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One token per sequence.  tokens: (B, 1); pos: the tokens' absolute
    position.  -> (logits (B, 1, vocab), new cache); the cache passed in
    is not modified."""
    x = params["embed"][tokens].to(cfg.cdtype)
    P, tail = _layout(cfg)
    new_cache = dict(cache)
    if P:
        ph, pconv, pk, pv = [], [], [], []
        for pi in range(P):
            hs, cs = [], []
            for j in range(2):
                x, (hj, cj) = _lru_layer_fwd(
                    tree_map(lambda a: a[pi, j], params["period_lru"]), x, cfg,
                    (cache["p_h"][pi, j], cache["p_conv"][pi, j]))
                hs.append(hj)
                cs.append(cj)
            attn = tree_map(lambda a: a[pi], params["period_attn"])
            hn = L.rms_norm(x, attn["ln1"].to(x.dtype), cfg.norm_eps)
            a, k, v = L.attention_decode(attn["attn"], hn, pos,
                                         cache["p_k"][pi], cache["p_v"][pi],
                                         cfg, window=cfg.local_window)
            x = x + a
            hn = L.rms_norm(x, attn["ln2"].to(x.dtype), cfg.norm_eps)
            x = x + L.swiglu(attn["mlp"], hn)
            ph.append(torch.stack(hs))
            pconv.append(torch.stack(cs))
            pk.append(k)
            pv.append(v)
        new_cache.update(p_h=torch.stack(ph), p_conv=torch.stack(pconv),
                         p_k=torch.stack(pk), p_v=torch.stack(pv))
    if tail:
        th, tconv = [], []
        for ti in range(tail):
            x, (hn, cn) = _lru_layer_fwd(
                tree_map(lambda a: a[ti], params["tail_lru"]), x, cfg,
                (cache["t_h"][ti], cache["t_conv"][ti]))
            th.append(hn)
            tconv.append(cn)
        new_cache.update(t_h=torch.stack(th), t_conv=torch.stack(tconv))
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), new_cache
