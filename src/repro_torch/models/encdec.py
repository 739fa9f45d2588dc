"""Encoder-decoder family — the Whisper large-v3 backbone
[arXiv:2212.04356].

Port of `repro/models/encdec.py`.  The mel-spectrogram + conv frontend is
a stub, as in the reference: the batch carries precomputed frame
embeddings (B, n_frames, d_model).  Downstream all is real: a
bidirectional encoder, a causal decoder with cross-attention, LayerNorm +
bias blocks, GELU MLPs.  Positions are sinusoidal on both sides (the
reference's deviation from Whisper's learned 448-entry decoder table);
self-attention passes theta 0, so no RoPE.

Attention routes:
- decoder self-attention is `layers.attention_train(..., route=)`: the
  kernel route, `ops.flash_attention` (the CUDA kernel on the card, its
  plain version on the CPU), for prefill; the plain route under autograd
  for `loss_fn`;
- the encoder's full-mask attention and the cross-attention are always
  the plain `gqa_attend`, as in the reference: the flash kernel is causal
  or windowed only.

The layer weights are stacked on a leading dim (`enc_layers`,
`dec_layers`) as in the reference, and the layers run as a Python loop
over `layers.unstack` of the stacks (the reference's `lax.scan`;
`scan_unroll` is not read).  `remat` rematerializes each encoder and
decoder block on the training route (`remat.py`).  `prefill_cross` (the
encoder
run once and the cross-attention keys and values cached) is a module
function outside `ModelApi`, as in the reference.

With `tp` (`launch.tp.ModelShards`, the training route) the blocks hold
model rank t's shard: the encoder's attention and the decoder's self and
cross attention split over the rank's H / T heads (wq / wk / wv and
their biases column-parallel, wo row-parallel; the encoder output enters
each block's cross attention through `tp.copy`), the GELU MLP as
`layers.gelu_mlp`; the LayerNorms and b2 replicated.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import layers as L
from . import remat
from .config import ModelConfig


def _init_ln(cfg: ModelConfig, lead=(), device="cpu") -> dict:
    shape = tuple(lead) + (cfg.d_model,)
    return {"w": torch.ones(shape, dtype=cfg.pdtype, device=device),
            "b": torch.zeros(shape, dtype=cfg.pdtype, device=device)}


def init_enc_layer(generator: torch.Generator, cfg: ModelConfig, lead=(),
                   device="cpu") -> dict:
    """One encoder block's weights, stacked over the leading dims
    `lead`."""
    return {
        "ln1": _init_ln(cfg, lead, device),
        "attn": L.init_attention(generator, cfg, lead=lead, device=device),
        "ln2": _init_ln(cfg, lead, device),
        "mlp": L.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                               lead, device),
    }


def init_dec_layer(generator: torch.Generator, cfg: ModelConfig, lead=(),
                   device="cpu") -> dict:
    return {
        "ln1": _init_ln(cfg, lead, device),
        "self_attn": L.init_attention(generator, cfg, lead=lead,
                                      device=device),
        "ln_x": _init_ln(cfg, lead, device),
        "cross_attn": L.init_attention(generator, cfg, lead=lead,
                                       device=device),
        "ln2": _init_ln(cfg, lead, device),
        "mlp": L.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                               lead, device),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> dict:
    """Random parameters drawn from `generator` on its own device, stored
    on `device`.  The draws cannot replay the reference's `jax.random`
    init; parity runs carry that init across with
    `convert.params_from_reference`."""
    device = resolve_device(device)
    return {
        "embed": L.embed_init(generator, (cfg.vocab, cfg.d_model),
                              cfg.pdtype, device),
        "enc_layers": init_enc_layer(generator, cfg, (cfg.n_enc_layers,),
                                     device),
        "enc_norm": _init_ln(cfg, device=device),
        "dec_layers": init_dec_layer(generator, cfg, (cfg.n_layers,), device),
        "dec_norm": _init_ln(cfg, device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                cfg.pdtype, device=device),
    }


def _ln(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    return L.layer_norm(x, p["w"].to(x.dtype), p["b"].to(x.dtype), eps)


def _full(sq: int, sk: int, device) -> torch.Tensor:
    return torch.ones((sq, sk), dtype=torch.bool, device=device)


def _out(a: torch.Tensor, wo: torch.Tensor, tp) -> torch.Tensor:
    """The heads' output (B, S, h, hd) through wo (row-parallel with
    `tp`: the partial product reduced)."""
    out = a.reshape(*a.shape[:2], -1) @ wo.to(a.dtype)
    return out if tp is None else tp.reduce(out)


def _enc_block(lp: dict, x: torch.Tensor, full: torch.Tensor,
               cfg: ModelConfig, tp=None) -> torch.Tensor:
    hn = _ln(x, lp["ln1"])
    q, k, v = (L._qkv(lp["attn"], hn, cfg) if tp is None
               else L.qkv_shard(lp["attn"], hn, cfg, tp))
    a = L.gqa_attend(q, k, v, full)
    x = x + _out(a, lp["attn"]["wo"], tp)
    hn = _ln(x, lp["ln2"])
    return x + L.gelu_mlp(lp["mlp"], hn, tp)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           rematerialize: bool = False, tp=None) -> torch.Tensor:
    """frames (B, F, D), the stub conv frontend's output -> encoder
    features (B, F, D) in the compute dtype: bidirectional attention
    (`gqa_attend` under a full mask).  rematerialize: each block through
    `remat.call` (the training forward under cfg.remat); `tp`: the blocks
    hold model rank t's shards, the features are replicated."""
    x = frames.to(cfg.cdtype)
    x = x + L.sinusoid_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)[None]
    full = _full(x.shape[1], x.shape[1], x.device)
    for lp in L.unstack(params["enc_layers"]):
        x = remat.maybe(rematerialize, _enc_block, lp, x, full, cfg, tp)
    return _ln(x, params["enc_norm"])


def _cross_attend(lp: dict, h: torch.Tensor, enc_kv,
                  cfg: ModelConfig, tp=None) -> torch.Tensor:
    """enc_kv: the encoder's (k, v), each (B, F, Hkv, hd) (the rank's
    heads with `tp`; h enters through `tp.copy`)."""
    B, S, _ = h.shape
    H = cfg.n_heads
    if tp is not None:
        h, H = tp.copy(h), H // tp.T
    q = (h @ lp["wq"].to(h.dtype)).reshape(B, S, H, cfg.hd)
    k, v = enc_kv
    a = L.gqa_attend(q, k.to(h.dtype), v.to(h.dtype),
                     _full(S, k.shape[1], h.device))
    return _out(a, lp["wo"], tp)


def _enc_kv(lp: dict, enc_out: torch.Tensor, cfg: ModelConfig, tp=None):
    B, F, _ = enc_out.shape
    k = enc_out @ lp["wk"].to(enc_out.dtype)
    v = enc_out @ lp["wv"].to(enc_out.dtype)
    if tp is not None:
        return tp.kv(k, v, cfg)
    return (k.reshape(B, F, cfg.n_kv_heads, cfg.hd),
            v.reshape(B, F, cfg.n_kv_heads, cfg.hd))


def _dec_block(lp: dict, h: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig,
               route: str, tp=None) -> torch.Tensor:
    # one autograd use of enc_out per block: its gradient sums the block's
    # two uses (keys, values) first, in the same order whether or not the
    # block is rematerialized (remat.py); with `tp` that use is the
    # block's `tp.copy` into its heads
    enc_out = enc_out.view_as(enc_out) if tp is None else tp.copy(enc_out)
    hn = _ln(h, lp["ln1"])
    h = h + L.attention_train(lp["self_attn"], hn, positions, cfg,
                              theta=0.0, route=route, tp=tp)
    hn = _ln(h, lp["ln_x"])
    h = h + _cross_attend(lp["cross_attn"], hn,
                          _enc_kv(lp["cross_attn"], enc_out, cfg, tp), cfg,
                          tp)
    hn = _ln(h, lp["ln2"])
    return h + L.gelu_mlp(lp["mlp"], hn, tp)


def forward_train(params: dict, batch: dict, cfg: ModelConfig,
                  last_only: bool = False,
                  route: str = "kernel", tp=None) -> torch.Tensor:
    """batch: {frames (B, F, D), tokens (B, S)} -> logits (B, S, vocab),
    or (B, 1, vocab) with last_only, in the compute dtype.  route: the
    decoder self-attention's (`layers.ROUTES`); "plain" is the training
    route.  With `tp` (`launch.tp.ModelShards`) params hold model rank t's
    shards and the logits are the rank's, as in `dense.forward_train`."""
    if route not in L.ROUTES:
        raise ValueError(f"route={route!r}; known: {L.ROUTES}")
    on = remat.enabled(cfg, route)
    enc_out = encode(params, batch["frames"], cfg, on, tp)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = L.embed(params, tokens, cfg, tp)
    x = x + L.sinusoid_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    for lp in L.unstack(params["dec_layers"]):
        x = remat.maybe(on, _dec_block, lp, x, enc_out, positions, cfg,
                        route, tp)
    x = _ln(x, params["dec_norm"])
    if last_only:
        x = x[:, -1:]
    return L.head(params, x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy on the training route (plain
    attention under autograd); with `tp` over model rank t's shards, the
    same value on every rank of the model group."""
    logits = forward_train(params, batch, cfg, route="plain", tp=tp)
    return L.xent(logits, batch["labels"], tp)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """Self-attention keys and values (n_layers, B, cache_len, Hkv, hd)
    and the cross-attention's (n_layers, B, n_frames, Hkv, hd) (`xk`,
    `xv`, zeros until `prefill_cross`), in the compute dtype."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    xshape = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
    kw = dict(dtype=cfg.cdtype, device=device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "xk": torch.zeros(xshape, **kw), "xv": torch.zeros(xshape, **kw)}


def prefill_cross(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                  cache: dict) -> dict:
    """Run the encoder once and fill the cross-attention cache: -> a new
    cache dict with `xk` / `xv` replaced."""
    enc_out = encode(params, frames, cfg)
    kv = [_enc_kv(lp["cross_attn"], enc_out, cfg)
          for lp in L.unstack(params["dec_layers"])]
    return dict(cache, xk=torch.stack([k for k, _ in kv]),
                xv=torch.stack([v for _, v in kv]))


def _position_embedding(pos: int, d: int, device) -> torch.Tensor:
    """The sinusoid at one position, as the reference's decode step
    writes it (its own expression: the f32 log of 10^4 over d)."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-torch.log(torch.tensor(10000.0, device=device)) / d))
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) * div
    pe = torch.zeros((d,), dtype=torch.float32, device=device)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    return pe


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One token per sequence at absolute position `pos`: tokens (B, 1) ->
    (logits (B, 1, vocab), new cache); the cache passed in is not
    modified (the self-attention keys and values are copied once and
    written in place)."""
    pos = int(pos)
    x = params["embed"][tokens].to(cfg.cdtype)
    x = x + _position_embedding(pos, cfg.d_model, x.device).to(
        x.dtype)[None, None, :]
    ck, cv = cache["k"].clone(), cache["v"].clone()
    for i, lp in enumerate(L.unstack(params["dec_layers"])):
        hn = _ln(x, lp["ln1"])
        x = x + L.attention_decode_into(lp["self_attn"], hn, pos, ck[i], cv[i],
                                        cfg, theta=0.0)
        hn = _ln(x, lp["ln_x"])
        x = x + _cross_attend(lp["cross_attn"], hn,
                              (cache["xk"][i], cache["xv"][i]), cfg)
        hn = _ln(x, lp["ln2"])
        x = x + L.gelu_mlp(lp["mlp"], hn)
    x = _ln(x, params["dec_norm"])
    return x @ params["lm_head"].to(x.dtype), dict(cache, k=ck, v=cv)
