"""Dense decoder-only transformer family.

Port of `repro/models/dense.py`.  Covers qwen2-0.5b [arXiv:2407.10671]
(GQA + QKV bias), granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]
(GQA), codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] (qwen1.5 arch) and
h2o-danube-1.8b [arXiv:2401.16818] (sliding-window attention, hd 80).

Layout: pre-RMSNorm blocks, SwiGLU MLP, RoPE; the layer weights are
stacked on a leading (n_layers, ...) dim as in the reference, and the
layers run as a Python loop over that dim (the reference's `lax.scan`;
`scan_unroll` is not read).  `remat` rematerializes each block on the
training route (`remat.py`), values and gradients unchanged.  The forward's attention takes one of two routes, named by the
caller (`layers.ROUTES`): "kernel", `ops.flash_attention` (the CUDA
kernel on the card, its plain version on the CPU; prefill), or "plain",
the reference's own `gqa_attend` / `block_attention` under autograd
(`loss_fn`, the training route: the kernel has no backward, and the
reference trains through neither Pallas kernel).  Decode attends over the
cache with `gqa_attend`, as the reference does.  `lm_head` is its own
leaf, as the reference draws it, although qwen2-0.5b and granite-3-2b
say `tie_embeddings=True`.

`kv_quant=True` decodes from an int8 cache with per-(token, head) f32
scales (`_decode_step_quant`), dequantized into the compute dtype before
the attention.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..tree import tree_map
from . import layers as L
from . import remat
from .config import ModelConfig


def init_layer(generator: torch.Generator, cfg: ModelConfig, lead=(),
               device="cpu") -> dict:
    """One block's weights, stacked over the leading dims `lead`."""
    lead = tuple(lead)
    ones = torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype, device=device)
    return {"ln1": ones,
            "attn": L.init_attention(generator, cfg, lead=lead, device=device),
            "ln2": ones.clone(),
            "mlp": L.init_swiglu(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                 lead, device)}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> dict:
    """Random parameters drawn from `generator` on its own device (pass a
    generator on the target device: codeqwen1.5-7b holds 8.2 B f32
    parameters), stored on `device`.  The draws cannot replay the
    reference's `jax.random` init; parity runs carry that init across
    with `convert.params_from_reference`."""
    device = resolve_device(device)
    return {
        "embed": L.embed_init(generator, (cfg.vocab, cfg.d_model), cfg.pdtype,
                              device),
        "layers": init_layer(generator, cfg, (cfg.n_layers,), device),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                                 device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                cfg.pdtype, device=device),
    }


def _layer(params: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], params["layers"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block(lp: dict, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, route: str, tp=None) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
    x = x + L.attention_train(lp["attn"], h, positions, cfg,
                              window=cfg.window, route=route, tp=tp)
    h = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h, tp=tp)


def backbone(params: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig, route: str = "kernel",
             tp=None) -> torch.Tensor:
    """x: (B, S, D) embeddings -> (B, S, D) features; with `tp` the
    layers hold one tensor-parallel shard (`launch/tp.py`)."""
    on = remat.enabled(cfg, route)
    for lp in L.unstack(params["layers"]):
        x = remat.maybe(on, _block, lp, x, positions, cfg, route, tp)
    return L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  positions=None, last_only: bool = False,
                  route: str = "kernel", tp=None) -> torch.Tensor:
    """Logits (B, S, vocab), or (B, 1, vocab) with last_only (prefill: the
    next-token sample point only), in the compute dtype.  route: the
    attention's (`layers.ROUTES`); "plain" is the training route.  With
    `tp` (`launch.tp.ModelShards`) params hold model rank t's shards and
    the logits are the rank's (its vocabulary slice where lm_head is
    split over the vocabulary)."""
    x = L.embed(params, tokens, cfg, tp)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    x = backbone(params, x, positions, cfg, route, tp)
    if last_only:
        x = x[:, -1:]
    return L.head(params, x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy on the training route (plain
    attention under autograd); with `tp` over model rank t's shards, the
    same value on every rank of the model group."""
    logits = forward_train(params, batch["tokens"], cfg, route="plain",
                           tp=tp)
    return L.xent(logits, batch["labels"], tp)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """Keys and values of every layer, (n_layers, B, C, Hkv, hd), C =
    min(cache_len, window) with a window (a ring) else cache_len; in the
    compute dtype, or int8 with (n_layers, B, C, Hkv) f32 scales
    (`k_s`, `v_s`) when cfg.kv_quant."""
    device = resolve_device(device)
    C = min(cache_len, cfg.window) if cfg.window else cache_len
    shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def _quantize(x: torch.Tensor):
    """x: (B, 1, H, hd) -> (int8 values, f32 scales (B, 1, H)): the
    scale is max |x| / 127 (at least 1e-8), the value x / scale rounded
    half to even and clipped to [-127, 127]."""
    xf = x.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(xf), dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _decode_step_quant(params: dict, cache: dict, tokens: torch.Tensor,
                       pos: int, cfg: ModelConfig):
    """decode_step over the int8 cache: each layer quantizes its new key
    and value into their slot, then attends over the dequantized cache."""
    pos = int(pos)
    x = params["embed"][tokens].to(cfg.cdtype)
    B = tokens.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    out = {name: t.clone() for name, t in cache.items()}
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        hn = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], hn, cfg)
        if cfg.rope_theta > 0:
            q = L.apply_rope(q, posv, cfg.rope_theta)
            k = L.apply_rope(k, posv, cfg.rope_theta)
        C = cache["k"].shape[2]
        slot = L.decode_slot(pos, C, cfg.window)
        new = dict(zip(("k", "k_s"), _quantize(k)))
        new.update(zip(("v", "v_s"), _quantize(v)))
        layer = {name: out[name][i] for name in new}
        for name, val in new.items():
            layer[name][:, slot] = val[:, 0]
        kf = layer["k"].to(q.dtype) * layer["k_s"][..., None].to(q.dtype)
        vf = layer["v"].to(q.dtype) * layer["v_s"][..., None].to(q.dtype)
        valid = L.decode_valid(pos, C, cfg.window, x.device)
        a = L.gqa_attend(q, kf, vf, valid[None, :])
        x = x + a.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype)
        hn = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        x = x + L.swiglu(lp["mlp"], hn)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), out


def decode_hidden(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                  cfg: ModelConfig):
    """The decode step's layers without its tail (final norm and lm_head):
    tokens (B, 1) at absolute position `pos` -> ((B, 1, D) hidden, new
    cache); the cache passed in is not modified.  Reads only `embed` and
    `layers` of params, so a serving trunk without the personal leaves
    will do."""
    pos = int(pos)
    x = params["embed"][tokens].to(cfg.cdtype)
    cache = {"k": cache["k"].clone(), "v": cache["v"].clone()}
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        hn = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        x = x + L.attention_decode_into(lp["attn"], hn, pos, cache["k"][i],
                                        cache["v"][i], cfg,
                                        window=cfg.window)
        hn = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        x = x + L.swiglu(lp["mlp"], hn)
    return x, cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One token per sequence.  tokens: (B, 1); pos: the tokens' absolute
    position.  -> (logits (B, 1, vocab), new cache); the cache passed in
    is not modified."""
    if cfg.kv_quant:
        return _decode_step_quant(params, cache, tokens, pos, cfg)
    x, cache = decode_hidden(params, cache, tokens, pos, cfg)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), cache
