"""VLM family — the Qwen2-VL backbone [arXiv:2409.12191].

Port of `repro/models/vlm.py`.  The ViT vision encoder + projector is a
stub, as in the reference: the batch carries precomputed patch embeddings
(B, n_vis, d_model).  The language backbone is real: GQA + QKV-bias
attention with M-RoPE, 3D rotary positions (temporal, height, width)
split across the head dim's frequency slots.  Vision tokens get grid
positions (0, h, w); text tokens get equal (t, t, t) positions starting
after the vision grid's extent.

The parameters are the dense family's (`dense.init_params`), and so is
the cache.  The forward's attention takes the port's two routes as
`dense.py` does ("kernel", `ops.flash_attention`, for prefill; "plain"
under autograd for `loss_fn`, each block rematerialized under `remat`,
`remat.py`); decode is text-only, all three position streams at `pos`,
attending over the cache with `gqa_attend`.
"""
from __future__ import annotations

import math

import torch

from . import dense
from . import layers as L
from . import remat
from .config import ModelConfig

init_params = dense.init_params  # the dense structure (with QKV bias)
init_cache = dense.init_cache


def build_positions(n_vis: int, n_text: int, start_text_only: int = 0,
                    device=None) -> torch.Tensor:
    """(3, S) int32 M-RoPE positions of a [vision grid | text] sequence:
    vision token i at (0, i // g, i % g) with g = floor(sqrt(n_vis)), text
    from g on (from `start_text_only` without vision)."""
    txt = torch.arange(n_text, dtype=torch.int32, device=device)
    if n_vis:
        g = max(int(math.sqrt(n_vis)), 1)
        idx = torch.arange(n_vis, dtype=torch.int32, device=device)
        vis = torch.stack([torch.zeros_like(idx), idx // g, idx % g])
        t0 = g  # text starts after the largest spatial extent
    else:
        vis = torch.zeros((3, 0), dtype=torch.int32, device=device)
        t0 = start_text_only
    return torch.cat([vis, (txt + t0).expand(3, n_text)], dim=1)


def _mrope_attention(p: dict, x: torch.Tensor, positions3: torch.Tensor,
                     cfg: ModelConfig, route: str, tp=None) -> torch.Tensor:
    if tp is None:
        q, k, v = L._qkv(p, x, cfg)
    else:
        q, k, v = L.qkv_shard(p, x, cfg, tp)
    q = L.apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
    k = L.apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
    if route == "plain":
        out = L.attend_plain(q, k, v)
    else:
        out = L.attend_auto(q, k, v)
    out = out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)
    return out if tp is None else tp.reduce(out)


def _block(lp: dict, x: torch.Tensor, positions3: torch.Tensor,
           cfg: ModelConfig, route: str, tp=None) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
    x = x + _mrope_attention(lp["attn"], h, positions3, cfg, route, tp)
    h = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h, tp=tp)


def forward_train(params: dict, batch: dict, cfg: ModelConfig,
                  last_only: bool = False, route: str = "kernel",
                  tp=None) -> torch.Tensor:
    """batch: {tokens (B, S_text), vision (B, n_vis, D), labels}.  ->
    logits at the text positions (B, S_text, vocab), or at the last
    position (B, 1, vocab) with last_only, in the compute dtype.  route:
    the attention's (`layers.ROUTES`); "plain" is the training route.
    With `tp` the params and logits are model rank t's, as in
    `dense.forward_train`."""
    if route not in L.ROUTES:
        raise ValueError(f"route={route!r}; known: {L.ROUTES}")
    tok_emb = L.embed(params, batch["tokens"], cfg, tp)
    vis = batch["vision"].to(cfg.cdtype)
    x = torch.cat([vis, tok_emb], dim=1)
    n_vis, n_text = vis.shape[1], tok_emb.shape[1]
    positions3 = build_positions(n_vis, n_text, device=x.device)[:, None, :]
    on = remat.enabled(cfg, route)
    for lp in L.unstack(params["layers"]):
        x = remat.maybe(on, _block, lp, x, positions3, cfg, route, tp)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    x = x[:, -1:] if last_only else x[:, n_vis:]   # text positions only
    return L.head(params, x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy over the text positions, on the
    training route (plain attention under autograd); with `tp` over model
    rank t's shards."""
    logits = forward_train(params, batch, cfg, route="plain", tp=tp)
    return L.xent(logits, batch["labels"], tp)


# ---------------------------------------------------------------------------
# decode — text-only continuation (all three position streams equal)
# ---------------------------------------------------------------------------
def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One token per sequence.  tokens: (B, 1); pos: the tokens' absolute
    position on every stream.  -> (logits (B, 1, vocab), new cache); the
    cache passed in is not modified."""
    pos = int(pos)
    x = params["embed"][tokens].to(cfg.cdtype)
    B = tokens.shape[0]
    posv3 = torch.full((3, B, 1), pos, dtype=torch.int32, device=x.device)
    cache = {"k": cache["k"].clone(), "v": cache["v"].clone()}
    C = cache["k"].shape[2]
    slot = min(pos, C - 1)
    valid = L.decode_valid(pos, C, 0, x.device)
    for i, lp in enumerate(L.unstack(params["layers"])):
        ck, cv = cache["k"][i], cache["v"][i]
        hn = L.rms_norm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], hn, cfg)
        q = L.apply_mrope(q, posv3, cfg.mrope_sections, cfg.rope_theta)
        k = L.apply_mrope(k, posv3, cfg.mrope_sections, cfg.rope_theta)
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        a = L.gqa_attend(q, ck.to(q.dtype), cv.to(q.dtype), valid[None, :])
        x = x + a.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype)
        hn = L.rms_norm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        x = x + L.swiglu(lp["mlp"], hn)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), cache
