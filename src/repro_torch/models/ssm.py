"""xLSTM family [arXiv:2405.04517] — sLSTM + mLSTM blocks.

Port of `repro/models/ssm.py`.  xlstm-125m: 12 layers, d_model 768, 4
heads, vocab 50,304.  Layers listed in `cfg.slstm_layers` are sLSTM
blocks (scalar memory, a true recurrence); the others are mLSTM blocks
(matrix memory) in the chunkwise-parallel form: intra-chunk quadratic
attention with the gated decay matrix D, and an inter-chunk state (C, n,
m) carried from chunk to chunk in f32 — O(S * chunk) compute and O(1)
decode state.  All gating uses the paper's exponential-gate stabilizer m.

The layers differ in shape, so `params["layers"]` is a Python list of 12
dicts (the layer kind follows from `cfg.slstm_layers`) and the decode
cache a list of 4-tuples, as in the reference: `repro_torch.tree` walks
lists in index order, the reference's treedef order.

The reference's `lax.scan`s become Python loops: over the `S // chunk`
chunks of each mLSTM layer, over the S positions of each sLSTM layer.
Everything is stock torch, as it is stock `jnp` in the reference: no
TPU kernel lies on this family's path, and it has no attention, so the
forward's `route` has no effect (it is checked and kept for the
registry's common signature).  `remat` rematerializes each layer in
`loss_fn`'s forward (`remat.py`).

With `tp` (`launch.tp.ModelShards`, the training route) the layers hold
model rank t's shard, its H / T heads:
- mLSTM: w_up column-parallel, its product all-gathered (at T 2 the
  halves are exactly xm and z) and entering through `tp.copy`; conv_w,
  wq, wk and wv over the rank's channels and heads (the depthwise conv on
  its channels, its conv output all-gathered for the q / k / gate
  products); w_if and b_if replicated, the gates computed on the
  replicated stream and the rank's heads' taken after `tp.copy`; gn over
  the rank's groups; w_down row-parallel, then `tp.reduce`;
- sLSTM: w_gates / b_gates in whole heads (4 hd columns each) and r_gates
  over heads, so the per-position loop runs on the rank's heads with no
  collective inside it; gn over the rank's groups, h all-gathered once
  after it, then the residual and the SwiGLU MLP (`layers.swiglu`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import layers as L
from . import remat
from .config import ModelConfig

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM — chunkwise parallel
# ---------------------------------------------------------------------------
def init_mlstm_block(generator: torch.Generator, cfg: ModelConfig,
                     device="cpu") -> dict:
    D, H = cfg.d_model, cfg.n_heads
    up = int(D * cfg.mlstm_proj_factor)

    def w(shape, scale=None):
        return L.dense_init(generator, shape, cfg.pdtype, scale=scale,
                            device=device)

    b_if = torch.cat([torch.zeros((H,), device=device),
                      torch.linspace(3.0, 6.0, H, device=device)])
    return {
        "ln": torch.ones((D,), dtype=cfg.pdtype, device=device),
        "w_up": w((D, 2 * up)),
        "conv_w": w((4, up), scale=0.5),
        "wq": w((up, up)), "wk": w((up, up)), "wv": w((up, up)),
        "w_if": w((up, 2 * H), scale=0.01),
        "b_if": b_if.to(cfg.pdtype),
        "gn": torch.ones((up,), dtype=cfg.pdtype, device=device),
        "w_down": w((up, D)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv of x (B, S, C) with w (cw, C), as Python's
    `sum` over the taps (0 + t0 + t1 + ...).  state: the last cw - 1 rows
    of the previous input (decode), zeros when None.  -> (out, the last
    cw - 1 rows of the padded input)."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(cw))
    return out, xp[:, -(cw - 1):, :]


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_i: torch.Tensor, log_f: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Chunkwise-parallel mLSTM.  q / k / v (B, S, H, hd), gates (B, S, H)
    f32 -> h (B, S, H, hd) f32.  A Python loop over the S // chunk chunks
    carries (C, n, m) in f32."""
    B, S, H, hd = q.shape
    T = min(chunk, S)
    if S % T:
        raise ValueError(f"seq {S} not divisible by chunk {T}")
    nc = S // T

    def r(x):  # (B, S, ...) -> (nc, B, T, ...)
        return torch.movedim(x.reshape(B, nc, T, *x.shape[2:]), 1, 0)

    qs, ks, vs, lis, lfs = r(q), r(k), r(v), r(log_i), r(log_f)
    dev = q.device
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)
    t = torch.arange(T, device=dev)
    mask = (t[:, None] >= t[None, :])[None, :, :, None]
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    hs = []
    for c in range(nc):
        qc, kc, vc, li, lf = qs[c], ks[c], vs[c], lis[c], lfs[c]  # (B,T,H,.)
        b = torch.cumsum(lf, dim=1)                          # (B,T,H) incl.
        total = b[:, -1]                                     # (B,H)
        # intra-chunk decay exponents: g[t,s] = b_t - b_s + li_s (s <= t)
        gexp = b[:, :, None, :] - b[:, None, :, :] + li[:, None, :, :]
        gexp = torch.where(mask, gexp, neg)                  # (B,T,T,H)
        # per-step stabilizer
        m_intra = torch.amax(gexp, dim=2)                    # (B,T,H)
        m_t = torch.maximum(b + m[:, None, :], m_intra)
        # inter-chunk contribution
        w_inter = torch.exp(b + m[:, None, :] - m_t)
        qf = qc.to(torch.float32)
        inter_h = torch.einsum("bthd,bhde->bthe", qf, C) * w_inter[..., None]
        inter_n = torch.einsum("bthd,bhd->bth", qf, n) * w_inter
        # intra-chunk contribution
        d = torch.exp(gexp - m_t[:, :, None, :])
        kf = kc.to(torch.float32)
        vf = vc.to(torch.float32)
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * d
        intra_h = torch.einsum("btsh,bshd->bthd", scores, vf)
        intra_n = torch.sum(scores, dim=2)
        denom = torch.maximum(torch.abs(inter_n + intra_n), torch.exp(-m_t))
        hs.append((inter_h + intra_h) / denom[..., None])
        # state update
        m_new = torch.maximum(total + m, torch.amax(
            total[:, None, :] - b + li, dim=1))
        w_c = torch.exp(total + m - m_new)                   # (B,H)
        w_s = torch.exp(total[:, None, :] - b + li - m_new[:, None, :])
        C = C * w_c[..., None, None] + torch.einsum(
            "bshd,bshe,bsh->bhde", kf, vf, w_s)
        n = n * w_c[..., None] + torch.einsum("bshd,bsh->bhd", kf, w_s)
        m = m_new
    return torch.movedim(torch.stack(hs), 0, 1).reshape(B, S, H, hd)


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, state):
    """One decode step.  q / k / v (B, H, hd); gates (B, H); state (C, n,
    m) f32 -> (h (B, H, hd) f32, new state)."""
    C, n, m = state
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    m_new = torch.maximum(log_f + m, log_i)
    wf = torch.exp(log_f + m - m_new)
    wi = torch.exp(log_i - m_new)
    C = C * wf[..., None, None] + \
        torch.einsum("bhd,bhe->bhde", kf, vf) * wi[..., None, None]
    n = n * wf[..., None] + kf * wi[..., None]
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)),
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def group_norm(x: torch.Tensor, weight: torch.Tensor, n_groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """Per-head group norm over the channel dim, x (..., C), in f32: the
    variance is `jnp.var`'s expression, the mean of (x - mu)^2
    (`F.group_norm` rounds differently)."""
    dt = x.dtype
    shp = x.shape
    xg = x.to(torch.float32).reshape(*shp[:-1], n_groups,
                                     shp[-1] // n_groups)
    mu = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xg - mu), dim=-1, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(shp) * weight).to(dt)


def _enter(x: torch.Tensor, tp) -> torch.Tensor:
    """x entering the rank's own work: through `tp.copy`, or a view of x
    without tp, so that both group the gradients of its uses alike (and
    the executor at T = 1 sums them in the plain order)."""
    return x.view_as(x) if tp is None else tp.copy(x)


def _own(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else tp.own(x)


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, state=None,
                tp=None):
    """x (B, S, D); state None (the chunkwise form) or (C, n, m,
    conv_state) (one decode step, S = 1) -> (x + block(x), new state or
    None).  With `tp` (a full sequence) p holds model rank t's shard (see
    the module docstring)."""
    B, S, D = x.shape
    H = cfg.n_heads
    xin = L.rms_norm(x, p["ln"].to(x.dtype), cfg.norm_eps)
    if tp is None:
        h2 = xin @ p["w_up"].to(x.dtype)
    else:
        h2 = tp.copy(tp.gather(tp.copy(xin) @ p["w_up"].to(x.dtype)))
        H = H // tp.T
    xm, z = torch.chunk(h2, 2, dim=-1)
    hd = xm.shape[-1] // cfg.n_heads
    up = hd * H                              # the rank's channels
    if state is None:
        xc, _ = _causal_conv(_own(xm, tp), p["conv_w"])
    else:
        C, n, m, conv_state = state
        xc, conv_state = _causal_conv(xm, p["conv_w"], conv_state)
    xc = F.silu(xc)
    if tp is not None:
        xc = tp.gather(xc)
    xq = _enter(xc, tp)
    q = (xq @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    # sqrt(hd) rounded to x's dtype first, as the reference's weakly typed
    # Python float is (bf16: sqrt(384) -> 19.625)
    k = (xq @ p["wk"].to(x.dtype)).reshape(B, S, H, hd) / torch.full(
        (), math.sqrt(hd), dtype=x.dtype, device=x.device)
    v = (xm @ p["wv"].to(x.dtype)).reshape(B, S, H, hd)
    gates = (xc @ p["w_if"].to(x.dtype) +
             p["b_if"].to(x.dtype)).to(torch.float32)
    log_i, f_raw = torch.chunk(_enter(gates, tp), 2, dim=-1)
    log_i, f_raw = _own(log_i, tp), _own(f_raw, tp)
    log_f = F.logsigmoid(f_raw)
    if state is None:
        h = mlstm_chunkwise(q, k, v, log_i, log_f, cfg.mlstm_chunk)
        new_state = None
    else:
        h, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                  log_f[:, 0], (C, n, m))
        h = h[:, None]
        new_state = (C, n, m, conv_state)
    h = h.to(x.dtype).reshape(B, S, up)
    h = group_norm(h, p["gn"].to(x.dtype), H)
    out = (h * F.silu(_own(z, tp))) @ p["w_down"].to(x.dtype)
    if tp is not None:
        out = tp.reduce(out)
    return x + out, new_state


# ---------------------------------------------------------------------------
# sLSTM — true recurrence
# ---------------------------------------------------------------------------
def init_slstm_block(generator: torch.Generator, cfg: ModelConfig,
                     device="cpu") -> dict:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    f = int(D * 4 * cfg.slstm_proj_factor / 2)  # GeGLU hidden
    ones = torch.ones((D,), dtype=cfg.pdtype, device=device)
    return {
        "ln": ones,
        "w_gates": L.dense_init(generator, (D, 4 * D), cfg.pdtype,
                                device=device),
        "b_gates": torch.zeros((4 * D,), dtype=cfg.pdtype, device=device),
        "r_gates": L.dense_init(generator, (H, hd, 4 * hd), cfg.pdtype,
                                scale=0.01, device=device),
        "gn": ones.clone(),
        "mlp": L.init_swiglu(generator, D, f, cfg.pdtype, device=device),
        "ln2": ones.clone(),
    }


def _slstm_cell(r_gates: torch.Tensor, gx: torch.Tensor, state, H: int,
                hd: int):
    """gx (B, 4D): the step's pre-activations from the input; r_gates (H,
    hd, 4 hd) in h's dtype; state (c, n, m, h), each (B, H, hd): c, n, m
    f32, h in the compute dtype."""
    c, n, m, h = state
    rec = torch.einsum("bhd,hde->bhe", h, r_gates)           # (B,H,4hd)
    g = gx.reshape(*gx.shape[:-1], H, 4 * hd) + rec
    zt, it, ft, ot = torch.chunk(g.to(torch.float32), 4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    h_new = ot * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h_new.to(h.dtype))


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, state=None,
                tp=None):
    """x (B, S, D); state None (zeros, m at -1e30) or (c, n, m, h) ->
    (the block's output, the state after the last position).  A Python
    loop over the S positions (the reference's `lax.scan`).  With `tp` p
    holds model rank t's heads (see the module docstring), the state too."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    xin = L.rms_norm(x, p["ln"].to(x.dtype), cfg.norm_eps)
    if tp is not None:
        xin, H = tp.copy(xin), H // tp.T
    gx = xin @ p["w_gates"].to(x.dtype) + p["b_gates"].to(x.dtype)
    if state is None:
        zeros = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        st = (zeros, zeros,
              torch.full((B, H, hd), -1e30, dtype=torch.float32,
                         device=x.device),
              torch.zeros((B, H, hd), dtype=x.dtype, device=x.device))
    else:
        st = tuple(state)
    r_gates = p["r_gates"].to(st[3].dtype)
    hs = []
    for t in range(S):
        st = _slstm_cell(r_gates, gx[:, t], st, H, hd)
        hs.append(st[3])
    h = torch.stack(hs, dim=1).reshape(B, S, H * hd)
    h = group_norm(h, p["gn"].to(x.dtype), H)
    if tp is not None:
        h = tp.gather(h)
    x = x + h
    hn = L.rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.swiglu(p["mlp"], hn, tp=tp), st


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def _kind(i: int, cfg: ModelConfig) -> str:
    return "slstm" if i in cfg.slstm_layers else "mlstm"


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> dict:
    """Random parameters drawn from `generator` on its own device, stored
    on `device`; `layers` is a Python list of the layers' dicts.  The
    draws cannot replay the reference's `jax.random` init; parity runs
    carry that init across with `convert.params_from_reference`."""
    device = resolve_device(device)
    layers = [(init_slstm_block if _kind(i, cfg) == "slstm"
               else init_mlstm_block)(generator, cfg, device)
              for i in range(cfg.n_layers)]
    return {
        "embed": L.embed_init(generator, (cfg.vocab, cfg.d_model),
                              cfg.pdtype, device),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                                 device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                cfg.pdtype, device=device),
    }


def _layer_out(fn, lp: dict, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """A layer's output without its final state (the training forward)."""
    return fn(lp, x, cfg, tp=tp)[0]


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  positions=None, last_only: bool = False,
                  route: str = "kernel", tp=None) -> torch.Tensor:
    """Logits (B, S, vocab), or (B, 1, vocab) with last_only, in the
    compute dtype.  `positions` is unused (the recurrences carry order)
    and `route` has no effect (no attention; both routes are the same
    stock torch ops).  With `tp` (`launch.tp.ModelShards`) params hold
    model rank t's shards and the logits are the rank's, as in
    `dense.forward_train`."""
    if route not in L.ROUTES:
        raise ValueError(f"route={route!r}; known: {L.ROUTES}")
    x = L.embed(params, tokens, cfg, tp)
    on = remat.enabled(cfg, route)
    for i, lp in enumerate(params["layers"]):
        fn = mlstm_block if _kind(i, cfg) == "mlstm" else slstm_block
        x = remat.maybe(on, _layer_out, fn, lp, x, cfg, tp)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return L.head(params, x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy; with `tp` over model rank t's
    shards, the same value on every rank of the model group."""
    logits = forward_train(params, batch["tokens"], cfg, route="plain",
                           tp=tp)
    return L.xent(logits, batch["labels"], tp)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> list:
    """The O(1) recurrent state, one 4-tuple a layer (cache_len unused):
    sLSTM (c, n, m, h) each (B, H, D/H), h in the compute dtype; mLSTM (C
    (B, H, hd, hd), n (B, H, hd), m (B, H), conv state (B, 3, up) in the
    compute dtype), hd = up / H."""
    del cache_len
    device = resolve_device(device)
    D, H = cfg.d_model, cfg.n_heads
    up = int(D * cfg.mlstm_proj_factor)
    hd_m, hd_s = up // H, D // H
    f32 = dict(dtype=torch.float32, device=device)
    cache = []
    for i in range(cfg.n_layers):
        if _kind(i, cfg) == "slstm":
            cache.append((torch.zeros((batch, H, hd_s), **f32),
                          torch.zeros((batch, H, hd_s), **f32),
                          torch.full((batch, H, hd_s), -1e30, **f32),
                          torch.zeros((batch, H, hd_s), dtype=cfg.cdtype,
                                      device=device)))
        else:
            cache.append((torch.zeros((batch, H, hd_m, hd_m), **f32),
                          torch.zeros((batch, H, hd_m), **f32),
                          torch.full((batch, H), -1e30, **f32),
                          torch.zeros((batch, 3, up), dtype=cfg.cdtype,
                                      device=device)))
    return cache


def decode_step(params: dict, cache: list, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One token per sequence: tokens (B, 1) -> (logits (B, 1, vocab), new
    cache); `pos` is unused (the state carries it) and the cache passed
    in is not modified."""
    del pos
    x = params["embed"][tokens].to(cfg.cdtype)
    new_cache = []
    for i, (lp, st) in enumerate(zip(params["layers"], cache)):
        fn = mlstm_block if _kind(i, cfg) == "mlstm" else slstm_block
        x, st = fn(lp, x, cfg, state=st)
        new_cache.append(st)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), new_cache
