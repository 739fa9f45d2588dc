"""Port parity for the hybrid (Griffin / RecurrentGemma) serve path on the
CPU: `flash_attention` and `rglru`'s plain versions against the reference's
jnp oracles and interpreted Pallas kernels, the layers and recurrent
blocks, and the whole `reduced()` model (forward, prefill, loss, decode
across a ring wrap) from the reference's init carried across by
`convert`, all on the same numpy inputs.  Also the dispatch rules of the
two new ops, the config registry and the synthetic LM batch.

The CUDA kernels run only on a GPU; `chip_smoke.py` holds them against
these plain versions on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rglru import rglru_pallas
from repro.models import hybrid as jhybrid
from repro.models import layers as JL
from repro.models import prefill_logits as jprefill_logits
from repro_torch import convert, configs, models
from repro_torch.data import lm_synthetic_batch
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rglru import rglru_cuda
from repro_torch.models import hybrid as thybrid
from repro_torch.models import layers as TL
from repro_torch.tree import tree_map

torch.set_num_threads(2)
ARCH = "recurrentgemma-9b"


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t2np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(_t2np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _qkv_inputs(B, S, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
FLASH_SHAPES = [
    (1, 128, 4, 4, 64, 0),      # MHA
    (2, 256, 4, 2, 64, 0),      # GQA 2:1
    (1, 256, 8, 1, 32, 0),      # MQA
    (1, 256, 4, 2, 64, 64),     # sliding window
    (1, 512, 2, 2, 128, 128),   # window = block
    (2, 128, 2, 1, 128, 96),    # window not multiple of block
]


@pytest.mark.parametrize("B,S,H,Hkv,hd,window", FLASH_SHAPES)
def test_flash_attention_plain_matches_reference(B, S, H, Hkv, hd, window):
    # all three are f32 math; the full-matrix oracles differ only in sum
    # order (1e-5), the interpreted Pallas kernel's online softmax in its
    # rescaling too (the JAX suite's tolerance for it is 2e-3; measured
    # here well under 1e-5): rtol/atol 1e-5
    q, k, v = _qkv_inputs(B, S, H, Hkv, hd, seed=S + H + window)
    got = tref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                   window=window)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jref.flash_attention_ref(jq, jk, jv, window=window),
                 flash_attention_pallas(jq, jk, jv, window=window,
                                        interpret=True, bq=64, bk=64)):
        _close(got, want, 1e-5, 1e-5)


def test_flash_attention_plain_bf16_matches_reference():
    # bf16 in, f32 math, bf16 out on every side: an ulp-level f32
    # difference can flip the final rounding -> one bf16 ulp, rtol/atol
    # 8e-3 (the JAX suite allows 3e-2 for its kernel)
    q, k, v = _qkv_inputs(1, 128, 4, 2, 64, seed=7)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    for want in (jref.flash_attention_ref(jq, jk, jv),
                 flash_attention_pallas(jq, jk, jv, interpret=True, bq=64,
                                        bk=64)):
        assert want.dtype == jnp.bfloat16
        _close(got, want, 8e-3, 8e-3)


@pytest.mark.parametrize("S,window,scale", [(37, 0, None), (37, 5, 0.3),
                                            (1, 0, None), (50, 64, None)])
def test_flash_attention_plain_any_length(S, window, scale):
    # lengths the TPU kernel refuses (S % bq != 0): the port's plain
    # version against the reference's oracle, f32, rtol/atol 1e-5
    q, k, v = _qkv_inputs(2, S, 4, 2, 32, seed=S + window)
    got = tref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                   window=window, scale=scale)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    window=window, scale=scale)
    _close(got, want, 1e-5, 1e-5)


def test_flash_attention_plain_matches_model_block_attention():
    # the reference's attention paths compute the kernel's function: its
    # blocked path (f32) against the port's plain version, rtol/atol 1e-5
    q, k, v = _qkv_inputs(1, 256, 4, 2, 64, seed=3)
    got = tref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                   window=48)
    want = JL.block_attention(*map(jnp.asarray, (q, k, v)), window=48,
                              q_block=64)
    _close(got, want, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# rglru
# ---------------------------------------------------------------------------
def _gate_inputs(B, S, W, seed, top=0.98):
    rng = np.random.default_rng(seed)
    a = (top / (1 + np.exp(-rng.standard_normal((B, S, W))))).astype(
        np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


@jax.jit
def _assoc_scan(a, b):
    """hybrid.rglru_scan's core (hybrid.py:72-77)."""
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2
    return jax.lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("B,S,W", [(1, 256, 128), (2, 512, 128),
                                   (1, 1024, 256), (3, 256, 384)])
def test_rglru_plain_matches_reference(B, S, W):
    # the sequential oracle and the interpreted kernel walk the same
    # recurrence; XLA may contract a*h+b into an FMA where the port rounds
    # the product: rtol/atol 1e-5.  The associative scan multiplies the
    # a's in another order: rtol/atol 2e-4 (the JAX suite's tolerance)
    a, b = _gate_inputs(B, S, W, seed=B * S + W)
    got = tref.rglru_ref(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(got, jref.rglru_ref(ja, jb), 1e-5, 1e-5)
    _close(got, rglru_pallas(ja, jb, interpret=True), 1e-5, 1e-5)
    _close(got, _assoc_scan(ja, jb), 2e-4, 2e-4)


@pytest.mark.parametrize("B,S,W,top", [(2, 37, 5, 0.98), (1, 1, 1, 0.98),
                                       (3, 300, 130, 1.0)])
def test_rglru_plain_any_shape(B, S, W, top):
    # shapes the TPU kernel refuses, and a ~ 1 (sigmoid * 1.0): the
    # port's plain version against the reference's oracle, rtol/atol 1e-5
    a, b = _gate_inputs(B, S, W, seed=S + W, top=top)
    got = tref.rglru_ref(torch.as_tensor(a), torch.as_tensor(b))
    _close(got, jref.rglru_ref(jnp.asarray(a), jnp.asarray(b)), 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# dispatch of the two new ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op,knob", [("flash_attention", "bq"),
                                     ("flash_attention", "bk"),
                                     ("rglru", "bs"), ("rglru", "bw")])
@pytest.mark.parametrize("force", ["auto", "ref"])
def test_new_kernel_knobs_raise_on_plain_dispatch(op, knob, force):
    if op == "flash_attention":
        args = tuple(torch.as_tensor(x) for x in _qkv_inputs(1, 8, 2, 1, 32,
                                                              0))
    else:
        args = tuple(torch.as_tensor(x) for x in _gate_inputs(1, 8, 4, 0))
    with pytest.raises(ValueError, match=knob):
        getattr(ops, op)(*args, force=force, **{knob: 32})


def test_new_ops_dispatch_rules_on_cpu():
    q, k, v = (torch.as_tensor(x) for x in _qkv_inputs(1, 8, 2, 1, 32, 0))
    a, b = (torch.as_tensor(x) for x in _gate_inputs(1, 8, 4, 0))
    before = ops.launch_counts()
    assert torch.equal(ops.flash_attention(q, k, v, window=3),
                       tref.flash_attention_ref(q, k, v, window=3))
    assert torch.equal(ops.rglru(a, b, force="ref"), tref.rglru_ref(a, b))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.flash_attention(q, k, v, force="cuda")
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.rglru(a, b, force="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_cuda(a, b)
    assert {"flash_attention", "rglru"} <= set(ops.KERNELS)
    assert {"flash_attention", "rglru"} <= set(_build.SOURCES)


def test_forward_only_kernels_refuse_grad(monkeypatch):
    # the kernel path (forced here with stand-in kernels, as on the card)
    # raises when autograd tracks an input; under no_grad or with
    # detached inputs it launches
    calls = []
    monkeypatch.setattr(ops, "_use_kernel", lambda force, t: True)
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        lambda *a, **k: calls.append("flash"))
    monkeypatch.setattr(ops, "rglru_cuda",
                        lambda *a, **k: calls.append("rglru"))
    q, k, v = (torch.ones(1, 4, 2, 32) for _ in range(3))
    a, b = torch.ones(1, 4, 3), torch.ones(1, 4, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rglru(a, b.requires_grad_())
    assert calls == []
    with torch.no_grad():
        ops.flash_attention(q, k, v)
        ops.rglru(a, b)
    ops.flash_attention(q.detach(), k, v)
    assert calls == ["flash", "rglru", "flash"]


# ---------------------------------------------------------------------------
# configs, registry, data, convert
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_equals_reference_field_by_field(which):
    if which == "full":
        tc, jc = configs.get_config(ARCH), jget_config(ARCH)
    else:
        tc, jc = configs.get_reduced(ARCH), jget_reduced(ARCH)
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    assert tf == jf
    assert tc.hd == jc.hd and tc.param_count() == jc.param_count()
    assert str(tc.pdtype).split(".")[-1] == str(jc.pdtype)
    assert str(tc.cdtype).split(".")[-1] == str(jc.cdtype)
    assert tc._block_kind(2) == jc._block_kind(2) == "attn"


def test_unported_archs_and_families_raise():
    # every arch and family of the reference resolves; an unknown arch or
    # family still raises
    families = set()
    for arch in jconfigs.ARCH_IDS:
        cfg = configs.get_config(arch)
        assert configs.get_reduced(arch).family == cfg.family
        api = models.get_model(cfg)
        assert api is models.get_model(configs.get_reduced(arch))
        families.add(cfg.family)
    assert len(jconfigs.ARCH_IDS) == 10
    assert families == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_reduced("gpt-5")
    odd = configs.get_reduced(ARCH).replace(family="rnn")
    with pytest.raises(ValueError, match="unknown model family"):
        models.get_model(odd)
    with pytest.raises(ValueError, match="unknown model family"):
        models.prefill_logits({}, {"tokens": None}, odd)
    api = models.get_model(configs.get_reduced(ARCH))
    assert api.decode_step is thybrid.decode_step
    assert configs.SHAPES["prefill_32k"].seq_len == 32_768


def test_lm_synthetic_batch_follows_the_markov_rule():
    vocab = 1000
    batch = lm_synthetic_batch(torch.Generator().manual_seed(3), vocab, 3, 50)
    tok, lab = batch["tokens"], batch["labels"]
    assert tok.shape == lab.shape == (3, 50) and tok.dtype == torch.int64
    step = torch.remainder(tok[:, 1:] - 31 * tok[:, :-1], vocab)
    assert int(step.min()) >= 0 and int(step.max()) < 17
    assert int(tok.min()) >= 0 and int(tok.max()) < vocab
    assert torch.equal(lab[:, :-1], tok[:, 1:])
    assert torch.equal(lab[:, -1], tok[:, 0])
    again = lm_synthetic_batch(torch.Generator().manual_seed(3), vocab, 3, 50)
    assert torch.equal(again["tokens"], tok)


@pytest.fixture(scope="module")
def reduced_init():
    """The reference's init of `reduced()` (numpy) and its conversion."""
    cfg = jget_reduced(ARCH)
    init = jax.jit(jhybrid.init_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg))
    return jp, convert.params_from_reference(jp)


def test_params_from_reference_carries_the_hybrid_tree(reduced_init):
    # the existing converter carries the stacked hybrid tree unchanged;
    # the port's own init has the same structure, shapes and dtypes
    jp, tp = reduced_init
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jpaths) == len(list(_tree_paths(tp))) == 40
    for path, leaf in jpaths:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and np.array_equal(
            t.numpy(), leaf), path
    own = thybrid.init_params(torch.Generator().manual_seed(0),
                              configs.get_reduced(ARCH), device="cpu")
    assert {p: (tuple(v.shape), v.dtype) for p, v in _tree_paths(own)} == \
        {p: (tuple(v.shape), v.dtype) for p, v in _tree_paths(tp)}
    lam = own["period_lru"]["rec"]["lam"]
    assert float(lam.min()) >= 1e-4 and float(lam.max()) <= 0.1


def _tree_paths(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _tree_paths(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


# ---------------------------------------------------------------------------
# layers and recurrent blocks (reduced widths, f32)
# ---------------------------------------------------------------------------
def _layer(tp, jp, name, *idx):
    """Layer `idx` of a stacked leaf group, port and reference."""
    return (tree_map(lambda a: a[idx], tp[name]),
            jax.tree.map(lambda a: a[idx], jp[name]))


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32) * 37, (2, 1))
    _close(TL.rms_norm(torch.as_tensor(x), torch.as_tensor(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6, 1e-6)
    # f32 angles up to 296 rad: libm cos/sin differ by an ulp -> 1e-5
    _close(TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5, 1e-5)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    got = TL.apply_rope(xb, torch.as_tensor(pos), 1e4)
    assert got.dtype == torch.bfloat16
    _close(got, JL.apply_rope(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(pos), 1e4), 8e-3, 8e-3)


def _with_qkv_bias(jl, tl, cfg_t, cfg_j, seed):
    """The layer's attention with random q/k/v biases on both sides."""
    rng = np.random.default_rng(seed)
    jattn = dict(jl["attn"])
    for name, n in (("bq", cfg_t.n_heads), ("bk", cfg_t.n_kv_heads),
                    ("bv", cfg_t.n_kv_heads)):
        jattn[name] = rng.standard_normal(n * cfg_t.hd).astype(np.float32)
    return (convert.params_from_reference(jattn), jattn,
            cfg_t.replace(qkv_bias=True), cfg_j.replace(qkv_bias=True))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_train_matches_reference(reduced_init, qkv_bias):
    # f32; the port's attention is the kernel's f32 function, the
    # reference's gqa_attend is f32 too at this compute dtype: 2e-5
    jp, tp = reduced_init
    cfg_t, cfg_j = configs.get_reduced(ARCH), jget_reduced(ARCH)
    tl, jl = _layer(tp, jp, "period_attn", 0)
    if qkv_bias:
        tattn, jattn, cfg_t, cfg_j = _with_qkv_bias(jl, tl, cfg_t, cfg_j, 9)
        tl, jl = dict(tl, attn=tattn), dict(jl, attn=jattn)
        assert set(TL.init_attention(torch.Generator(), cfg_t)) == set(jattn)
    x = np.random.default_rng(2).standard_normal((2, 40, 128)).astype(
        np.float32)
    pos = np.arange(40, dtype=np.int32)[None]
    got = TL.attention_train(tl["attn"], torch.as_tensor(x),
                             torch.as_tensor(pos), cfg_t, window=16)
    want = JL.attention_train(jl["attn"], jnp.asarray(x), jnp.asarray(pos),
                              cfg_j, window=16)
    _close(got, want, 2e-5, 2e-5)


@pytest.mark.parametrize("window", [16, 0])
def test_attention_decode_matches_reference_across_ring_wrap(reduced_init,
                                                            window):
    # 24 one-token steps into a 16-slot cache: a ring with window 16, the
    # last slot rewritten past the end without one; the output and both
    # caches at every step, f32, rtol/atol 2e-5
    jp, tp = reduced_init
    cfg_t, cfg_j = configs.get_reduced(ARCH), jget_reduced(ARCH)
    tl, jl = _layer(tp, jp, "period_attn", 0)
    rng = np.random.default_rng(4)
    shape = (2, 16, cfg_t.n_kv_heads, cfg_t.hd)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    step = jax.jit(JL.attention_decode, static_argnames=("cfg", "window"))
    for pos in range(24):
        x = rng.standard_normal((2, 1, 128)).astype(np.float32)
        tk_in, tk_copy = tk, tk.clone()
        ty, tk, tv = TL.attention_decode(tl["attn"], torch.as_tensor(x), pos,
                                         tk, tv, cfg_t, window=window)
        jy, jk, jv = step(jl["attn"], jnp.asarray(x), pos, jk, jv,
                          cfg=cfg_j, window=window)
        assert torch.equal(tk_in, tk_copy)     # the input cache is kept
        for got, want in ((ty, jy), (tk, jk), (tv, jv)):
            _close(got, want, 2e-5, 2e-5, f"pos {pos}")


def test_causal_conv1d_gates_and_recurrent_block_match_reference(
        reduced_init):
    jp, tp = reduced_init
    cfg_t, cfg_j = configs.get_reduced(ARCH), jget_reduced(ARCH)
    tl, jl = _layer(tp, jp, "period_lru", 0, 1)
    tr, jr = tl["rec"], jl["rec"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 128)).astype(np.float32)
    st = rng.standard_normal((2, 3, 128)).astype(np.float32)
    # the conv and its state: the same products summed in the same order
    for state in (None, st):
        got, gs = thybrid._causal_conv1d(
            torch.as_tensor(x), tr["conv_w"],
            None if state is None else torch.as_tensor(state))
        want, ws = jhybrid._causal_conv1d(
            jnp.asarray(x), jr["conv_w"],
            None if state is None else jnp.asarray(state))
        _close(got, want, 1e-6, 1e-6)
        _close(gs, ws, 0, 0)
    # gates: (W, W) products in f32, then softplus / exp / sqrt: 1e-5
    ga, gb = thybrid._rglru_gates(tr, torch.as_tensor(x))
    wa, wb = jhybrid._rglru_gates(jr, jnp.asarray(x))
    assert ga.dtype == gb.dtype == torch.float32
    _close(ga, wa, 1e-5, 1e-6)
    _close(gb, wb, 1e-5, 1e-5)
    # the whole block: the port's sequential recurrence against the
    # reference's associative scan, through three products: 2e-5
    got, _ = thybrid.recurrent_block(tr, torch.as_tensor(x), cfg_t)
    want, _ = jhybrid.recurrent_block(jr, jnp.asarray(x), cfg_j)
    _close(got, want, 2e-5, 2e-5)
    # one decode step from a state, and rglru_step on its own
    h0 = rng.standard_normal((2, 128)).astype(np.float32)
    x1 = x[:, :1]
    got, (gh, gc) = thybrid.recurrent_block(
        tr, torch.as_tensor(x1), cfg_t, (torch.as_tensor(h0),
                                         torch.as_tensor(st)))
    want, (wh, wc) = jhybrid.recurrent_block(
        jr, jnp.asarray(x1), cfg_j, (jnp.asarray(h0), jnp.asarray(st)))
    _close(got, want, 2e-5, 2e-5)
    _close(gh, wh, 1e-5, 1e-5)
    _close(gc, wc, 1e-5, 1e-6)
    ys, hs = thybrid.rglru_step(tr, torch.as_tensor(x1), torch.as_tensor(h0))
    yj, hj = jhybrid.rglru_step(jr, jnp.asarray(x1), jnp.asarray(h0))
    _close(ys, yj, 1e-5, 1e-5)
    _close(hs, hj, 1e-5, 1e-5)
    # rglru_scan with h0 folds a_0 * h0 into b_0 (hybrid.py:69)
    _close(thybrid.rglru_scan(tr, torch.as_tensor(x), torch.as_tensor(h0)),
           jhybrid.rglru_scan(jr, jnp.asarray(x), jnp.asarray(h0)),
           2e-5, 2e-5)


# ---------------------------------------------------------------------------
# the whole reduced model: forward, prefill, loss, decode across a wrap
# ---------------------------------------------------------------------------
# f32: matmul and scan sum orders differ from XLA's through 5 layers
# (measured max 7.3e-6 on logits, 5.6e-6 on caches): rtol/atol 5e-5.
# bf16: XLA computes the fused elementwise chains (gelu, sigmoid + bias)
# in f32 where torch rounds each op to bf16, and the port's attention
# keeps scores and probabilities in f32 where the reference's gqa_attend
# rounds them to bf16; 1-ulp differences (2^-8 relative) grow through 5
# layers (measured: max 0.14 on logits of scale ~4, relative L2 error
# 3.2%; caches 0.12 and 2.8%).  Elementwise rtol cannot bound values near
# zero, so bf16 is held to max |diff| <= 0.25 and a relative L2 error
# <= 6%, and the loss to 1e-2.
TOL = {"float32": dict(atol=5e-5, rtol=5e-5, loss=1e-5),
       "bfloat16": dict(atol=0.25, rel_l2=0.06, loss=1e-2)}


def _check(got, want, tol, msg=""):
    if "rtol" in tol:
        _close(got, want, tol["rtol"], tol["atol"], msg)
        return
    g, w = _t2np(got), _np(want)
    err = np.abs(g - w).max()
    rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    assert err <= tol["atol"] and rel <= tol["rel_l2"], (msg, err, rel)


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_reduced_model_matches_reference(reduced_init, cdtype):
    jp, tp = reduced_init
    cfg_t = configs.get_reduced(ARCH).replace(compute_dtype=cdtype)
    cfg_j = jget_reduced(ARCH).replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg_t.vocab, size=(2, 40)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    tt = torch.as_tensor(tokens).long()
    tbatch = {"tokens": tt, "labels": torch.as_tensor(labels).long()}
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}

    fwd = jax.jit(jhybrid.forward_train, static_argnums=(2,))
    got = thybrid.forward_train(tp, tt, cfg_t)
    assert got.dtype == cfg_t.cdtype and got.shape == (2, 40, cfg_t.vocab)
    _check(got, fwd(jp, jbatch["tokens"], cfg_j), tol)
    pre = models.prefill_logits(tp, tbatch, cfg_t)
    assert pre.shape == (2, 1, cfg_t.vocab)
    _check(pre, jprefill_logits(jp, jbatch, cfg_j), tol)
    _close(thybrid.loss_fn(tp, tbatch, cfg_t),
           jhybrid.loss_fn(jp, jbatch, cfg_j), tol["loss"], tol["loss"])

    # 24 decode steps into a 16-slot ring (window 16): logits and every
    # cache leaf at every step
    tc = thybrid.init_cache(cfg_t, 2, 40, device="cpu")
    jc = jhybrid.init_cache(cfg_j, 2, 40)
    assert tc["p_k"].shape[2] == 16
    step = jax.jit(jhybrid.decode_step, static_argnums=(4,))
    for pos in range(24):
        tok = tokens[:, pos:pos + 1]
        tl, tc = thybrid.decode_step(tp, tc, torch.as_tensor(tok).long(), pos,
                                     cfg_t)
        jl, jc = step(jp, jc, jnp.asarray(tok), pos, cfg_j)
        _check(tl, jl, tol, f"logits pos {pos}")
        assert set(tc) == set(jc)
        for name in tc:
            assert tc[name].dtype == (torch.float32 if name.endswith("_h")
                                      else cfg_t.cdtype), name
            _check(tc[name], jc[name], tol, f"{name} pos {pos}")


def _attend_rounded_as_reference(q, k, v, *, window=0, scale=None):
    """A test-only twin of the port's `attend_auto` that rounds scores and
    probabilities to the compute dtype, as the reference's `gqa_attend`
    does (the port's own `gqa_attend`, under the causal band mask)."""
    mask = TL.causal_mask(q.shape[1], k.shape[1], window, device=q.device)
    return TL.gqa_attend(q, k, v, mask, scale)


def _bf16_errors(tp, jp, tt, tbatch, jtokens, jbatch, cfg_t, cfg_j):
    """(max |diff|, relative L2) of the forward and the prefill logits."""
    out = {}
    fwd = jax.jit(jhybrid.forward_train, static_argnums=(2,))
    for name, got, want in (
            ("logits", thybrid.forward_train(tp, tt, cfg_t),
             fwd(jp, jtokens, cfg_j)),
            ("prefill", models.prefill_logits(tp, tbatch, cfg_t),
             jprefill_logits(jp, jbatch, cfg_j))):
        g, w = _t2np(got), _np(want)
        out[name] = (float(np.abs(g - w).max()),
                     float(np.linalg.norm(g - w) / np.linalg.norm(w)))
    return out


def test_reduced_bf16_gap_is_not_the_attention_rounding(reduced_init,
                                                        monkeypatch):
    # How the bf16 gap to the reference splits.  The port's attention keeps
    # scores and probabilities in f32; the reference's gqa_attend rounds
    # them to bf16.  Swapping in a twin that rounds as the reference does
    # leaves the gap where it was (jax 0.9.0, torch 2.13 on the CPU, the
    # inputs of test_reduced_model_matches_reference):
    #   port attention: logits max 0.125, rel L2 2.64%; prefill 0.125, 3.15%
    #   rounded twin:   logits max 0.125, rel L2 2.65%; prefill 0.125, 3.03%
    # (decode already goes through gqa_attend on both sides.)  So the gap
    # is XLA's fused f32 elementwise chains (gelu, sigmoid + bias, norms),
    # which torch rounds to bf16 op by op, not the attention.  The bf16
    # bound of TOL is not tightened to these numbers: what XLA fuses
    # changes with the jax version (CI pins 0.4.37, measured here on
    # 0.9.0), and the bound has to hold on both.
    jp, tp = reduced_init
    cfg_t = configs.get_reduced(ARCH).replace(compute_dtype="bfloat16")
    cfg_j = jget_reduced(ARCH).replace(compute_dtype="bfloat16")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg_t.vocab, size=(2, 40)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    tt = torch.as_tensor(tokens).long()
    tbatch = {"tokens": tt, "labels": torch.as_tensor(labels).long()}
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    args = (tp, jp, tt, tbatch, jbatch["tokens"], jbatch, cfg_t, cfg_j)
    port = _bf16_errors(*args)
    monkeypatch.setattr(TL, "attend_auto", _attend_rounded_as_reference)
    twin = _bf16_errors(*args)
    bf = TOL["bfloat16"]
    for name in ("logits", "prefill"):
        for err, rel in (port[name], twin[name]):
            assert err <= bf["atol"] and rel <= bf["rel_l2"], (name, err, rel)
        # the twin runs other arithmetic (its outputs differ) but closes
        # less than a fifth of the relative gap
        assert twin[name] != port[name]
        assert twin[name][1] >= 0.8 * port[name][1], (name, port, twin)
