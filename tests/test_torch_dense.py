"""Port parity for the dense decoder-only LM family on the CPU: the four
configs field by field, the arch registry, the full-width init's tree
against `jax.eval_shape` of the reference's, and the `reduced()` models
(forward, prefill, loss, decode across danube's ring wrap, the int8 KV
cache) from the reference's init carried across by `convert`, on the same
numpy inputs, in f32 and bf16.  Also a head dim of 80 and a GQA group of 7
at reduced size, the shapes the full-width models hand the attention
kernel.

Attention in the forward runs `flash_attention`'s plain version here; the
CUDA kernel runs only on a GPU, where `chip_smoke.py` holds it and the
models against these plain versions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.models import dense as jdense
from repro.models import prefill_logits as jprefill_logits
from repro_torch import configs, convert, models, tree
from repro_torch.models import dense as tdense

torch.set_num_threads(2)
DENSE = ("qwen2-0.5b", "h2o-danube-1.8b", "granite-3-2b", "codeqwen1.5-7b")
# leaves of the reference's full-width init (jax.eval_shape of
# repro.models.dense.init_params): lm_head is drawn although two of the
# four configs say tie_embeddings=True
LEAVES = {"qwen2-0.5b": 630_167_424, "h2o-danube-1.8b": 1_831_201_280,
          "granite-3-2b": 2_634_201_088, "codeqwen1.5-7b": 8_190_038_016}
# f32: sum orders differ (XLA vs torch, the plain flash_attention vs
# gqa_attend); bf16: the port's bound against the reference, as for the
# hybrid family (tests/test_torch_hybrid.py): max |diff| and relative L2
TOL = {"float32": dict(atol=5e-5, rtol=5e-5, loss=1e-5),
       "bfloat16": dict(atol=0.25, rel_l2=0.06, loss=1e-2)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t2np(t):
    return t.detach().to(torch.float32).numpy()


def _check(got, want, tol, msg=""):
    if "rtol" in tol:
        np.testing.assert_allclose(_t2np(got), _np(want), rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=msg)
        return
    g, w = _t2np(got), _np(want)
    err = np.abs(g - w).max()
    rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    assert err <= tol["atol"] and rel <= tol["rel_l2"], (msg, err, rel)


def _paths(t, prefix=()):
    for key in sorted(t):
        if isinstance(t[key], dict):
            yield from _paths(t[key], prefix + (key,))
        else:
            yield prefix + (key,), t[key]


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", DENSE)
def test_config_equals_reference_field_by_field(arch, which):
    if which == "full":
        tc, jc = configs.get_config(arch), jconfigs.get_config(arch)
    else:
        tc, jc = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    assert tf == jf
    assert tc.hd == jc.hd and tc.param_count() == jc.param_count()
    assert str(tc.pdtype).split(".")[-1] == str(jc.pdtype)
    assert str(tc.cdtype).split(".")[-1] == str(jc.cdtype)
    assert models.get_model(tc).decode_step is tdense.decode_step


def test_full_width_head_shapes():
    # what the attention kernel sees at full width: (H, Hkv, hd)
    got = {a: (configs.get_config(a).n_heads, configs.get_config(a).n_kv_heads,
               configs.get_config(a).hd) for a in DENSE}
    assert got == {"qwen2-0.5b": (14, 2, 64), "h2o-danube-1.8b": (32, 8, 80),
                   "granite-3-2b": (32, 8, 64),
                   "codeqwen1.5-7b": (32, 32, 128)}
    assert configs.get_config("h2o-danube-1.8b").window == 4096


def test_arch_registry_matches_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert set(configs.SHAPES) == set(jconfigs.SHAPES)
    for arch in jconfigs.ARCH_IDS:
        for shape in jconfigs.SHAPES:
            assert configs.shape_applicable(arch, shape) == \
                jconfigs.shape_applicable(arch, shape), (arch, shape)
        family = jconfigs.get_config(arch).family
        if family in ("dense", "hybrid", "moe", "vlm"):
            assert configs.get_config(arch).family == family
        else:
            with pytest.raises(KeyError, match="item 15"):
                configs.get_config(arch)
    # danube is the one dense arch the long_500k decode shape admits
    assert [a for a in DENSE if configs.shape_applicable(a, "long_500k")] \
        == ["h2o-danube-1.8b"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_full_width_init_tree_matches_reference(arch):
    # shapes only: the reference's init through jax.eval_shape, the port's
    # under FakeTensorMode (no memory behind either)
    jc, tc = jconfigs.get_config(arch), configs.get_config(arch)
    shapes = jax.eval_shape(lambda k: jdense.init_params(k, jc),
                            jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with FakeTensorMode():
        own = tdense.init_params(torch.Generator(), tc, device="cpu")
        got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in _paths(own)}
    assert got == want
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert n == LEAVES[arch]
    # init draws lm_head whatever tie_embeddings says: the analytic count
    # is short by one (vocab, d_model) matrix where the config ties, and
    # counts no norm weights or QKV biases
    L, D = tc.n_layers, tc.d_model
    extra = (tc.vocab * D if tc.tie_embeddings else 0) + (2 * L + 1) * D
    if tc.qkv_bias:
        extra += L * (tc.n_heads + 2 * tc.n_kv_heads) * tc.hd
    assert n == tc.param_count() + extra


@functools.lru_cache(maxsize=None)
def _reference_init(arch, **replace):
    """The reference's init of reduced() (with `replace`) as numpy, its
    conversion, and both configs."""
    cfg_j = jconfigs.get_reduced(arch).replace(**replace)
    cfg_t = configs.get_reduced(arch).replace(**replace)
    init = jax.jit(jdense.init_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg_j))
    return jp, convert.params_from_reference(jp), cfg_j, cfg_t


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_reference_carries_the_dense_tree(arch):
    # the converter carries the stacked layers dict and the QKV biases
    # unchanged; the port's own init has the same structure and dtypes
    jp, tp, _, cfg_t = _reference_init(arch)
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jpaths) == len(list(_paths(tp)))
    for path, leaf in jpaths:
        t = tree.get(tp, tuple(k.key for k in path))
        assert tuple(t.shape) == leaf.shape and np.array_equal(
            t.numpy(), leaf), path
    assert ("bq" in tp["layers"]["attn"]) == cfg_t.qkv_bias
    own = tdense.init_params(torch.Generator().manual_seed(0), cfg_t,
                             device="cpu")
    assert {p: (tuple(v.shape), v.dtype) for p, v in _paths(own)} == \
        {p: (tuple(v.shape), v.dtype) for p, v in _paths(tp)}


def test_params_from_reference_carries_the_int8_cache():
    cfg = jconfigs.get_reduced("qwen2-0.5b").replace(kv_quant=True)
    jc = jax.tree.map(np.asarray, jdense.init_cache(cfg, 2, 24))
    tc = convert.params_from_reference(jc)
    own = tdense.init_cache(configs.get_reduced("qwen2-0.5b").replace(
        kv_quant=True), 2, 24, device="cpu")
    assert set(tc) == set(own) == {"k", "v", "k_s", "v_s"}
    for name in own:
        assert tc[name].dtype == own[name].dtype and \
            tc[name].shape == own[name].shape, name
    assert own["k"].dtype == torch.int8 and own["k_s"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=40, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    tt = torch.as_tensor(tokens).long()
    return (tokens, {"tokens": tt, "labels": torch.as_tensor(labels).long()},
            {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})


def _forward_prefill_loss(arch, cdtype, **replace):
    jp, tp, cfg_j, cfg_t = _reference_init(arch, **replace)
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    _, tbatch, jbatch = _batch(cfg_t)
    fwd = jax.jit(jdense.forward_train, static_argnums=(2,))
    got = tdense.forward_train(tp, tbatch["tokens"], cfg_t)
    assert got.dtype == cfg_t.cdtype and got.shape == (2, 40, cfg_t.vocab)
    _check(got, fwd(jp, jbatch["tokens"], cfg_j), tol, "logits")
    pre = models.prefill_logits(tp, tbatch, cfg_t)
    assert pre.shape == (2, 1, cfg_t.vocab)
    _check(pre, jprefill_logits(jp, jbatch, cfg_j), tol, "prefill")
    loss = models.get_model(cfg_t).loss_fn(tp, tbatch, cfg_t)
    np.testing.assert_allclose(_t2np(loss), _np(jdense.loss_fn(jp, jbatch,
                                                               cfg_j)),
                               rtol=tol["loss"], atol=tol["loss"])


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_reduced_model_matches_reference(arch, cdtype):
    # S 40 > danube's window 16: its attention runs the band
    _forward_prefill_loss(arch, cdtype)


# hd 80 (danube's head dim) and a group of 7 query heads per KV head
# (qwen2-0.5b's 14 on 2), at reduced depth and vocabulary
HEAD_CASES = {"hd80": ("h2o-danube-1.8b", dict(d_model=320, n_heads=4,
                                               n_kv_heads=2)),
              "g7": ("qwen2-0.5b", dict(d_model=448, n_heads=14,
                                        n_kv_heads=2))}


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_reduced_model_at_full_width_head_shapes(case, cdtype):
    arch, replace = HEAD_CASES[case]
    cfg = configs.get_reduced(arch).replace(**replace)
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == \
        ((80, 2) if case == "hd80" else (32, 7))
    _forward_prefill_loss(arch, cdtype, **replace)


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference(arch, cdtype):
    # 24 steps; danube's window 16 makes its cache a 16-slot ring, which
    # wraps at step 16.  Logits and every cache leaf at every step
    jp, tp, cfg_j, cfg_t = _reference_init(arch)
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    tokens, _, _ = _batch(cfg_t, S=24, seed=7)
    tc = models.get_model(cfg_t).init_cache(cfg_t, 2, 40, device="cpu")
    jc = jdense.init_cache(cfg_j, 2, 40)
    assert tc["k"].shape == ((2, 2, 16, 2, 32) if arch == "h2o-danube-1.8b"
                             else (2, 2, 40, cfg_t.n_kv_heads, 32))
    step = jax.jit(jdense.decode_step, static_argnums=(4,))
    for pos in range(24):
        tok = tokens[:, pos:pos + 1]
        tl, tc = tdense.decode_step(tp, tc, torch.as_tensor(tok).long(), pos,
                                    cfg_t)
        jl, jc = step(jp, jc, jnp.asarray(tok), pos, cfg_j)
        assert tl.shape == (2, 1, cfg_t.vocab) and tl.dtype == cfg_t.cdtype
        _check(tl, jl, tol, f"logits pos {pos}")
        assert set(tc) == set(jc) == {"k", "v"}
        for name in tc:
            assert tc[name].dtype == cfg_t.cdtype
            _check(tc[name], jc[name], tol, f"{name} pos {pos}")


def test_decode_does_not_modify_the_cache_passed_in():
    _, tp, _, cfg = _reference_init("h2o-danube-1.8b")
    cache = tdense.init_cache(cfg, 2, 40, device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    _, new = tdense.decode_step(tp, cache, torch.zeros((2, 1),
                                                       dtype=torch.long),
                                3, cfg)
    for k in cache:
        assert torch.equal(cache[k], before[k])
        assert not torch.equal(new[k], before[k])


def test_kv_quant_decode_does_not_modify_the_cache_passed_in():
    _, tp, _, cfg = _reference_init("qwen2-0.5b")
    cfg = cfg.replace(kv_quant=True)
    cache = tdense.init_cache(cfg, 2, 40, device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    _, new = tdense.decode_step(tp, cache, torch.ones((2, 1),
                                                      dtype=torch.long),
                                3, cfg)
    assert set(new) == {"k", "v", "k_s", "v_s"}
    for k in cache:
        assert torch.equal(cache[k], before[k])
        assert not torch.equal(new[k], before[k])


def test_quantize_matches_reference_bitwise():
    # the same inputs quantize to the same int8 values and scales, ties
    # x / s = n + 0.5 rounded half to even on both sides
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    x[0, 0, 0, :] = 0.0                                # a zero row: s 1e-8
    x[1, 0, 1, :4] = [127.0, 0.5, 1.5, -2.5]           # s 1: exact ties
    x[1, 0, 1, 4:] = 0.0
    q, s = tdense._quantize(torch.as_tensor(x))
    jq, js = jdense._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[1, 0, 1, :4].tolist() == [127, 0, 2, -2]
    assert float(s[0, 0, 0]) == np.float32(1e-8)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "h2o-danube-1.8b"])
def test_kv_quant_decode_matches_reference(arch):
    # int8 KV cache, f32 compute, 24 steps (danube's ring wraps).  The new
    # key and value of a step come out of matmuls summed in other orders,
    # so x / s can land on the other side of a rounding tie n + 0.5: such
    # an int8 value differs by exactly 1 (counted; at most 0.1% of the
    # written values; measured: qwen2 0, danube 1 of 12,288).  Everything
    # else is exact.  Scales: layer 0's at rtol 1e-6 (measured 3.4e-7);
    # layer 1's keys and values come from layer 0's output, which carries
    # the f32 gap of the whole layer, so its scales are held to the
    # model's f32 rtol 5e-5 (measured 1.6e-6).  Logits to 1e-4 until the
    # first flip; a flipped value moves its key by one step s (about 1% of
    # the head's largest entry), so from then on to 5e-3 (measured 1.5e-3)
    jp, tp, cfg_j, cfg_t = _reference_init(arch)
    cfg_j, cfg_t = cfg_j.replace(kv_quant=True), cfg_t.replace(kv_quant=True)
    tokens, _, _ = _batch(cfg_t, S=24, seed=8)
    tc = models.get_model(cfg_t).init_cache(cfg_t, 2, 40, device="cpu")
    jc = jdense.init_cache(cfg_j, 2, 40)
    step = jax.jit(jdense.decode_step, static_argnums=(4,))
    flips = 0
    written = 0
    for pos in range(24):
        tok = tokens[:, pos:pos + 1]
        tl, tc = tdense.decode_step(tp, tc, torch.as_tensor(tok).long(), pos,
                                    cfg_t)
        jl, jc = step(jp, jc, jnp.asarray(tok), pos, cfg_j)
        assert set(tc) == set(jc) == {"k", "v", "k_s", "v_s"}
        for name in ("k_s", "v_s"):
            got, want = tc[name].numpy(), np.asarray(jc[name])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0,
                                       err_msg=f"{name} layer 0 pos {pos}")
            np.testing.assert_allclose(got[1:], want[1:], rtol=5e-5, atol=0,
                                       err_msg=f"{name} pos {pos}")
        slot = pos % 16 if cfg_t.window else pos
        for name in ("k", "v"):
            assert tc[name].dtype == torch.int8
            diff = np.abs(tc[name].numpy().astype(np.int32)
                          - np.asarray(jc[name]).astype(np.int32))
            assert diff.max() <= 1, (name, pos)
            flips += int(diff[:, :, slot].sum())
            written += diff[:, :, slot].size
        tol = 5e-3 if flips else 1e-4
        np.testing.assert_allclose(_t2np(tl), _np(jl), rtol=tol, atol=tol,
                                   err_msg=f"logits pos {pos}, {flips} flips")
    assert flips <= written // 1000, (flips, written)
