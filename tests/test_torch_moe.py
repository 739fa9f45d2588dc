"""Port parity for the mixture-of-experts LM family on the CPU:
deepseek-moe-16b (GQA attention, fine-grained experts) and
deepseek-v2-236b (MLA).  The configs field by field, the full-width init
trees against `jax.eval_shape` of the reference's (shapes only), the
converter on the nested moe tree, the sort-based capacity dispatch
against `_moe_ffn_dispatch` / `moe_ffn` (routes, capacity drops, the
chunk loop, aux), and the `reduced()` models from the reference's init on
the same numpy inputs: forward, prefill, loss, gradients and 8 decode
steps, in f32 and bf16, and one Regime-B resident round through
`launch.train.Trainer`.

Top-k routing is discontinuous: in f32 the port's expert ids equal the
reference's, layer by layer; in bf16 a route may flip where two router
probabilities nearly tie, and such tokens are counted (the count is
asserted to be a small share), while the outputs are held to the LM bf16
bound on a run given the reference's routes.  The reference runs with
XLA's excess precision off (EXACT, below).  GQA attention in the forward runs `flash_attention`'s plain
version here; MLA always takes the plain attention."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import prefill_logits as jprefill_logits
from repro.spec import make_algo_spec as jmake_spec
from repro_torch import configs, convert, models, tree
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)
MOE = ("deepseek-moe-16b", "deepseek-v2-236b")
# leaves of the reference's full-width init (jax.eval_shape of
# repro.models.moe.init_params)
LEAVES = {"deepseek-moe-16b": 16_377_694_208,
          "deepseek-v2-236b": 235_741_434_880}
# as tests/test_torch_dense.py: f32 sum orders differ (XLA vs torch); bf16
# the port's LM bound against the reference (max |diff|, relative L2)
TOL = {"float32": dict(atol=5e-5, rtol=5e-5, loss=1e-5),
       "bfloat16": dict(atol=0.25, rel_l2=0.06, loss=1e-2)}
# bf16 route flips: at most this share of (token, layer) routes
FLIP_SHARE = 0.05


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


def flipped(a, b) -> int:
    """Tokens whose set of experts differs between two (T, K) routings."""
    a, b = np.sort(np.asarray(a), -1), np.sort(np.asarray(b), -1)
    return int((a != b).any(-1).sum())


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", MOE)
def test_config_equals_reference_field_by_field(arch, which):
    if which == "full":
        tc, jc = configs.get_config(arch), jconfigs.get_config(arch)
    else:
        tc, jc = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    assert tf == jf
    assert tc.param_count() == jc.param_count()
    assert tc.param_count(active_only=True) == jc.param_count(
        active_only=True)
    api = models.get_model(tc)
    assert api.decode_step is tmoe.decode_step
    assert api.init_cache is tmoe.init_cache


def test_full_width_attention_shapes():
    # what the attention sees at full width: deepseek-moe-16b's GQA (H,
    # Hkv, hd) is the flash kernel's hd 128 at a group of 1; MLA's QK
    # head dim 192 against V's 128 takes the plain route
    moe16 = configs.get_config("deepseek-moe-16b")
    assert (moe16.n_heads, moe16.n_kv_heads, moe16.hd, moe16.kv_lora) == \
        (16, 16, 128, 0)
    v2 = configs.get_config("deepseek-v2-236b")
    assert (v2.nope_head_dim + v2.rope_head_dim, v2.v_head_dim) == (192, 128)
    r = configs.get_reduced("deepseek-v2-236b")
    assert (r.nope_head_dim + r.rope_head_dim, r.v_head_dim) == (24, 16)


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_full_width_init_tree_matches_reference(arch):
    # shapes only: the reference's init through jax.eval_shape, the port's
    # under FakeTensorMode (no memory behind either)
    jc, tc = jconfigs.get_config(arch), configs.get_config(arch)
    shapes = jax.eval_shape(lambda k: jmoe.init_params(k, jc),
                            jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with FakeTensorMode():
        own = tmoe.init_params(torch.Generator(), tc, device="cpu")
        got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in _paths(own)}
    assert got == want
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert n == LEAVES[arch]
    assert got[("moe_layers", "moe", "router")][1] == "float32"


@functools.lru_cache(maxsize=None)
def _reference_init(arch, **replace):
    """The reference's init of reduced() (with `replace`) as numpy, its
    conversion, and both configs."""
    cfg_j = jconfigs.get_reduced(arch).replace(**replace)
    cfg_t = configs.get_reduced(arch).replace(**replace)
    init = jax.jit(jmoe.init_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg_j))
    return jp, convert.params_from_reference(jp), cfg_j, cfg_t


@pytest.mark.parametrize("arch", MOE)
def test_params_from_reference_carries_the_moe_tree(arch):
    # the converter carries the nested moe / shared dicts, the stacked
    # dense_layers / moe_layers and the MLA leaves unchanged; the port's
    # own init has the same structure and dtypes
    jp, tp, _, cfg_t = _reference_init(arch)
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jpaths) == len(list(_paths(tp)))
    for path, leaf in jpaths:
        t = tree.get(tp, tuple(k.key for k in path))
        assert tuple(t.shape) == leaf.shape and np.array_equal(
            t.numpy(), leaf), path
    assert set(tp["moe_layers"]["moe"]["shared"]) == {"wg", "wu", "wd"}
    mla = {"wkv_a", "kv_norm", "wkv_b", "wo", "wq_a", "q_norm", "wq_b"}
    assert (set(tp["moe_layers"]["attn"]) == mla) == bool(cfg_t.kv_lora)
    own = tmoe.init_params(torch.Generator().manual_seed(0), cfg_t,
                           device="cpu")
    assert {p: (tuple(v.shape), v.dtype) for p, v in _paths(own)} == \
        {p: (tuple(v.shape), v.dtype) for p, v in _paths(tp)}


@pytest.mark.parametrize("arch", MOE)
def test_params_from_reference_carries_the_cache(arch):
    jp, _, cfg_j, cfg_t = _reference_init(arch)
    jc = jax.tree.map(np.asarray, jmoe.init_cache(cfg_j, 2, 24))
    tc = convert.params_from_reference(jc)
    own = tmoe.init_cache(cfg_t, 2, 24, device="cpu")
    keys = {"c", "r"} if cfg_t.kv_lora else {"k", "v"}
    for part in ("dense", "moe"):
        assert set(tc[part]) == set(own[part]) == keys
        for name in keys:
            assert tc[part][name].shape == own[part][name].shape
            assert tc[part][name].dtype == own[part][name].dtype


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------
# (capacity_factor, moe_seq_chunk, compute dtype): the default capacity,
# drops under a small capacity, the chunk loop (S 48 in chunks of 16), both
DISPATCH = {"plain": (1.25, 4096, "float32"),
            "drops": (0.5, 4096, "float32"),
            "chunks": (1.25, 16, "float32"),
            "drops_chunks": (0.3, 16, "float32"),
            "bf16": (1.25, 4096, "bfloat16"),
            "bf16_drops_chunks": (0.3, 16, "bfloat16")}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_matches_reference(case):
    cf, ch, cdtype = DISPATCH[case]
    jp, tp, cfg_j, cfg_t = _reference_init("deepseek-moe-16b")
    rep = dict(capacity_factor=cf, moe_seq_chunk=ch, compute_dtype=cdtype)
    cfg_j, cfg_t = cfg_j.replace(**rep), cfg_t.replace(**rep)
    pj = jax.tree.map(lambda a: a[0], jp["moe_layers"]["moe"])
    pt = tree.tree_map(lambda a: a[0], tp["moe_layers"]["moe"])
    B, S, D = 2, 48, cfg_t.d_model
    x = np.random.default_rng(4).standard_normal((B, S, D)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(cfg_j.cdtype)
    xt = torch.as_tensor(x).to(cfg_t.cdtype)
    routes = []
    y, aux = tmoe.moe_ffn(pt, xt, cfg_t, routes)
    yj, auxj = jax.jit(jmoe.moe_ffn, static_argnums=(2,))(pj, xj, cfg_j)
    assert y.dtype == cfg_t.cdtype and y.shape == (B, S, D)
    n = S // ch if S > ch else 1
    assert len(routes) == n
    T = B * S // n
    C = tmoe._capacity(T, cfg_t)
    assert C == jmoe._capacity(T, cfg_j)
    # the reference's routes and drops, chunk by chunk
    xr = x.reshape(B, n, S // n, D).transpose(1, 0, 2, 3)
    dropped = 0
    for i, got in enumerate(routes):
        xc = jnp.asarray(xr[i].reshape(T, D)).astype(cfg_j.cdtype)
        probs = jax.nn.softmax(xc.astype(jnp.float32) @ pj["router"], -1)
        want = np.asarray(jax.lax.top_k(probs, cfg_j.top_k)[1])
        load = np.bincount(want.reshape(-1), minlength=cfg_t.n_experts)
        dropped += int(np.maximum(load - C, 0).sum())
        if cdtype == "float32":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert flipped(got, want) <= FLIP_SHARE * T, i
    assert (dropped > 0) == ("drops" in case), dropped
    _check(y, yj, TOL[cdtype], f"{case} y")
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-5)


def test_dispatch_rerun_is_bitwise():
    # the combine's fixed order: the same inputs give the same bits
    _, tp, _, cfg = _reference_init("deepseek-moe-16b")
    cfg = cfg.replace(compute_dtype="bfloat16", capacity_factor=0.5)
    p = tree.tree_map(lambda a: a[0], tp["moe_layers"]["moe"])
    x = torch.randn((2, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    a, _ = tmoe.moe_ffn(p, x, cfg)
    b, _ = tmoe.moe_ffn(p, x, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("cf", [1.25, 0.3])
def test_dispatch_buffer_is_the_reference_scatter_add(cf):
    # writing the kept tokens only is the reference's scatter-add of every
    # pair's token times keep into slot min(pos, C-1), bitwise in bf16:
    # each row gets one kept token and exact zeros (0.3: with drops)
    T, E, K, D = 96, 8, 3, 16
    g = torch.Generator().manual_seed(int(cf * 100))
    topi = torch.argsort(torch.rand((T, E), generator=g), dim=1)[:, :K]
    xt = torch.randn((T, D), generator=g).bfloat16()
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], torch.arange(T).repeat_interleave(K)[order]
    pos = torch.arange(T * K) - torch.searchsorted(se, torch.arange(E))[se]
    C = max(8, -(-int(np.ceil(T * K * cf / E)) // 8) * 8)
    got = tmoe.dispatch(xt, se, st, pos, E, C)
    keep = (pos < C).to(xt.dtype)
    slot = np.minimum(pos.numpy(), C - 1)
    want = jnp.zeros((E, C, D), jnp.bfloat16).at[se.numpy(), slot].add(
        jnp.asarray((xt[st] * keep[:, None]).float().numpy()).astype(
            jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    assert (pos >= C).any() == (cf < 1)


@pytest.mark.parametrize("K", [2, 6])
def test_combine_adds_in_the_reference_scatter_order(K):
    # the combine against the reference's own scatter-add of the sorted
    # contributions, bf16 bitwise: each token's K values are added from
    # zero in ascending expert order, as XLA's sequential scatter on the
    # CPU applies them (with K 6 another order rounds differently)
    T, E, D = 96, 64, 32
    g = torch.Generator().manual_seed(K)
    topi = torch.argsort(torch.rand((T, E), generator=g), dim=1)[:, :K]
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    st = torch.arange(T).repeat_interleave(K)[order]
    vals = torch.randn((T * K, D), generator=g).bfloat16()
    got = tmoe.combine(vals, order, topi)
    want = jnp.zeros((T, D), jnp.bfloat16).at[jnp.asarray(st.numpy())].add(
        jnp.asarray(vals.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    # a fixed other order (descending expert) is not the same sum
    if K == 6:
        alt = tmoe.combine(vals, order, -topi)
        assert not torch.equal(alt, got)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=40, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return ({"tokens": torch.as_tensor(tokens).long(),
             "labels": torch.as_tensor(labels).long()},
            {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})


# The reference's runs are compiled with XLA's excess precision off, so
# that they round at every bf16 cast their code writes, as the port does.
# With it on (XLA's default), the CPU's fusions keep f32 between some of
# those casts; in the reduced deepseek-v2-236b, whose MLA softmax is nearly
# one-hot (wq_b / wkv_b draw with the fan-in H = 4), that alone moves its
# bf16 gradients from the port's by up to 15% in relative L2 (5.8% with
# it off).  f32 runs are the same either way.
EXACT = {"xla_allow_excess_precision": False}


def _reference_run(fn, *args):
    """fn(*args) of the reference, jitted with EXACT, and the (T, K)
    expert ids of every dispatch that run took, in order (recorded from
    its own program through jax.debug.callback)."""
    got = []
    real = jmoe._moe_ffn_dispatch

    def recording(p, x, cfg):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        topi = jax.lax.top_k(jax.nn.softmax(xt @ p["router"], -1),
                             cfg.top_k)[1]
        jax.debug.callback(lambda t: got.append(np.asarray(t)), topi)
        return real(p, x, cfg)

    jmoe._moe_ffn_dispatch = recording
    try:
        # a new function each call: a fresh trace through `recording`
        out = jax.block_until_ready(jax.jit(lambda *a: fn(*a),
                                            compiler_options=EXACT)(*args))
    finally:
        jmoe._moe_ffn_dispatch = real
    return out, got


def _given(cdtype, own, ref):
    """The port's own routes against the reference's, dispatch by
    dispatch: equal in f32 (-> None: the port's run is the comparison);
    in bf16 the flipped tokens counted, at most FLIP_SHARE of them, and
    the reference's routes handed back for the comparison run (`given`),
    so that a flip does not move the outputs compared."""
    assert len(own) == len(ref) > 0
    if cdtype == "float32":
        for a, b in zip(own, ref):
            np.testing.assert_array_equal(a.numpy(), b)
        return None
    flips = sum(flipped(a, b) for a, b in zip(own, ref))
    assert flips <= FLIP_SHARE * sum(len(r) for r in ref), flips
    return iter([torch.tensor(r) for r in ref])


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_reduced_model_matches_reference(arch, cdtype):
    jp, tp, cfg_j, cfg_t = _reference_init(arch)
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t)
    tokens = tbatch["tokens"]
    (want, jaux), jr = _reference_run(
        lambda p, t: jmoe.forward_train(p, t, cfg_j), jp, jbatch["tokens"])
    own = []
    got, aux = tmoe.forward_train(tp, tokens, cfg_t, routes=own)
    assert len(own) == cfg_t.n_layers - 1
    given = _given(cdtype, own, jr)
    if given is not None:
        got, aux = tmoe.forward_train(tp, tokens, cfg_t, given=given)
    assert got.dtype == cfg_t.cdtype and got.shape == (2, 40, cfg_t.vocab)
    assert aux.dtype == torch.float32 and aux.shape == ()
    _check(got, want, tol, "logits")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=tol["loss"])
    jpre, jr = _reference_run(lambda p, b: jprefill_logits(p, b, cfg_j), jp,
                              jbatch)
    given = _given(cdtype, own, jr)
    pre = (models.prefill_logits(tp, tbatch, cfg_t) if given is None else
           tmoe.forward_train(tp, tokens, cfg_t, last_only=True,
                              given=given)[0])
    assert pre.shape == (2, 1, cfg_t.vocab)
    _check(pre, jpre, tol, "prefill")
    jloss, jr = _reference_run(lambda p, b: jmoe.loss_fn(p, b, cfg_j), jp,
                               jbatch)
    given = _given(cdtype, own, jr)
    loss = (models.get_model(cfg_t).loss_fn(tp, tbatch, cfg_t)
            if given is None else tmoe.loss_fn(tp, tbatch, cfg_t, given))
    np.testing.assert_allclose(_t2np(loss), _np(jloss), rtol=tol["loss"],
                               atol=tol["loss"])


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_gradient_matches_reference(arch, cdtype):
    # the port's loss_fn (plain attention, the dispatch, aux) under
    # autograd against jax.grad of the reference's, every leaf: f32 at
    # TOL (the reduced MLA's softmax amplifies the f32 order gaps: up to
    # 4.7e-5 on embed, whose largest entry is 4.3), bf16 to the LM bound
    jp, tp, cfg_j, cfg_t = _reference_init(arch)
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t, seed=3)
    jg, jr = _reference_run(lambda p, b: jax.grad(jmoe.loss_fn)(p, b, cfg_j),
                            jp, jbatch)
    own = []
    tmoe.forward_train(tp, tbatch["tokens"], cfg_t, route="plain",
                       routes=own)
    given = _given(cdtype, own, jr)
    tg = torch.func.grad(tmoe.loss_fn)(tp, tbatch, cfg_t, given)
    for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]:
        got = tree.get(tg, tuple(k.key for k in p))
        _check(got, x, tol, str(p))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_reference(arch, cdtype):
    # 8 steps: logits every step, every cache leaf at the end (MLA's
    # compressed c / r, GQA's k / v); bf16 on the reference's routes, the
    # flips of the port's own counted over the 8 steps
    jp, tp, cfg_j, cfg_t = _reference_init(arch)
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    tokens = np.random.default_rng(7).integers(0, cfg_t.vocab, (2, 8))
    tc = models.get_model(cfg_t).init_cache(cfg_t, 2, 12, device="cpu")
    jc = jmoe.init_cache(cfg_j, 2, 12)
    own_all, ref_all = [], []
    for pos in range(8):
        tok = tokens[:, pos:pos + 1]
        (jl, jc), jr = _reference_run(
            lambda p, c, t: jmoe.decode_step(p, c, t, pos, cfg_j), jp, jc,
            jnp.asarray(tok, jnp.int32))
        own = []
        tl, new = tmoe.decode_step(tp, tc, torch.as_tensor(tok).long(), pos,
                                   cfg_t, routes=own)
        if cdtype == "bfloat16":
            tl, new = tmoe.decode_step(tp, tc, torch.as_tensor(tok).long(),
                                       pos, cfg_t, given=iter(
                                           [torch.tensor(r) for r in jr]))
        tc = new
        own_all += own
        ref_all += jr
        assert tl.shape == (2, 1, cfg_t.vocab) and tl.dtype == cfg_t.cdtype
        _check(tl, jl, tol, f"logits pos {pos}")
    _given(cdtype, own_all, ref_all)
    for part in ("dense", "moe"):
        assert set(tc[part]) == set(jc[part])
        for name in tc[part]:
            assert tc[part][name].dtype == cfg_t.cdtype
            _check(tc[part][name], jc[part][name], tol, f"{part}/{name}")


def test_decode_does_not_modify_the_cache_passed_in():
    _, tp, _, cfg = _reference_init("deepseek-v2-236b")
    cache = tmoe.init_cache(cfg, 2, 12, device="cpu")
    before = tree.tree_map(lambda t: t.clone(), cache)
    _, new = tmoe.decode_step(tp, cache, torch.ones((2, 1),
                                                    dtype=torch.long), 3, cfg)
    for p, t in tree.paths(cache):
        assert torch.equal(t, tree.get(before, p))
        assert not torch.equal(tree.get(new, p), t)


@pytest.mark.parametrize("arch", MOE)
def test_attention_routes_follow_the_config(arch, monkeypatch):
    # the kernel route reaches ops.flash_attention once per GQA layer;
    # MLA (kv_lora > 0) never does, on either route, and the plain route
    # never does
    _, tp, _, cfg = _reference_init(arch)
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    tbatch, _ = _batch(cfg)
    tmoe.forward_train(tp, tbatch["tokens"], cfg)
    assert len(calls) == (0 if cfg.kv_lora else cfg.n_layers)
    calls.clear()
    tmoe.forward_train(tp, tbatch["tokens"], cfg, route="plain")
    assert not calls
    with pytest.raises(ValueError, match="route"):
        tmoe.forward_train(tp, tbatch["tokens"], cfg, route="auto")


# ---------------------------------------------------------------------------
# Regime B
# ---------------------------------------------------------------------------
M = 4


def _trainer_round(arch, seq=24):
    """One resident round of `launch.train.Trainer` (ring topology, whose
    tables are the same on both sides) from the reference's stacked init,
    against the reference's `build_train_algo` round on the same batches.
    -> (port state, reference state)."""
    ap = ttrain.build_parser()
    args = ap.parse_args(["--arch", arch, "--reduced", "--clients", str(M),
                          "--batch", "2", "--seq", str(seq), "--resident",
                          "--topology", "ring", "--device", "cpu"])
    run = ttrain.Trainer(args, ap)
    cfg_j = jconfigs.get_reduced(arch)
    spec = jmake_spec("dfedpgp", topology="ring", n_neighbors=2, seed=0,
                      gossip="matrix", resident=True)
    lay = jsteps.Layout(("data",), (), ("model",), (), M, 2)
    ja, _, _, jfl = jsteps.build_train_algo(cfg_j, None, lay, spec=spec,
                                            lr=0.02)
    stacked = jax.vmap(lambda k: jmoe.init_params(k, cfg_j))(
        jax.random.split(jax.random.PRNGKey(0), M))
    sj, jfl = ja.init_flat(stacked, jfl)
    run.state = convert.flat_state_from_reference(
        flat=np.asarray(sj.flat), personal=jax.tree.map(np.asarray,
                                                        sj.personal),
        mu=np.asarray(sj.mu), mom_u=np.asarray(sj.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, sj.opt_v.momentum),
        round=np.asarray(sj.round))
    Pj = spec.schedule(M).at(0)
    P, _ = run.topology(0)
    np.testing.assert_array_equal(P.idx.numpy(), np.asarray(Pj.idx))
    np.testing.assert_array_equal(P.w.numpy(), np.asarray(Pj.w))
    rng = np.random.default_rng(12)
    toks = {k: rng.integers(0, cfg_j.vocab, (M, 1, 2, seq)).astype(np.int32)
            for k in "vu"}
    bj = {k: {"tokens": jnp.asarray(t), "labels": jnp.asarray(
        np.roll(t, -1, -1))} for k, t in toks.items()}
    bt = {k: {"tokens": torch.as_tensor(t).long(), "labels": torch.as_tensor(
        np.roll(t, -1, -1)).long()} for k, t in toks.items()}
    mt, _, _ = run.step(0, bt)
    sj, mj = jax.jit(lambda s, P, b: ja.round_fn_flat(s, P, b, jfl))(
        sj, Pj, bj)
    np.testing.assert_allclose(float(mt["loss_u"]), float(mj["loss_u"]),
                               rtol=1e-5)
    return run.state, sj


@pytest.mark.parametrize("arch", MOE)
def test_trainer_resident_round_matches_reference(arch):
    # every state leaf at the Regime-B tolerance (rtol 1e-4, atol 2e-5,
    # tests/test_torch_regime_b.py) but the momentum: after one round it is
    # the round's gradient, held as the gradients above (TOL; the reduced
    # MLA's reaches 2.3e-5 on 1 of 1,245,824 entries)
    st, sj = _trainer_round(arch)
    tol = TOL["float32"]
    np.testing.assert_allclose(st.flat.numpy(), np.asarray(sj.flat),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(st.opt_u.momentum.numpy(),
                               np.asarray(sj.opt_u.momentum),
                               rtol=tol["rtol"], atol=tol["atol"])
    for p, x in jax.tree_util.tree_flatten_with_path(sj.personal)[0]:
        np.testing.assert_allclose(
            tree.get(st.personal, tuple(k.key for k in p)).numpy(),
            np.asarray(x), rtol=1e-4, atol=2e-5, err_msg=str(p))
    np.testing.assert_array_equal(st.mu.numpy(), np.asarray(sj.mu))
