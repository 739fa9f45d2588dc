"""Port parity for the xLSTM family (xlstm-125m: sLSTM + chunkwise mLSTM)
on the CPU.  The configs field by field, the full-width init tree against
`jax.eval_shape` of the reference's (shapes and dtypes: a Python list of
12 differently shaped layer dicts), the converter on the list tree and
the list-of-tuples cache, the blocks' parts against the reference
(`group_norm`, `_causal_conv`, `mlstm_chunkwise` over several chunks,
`mlstm_step`, the sLSTM cell), and the `reduced()` model from the
reference's init on the same numpy inputs: forward, prefill, loss,
gradients and 8 decode steps in f32 and bf16.  The list tree's leaf order
is the reference's: the flat resident row bitwise, checkpoints in both
directions.  One Regime-B resident round through `launch.train.Trainer`
against the reference trainer's round.

The family has no attention and no TPU kernel on its path: the forward's
route changes nothing.  `reduced()` runs S 32 in chunks of 16."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.launch import steps as jsteps
from repro.models import prefill_logits as jprefill_logits
from repro.models import ssm as jssm
from repro.spec import make_algo_spec as jmake_spec
from repro_torch import checkpoint as tckpt
from repro_torch import configs, convert, models, tree
from repro_torch.core import partition as tpartition
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import ssm as tssm
from repro_torch.spec import make_algo_spec as tmake_spec

torch.set_num_threads(2)
ARCH = "xlstm-125m"
# leaves of the reference's full-width init (jax.eval_shape of
# repro.models.ssm.init_params); its param_count() formula, marked
# "rough" in the reference, says 204,668,928
LEAVES = 198_985_040
PARAM_COUNT = 204_668_928
# as tests/test_torch_moe.py: f32 sum orders differ (XLA vs torch); bf16
# the port's LM bound against the reference (max |diff|, relative L2)
TOL = {"float32": dict(atol=5e-5, rtol=5e-5, loss=1e-5),
       "bfloat16": dict(atol=0.25, rel_l2=0.06, loss=1e-2)}
S = 32
# the reference compiled with XLA's excess precision off, so that it
# rounds at every bf16 cast its code writes, as the port does
EXACT = {"xla_allow_excess_precision": False}


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


def _jkey(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _run(fn, *args):
    return jax.block_until_ready(jax.jit(lambda *a: fn(*a),
                                         compiler_options=EXACT)(*args))


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_equals_reference_field_by_field(which):
    if which == "full":
        tc, jc = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    else:
        tc, jc = configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    assert tf == jf
    assert tc.param_count() == jc.param_count()
    api = models.get_model(tc)
    assert api.decode_step is tssm.decode_step
    assert api.init_cache is tssm.init_cache
    assert [tssm._kind(i, tc) for i in range(tc.n_layers)] == \
        [jssm._kind(i, jc) for i in range(jc.n_layers)]


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------
def test_full_width_init_tree_matches_reference():
    # shapes and dtypes only: the reference's init through jax.eval_shape,
    # the port's under FakeTensorMode (no memory behind either)
    jc, tc = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jssm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    want = [(_jkey(path), (tuple(leaf.shape), str(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    with FakeTensorMode():
        own = tssm.init_params(torch.Generator(), tc, device="cpu")
        got = [(p, (tuple(t.shape), str(t.dtype).split(".")[-1]))
               for p, t in tree.paths(own)]
    assert isinstance(own["layers"], list) and len(own["layers"]) == 12
    assert got == want          # the same leaves in the same order
    n = sum(int(np.prod(s)) for _, (s, _) in got)
    assert n == LEAVES
    assert tc.param_count() == PARAM_COUNT and PARAM_COUNT - n == 5_683_888
    assert set(own["layers"][3]) == {"ln", "w_gates", "b_gates", "r_gates",
                                     "gn", "mlp", "ln2"}
    assert dict(got)[("layers", 0, "w_up")][0] == (768, 3072)


@functools.lru_cache(maxsize=None)
def _reference_init():
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    init = jax.jit(jssm.init_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg_j))
    return jp, convert.params_from_reference(jp), cfg_j, cfg_t


def test_params_from_reference_carries_the_list_tree():
    jp, tp, _, cfg_t = _reference_init()
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 2
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = list(tree.paths(tp))
    assert [p for p, _ in got] == [_jkey(p) for p, _ in jpaths]
    for (_, t), (path, leaf) in zip(got, jpaths):
        assert np.array_equal(t.numpy(), leaf), path
    own = tssm.init_params(torch.Generator().manual_seed(0), cfg_t,
                           device="cpu")
    assert [(p, tuple(v.shape), v.dtype) for p, v in tree.paths(own)] == \
        [(p, tuple(v.shape), v.dtype) for p, v in got]


def test_params_from_reference_carries_the_cache():
    # a list of 4-tuples (mLSTM (C, n, m, conv), sLSTM (c, n, m, h))
    _, _, cfg_j, cfg_t = _reference_init()
    jc = jax.tree.map(np.asarray, jssm.init_cache(cfg_j, 2, 24))
    tc = convert.params_from_reference(jc)
    own = tssm.init_cache(cfg_t, 2, 24, device="cpu")
    assert isinstance(own, list) and all(isinstance(s, tuple) for s in own)
    assert len(tc) == len(own) == cfg_t.n_layers
    for a, b in zip(tc, own):
        assert [(tuple(x.shape), x.dtype) for x in a] == \
            [(tuple(x.shape), x.dtype) for x in b]
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the blocks' parts
# ---------------------------------------------------------------------------
def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(cdtype):
    x, w = _rand(1, 2, 5, 64) * 3 + 1, _rand(2, 64)
    dt = getattr(torch, cdtype)
    got = tssm.group_norm(torch.as_tensor(x).to(dt),
                          torch.as_tensor(w).to(dt), 4)
    want = jssm.group_norm(jnp.asarray(x).astype(cdtype),
                           jnp.asarray(w).astype(cdtype), 4)
    assert got.dtype == dt
    if cdtype == "float32":
        np.testing.assert_allclose(_t2np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        _check(got, want, TOL[cdtype])


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    # the sum over the 4 taps in the reference's order, and the decode
    # state: the last 3 rows of the padded input
    x, w = _rand(3, 2, 7, 16), _rand(4, 4, 16)
    st = _rand(5, 2, 3, 16) if with_state else None
    got, gst = tssm._causal_conv(
        torch.as_tensor(x), torch.as_tensor(w),
        None if st is None else torch.as_tensor(st))
    want, wst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


def _qkv_gates(seed, B, S_, H, hd):
    q, k, v = (_rand(seed + i, B, S_, H, hd) for i in range(3))
    log_i = _rand(seed + 3, B, S_, H)
    log_f = np.array(jax.nn.log_sigmoid(_rand(seed + 4, B, S_, H) + 2.0))
    return q, k, v, log_i, log_f


@pytest.mark.parametrize("S_,chunk", [(64, 16), (48, 48), (40, 64)])
def test_mlstm_chunkwise_matches_reference(S_, chunk):
    # 4 chunks, one chunk, and a chunk longer than the sequence
    args = _qkv_gates(10, 2, S_, 4, 8)
    got = tssm.mlstm_chunkwise(*map(torch.as_tensor, args), chunk)
    want = _run(lambda *a: jssm.mlstm_chunkwise(*a, chunk),
                *map(jnp.asarray, args))
    assert got.dtype == torch.float32 and got.shape == (2, S_, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_mlstm_chunkwise_refuses_a_ragged_sequence():
    args = _qkv_gates(20, 1, 40, 2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tssm.mlstm_chunkwise(*map(torch.as_tensor, args), 16)


def test_mlstm_step_chains_to_the_chunkwise_form():
    # 6 steps of mlstm_step against the reference's, and their outputs
    # against the chunkwise form over the same 6 positions
    q, k, v, li, lf = _qkv_gates(30, 2, 6, 4, 8)
    B, H, hd = 2, 4, 8
    tstate = (torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
              torch.full((B, H), -1e30))
    jstate = tuple(jnp.asarray(s.numpy()) for s in tstate)
    hs = []
    for t in range(6):
        a = [x[:, t] for x in (q, k, v, li, lf)]
        h, tstate = tssm.mlstm_step(*map(torch.as_tensor, a), tstate)
        jh, jstate = jssm.mlstm_step(*map(jnp.asarray, a), jstate)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-5,
                                   atol=2e-5)
        for x, y in zip(tstate, jstate):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5,
                                       atol=2e-5)
        hs.append(h)
    whole = tssm.mlstm_chunkwise(*map(torch.as_tensor, (q, k, v, li, lf)), 6)
    np.testing.assert_allclose(torch.stack(hs, 1).numpy(), whole.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_slstm_cell_matches_reference(cdtype):
    # 12 steps: c, n, m in f32, h in the compute dtype
    _, _, cfg_j, cfg_t = _reference_init()
    D, H = cfg_t.d_model, cfg_t.n_heads
    hd = D // H
    r = _rand(40, H, hd, 4 * hd) * 0.1
    dt = getattr(torch, cdtype)
    zeros = np.zeros((2, H, hd), np.float32)
    tst = (torch.as_tensor(zeros), torch.as_tensor(zeros),
           torch.full((2, H, hd), -1e30), torch.zeros((2, H, hd), dtype=dt))
    jst = (jnp.asarray(zeros), jnp.asarray(zeros),
           jnp.full((2, H, hd), -1e30, jnp.float32),
           jnp.zeros((2, H, hd), cdtype))
    cell = jax.jit(lambda p, g, s: jssm._slstm_cell(p, g, s, H, hd),
                   compiler_options=EXACT)
    tol = TOL[cdtype]
    for t in range(12):
        gx = _rand(50 + t, 2, 4 * D)
        tst = tssm._slstm_cell(torch.as_tensor(r).to(dt),
                               torch.as_tensor(gx).to(dt), tst, H, hd)
        jst = cell({"r_gates": jnp.asarray(r)}, jnp.asarray(gx).astype(
            cdtype), jst)
        assert tst[3].dtype == dt and tst[0].dtype == torch.float32
    for x, y in zip(tst, jst):
        _check(x, y, tol)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return ({"tokens": torch.as_tensor(tokens).long(),
             "labels": torch.as_tensor(labels).long()},
            {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})


def _cfgs(cdtype):
    jp, tp, cfg_j, cfg_t = _reference_init()
    return (jp, tp, cfg_j.replace(compute_dtype=cdtype),
            cfg_t.replace(compute_dtype=cdtype))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_reduced_model_matches_reference(cdtype):
    jp, tp, cfg_j, cfg_t = _cfgs(cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t)
    want = _run(lambda p, t: jssm.forward_train(p, t, cfg_j), jp,
                jbatch["tokens"])
    got = tssm.forward_train(tp, tbatch["tokens"], cfg_t)
    assert got.dtype == cfg_t.cdtype and got.shape == (2, S, cfg_t.vocab)
    _check(got, want, tol, "logits")
    # the route changes nothing: the family has no attention
    assert torch.equal(tssm.forward_train(tp, tbatch["tokens"], cfg_t,
                                          route="plain"), got)
    with pytest.raises(ValueError, match="route"):
        tssm.forward_train(tp, tbatch["tokens"], cfg_t, route="auto")
    jpre = _run(lambda p, b: jprefill_logits(p, b, cfg_j), jp, jbatch)
    pre = models.prefill_logits(tp, tbatch, cfg_t)
    assert pre.shape == (2, 1, cfg_t.vocab)
    _check(pre, jpre, tol, "prefill")
    jloss = _run(lambda p, b: jssm.loss_fn(p, b, cfg_j), jp, jbatch)
    loss = models.get_model(cfg_t).loss_fn(tp, tbatch, cfg_t)
    np.testing.assert_allclose(_t2np(loss), _np(jloss), rtol=tol["loss"],
                               atol=tol["loss"])


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_loss_gradient_matches_reference(cdtype):
    # torch.func.grad of the port's loss_fn against jax.grad of the
    # reference's, every leaf of the list tree
    jp, tp, cfg_j, cfg_t = _cfgs(cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t, seed=3)
    jg = _run(lambda p, b: jax.grad(jssm.loss_fn)(p, b, cfg_j), jp, jbatch)
    tg = torch.func.grad(tssm.loss_fn)(tp, tbatch, cfg_t)
    assert isinstance(tg["layers"], list)
    for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]:
        _check(tree.get(tg, _jkey(p)), x, tol, str(p))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_decode_matches_reference(cdtype):
    # 8 steps: logits every step, every state leaf at the end
    jp, tp, cfg_j, cfg_t = _cfgs(cdtype)
    tol = TOL[cdtype]
    tokens = np.random.default_rng(7).integers(0, cfg_t.vocab, (2, 8))
    tc = models.get_model(cfg_t).init_cache(cfg_t, 2, 12, device="cpu")
    jc = jssm.init_cache(cfg_j, 2, 12)
    step = jax.jit(lambda p, c, t: jssm.decode_step(p, c, t, 0, cfg_j),
                   compiler_options=EXACT)
    for pos in range(8):
        tok = tokens[:, pos:pos + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tssm.decode_step(tp, tc, torch.as_tensor(tok).long(), pos,
                                  cfg_t)
        assert tl.shape == (2, 1, cfg_t.vocab) and tl.dtype == cfg_t.cdtype
        _check(tl, jl, tol, f"logits pos {pos}")
    assert isinstance(tc, list) and all(isinstance(s, tuple) for s in tc)
    for (p, x), (jpath, y) in zip(tree.paths(tc),
                                  jax.tree_util.tree_flatten_with_path(jc)[0]):
        assert p == _jkey(jpath) and x.dtype == getattr(torch, str(y.dtype))
        if x.dtype == torch.float32 and float(np.abs(_np(y)).max()) > 1e29:
            # m starts at -1e30 and stays there only where nothing came in
            np.testing.assert_array_equal(_t2np(x), _np(y))
        else:
            _check(x, y, tol, f"cache {p}")


def test_decode_does_not_modify_the_cache_passed_in():
    _, tp, _, cfg = _reference_init()
    cache = tssm.init_cache(cfg, 2, 12, device="cpu")
    before = tree.tree_map(lambda t: t.clone(), cache)
    _, new = tssm.decode_step(tp, cache, torch.ones((2, 1),
                                                    dtype=torch.long), 3, cfg)
    for p, t in tree.paths(cache):
        assert torch.equal(t, tree.get(before, p))
    assert not torch.equal(new[0][0], cache[0][0])


def test_forward_launches_no_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(a))
    _, tp, _, cfg = _reference_init()
    tbatch, _ = _batch(cfg)
    tssm.forward_train(tp, tbatch["tokens"], cfg)
    assert not calls


# ---------------------------------------------------------------------------
# the list tree's leaf order: the flat row and checkpoints
# ---------------------------------------------------------------------------
M = 4


@functools.lru_cache(maxsize=None)
def _reference_flat():
    """The reference's resident state of M clients of reduced() (ring
    schedule) and the port's `init_flat` on the converted stacked params:
    -> (reference state, port state, port layout, converted params)."""
    cfg_j = jconfigs.get_reduced(ARCH)
    spec = jmake_spec("dfedpgp", topology="ring", n_neighbors=2, seed=0,
                      gossip="matrix", resident=True)
    lay = jsteps.Layout(("data",), (), ("model",), (), M, 2)
    ja, _, _, jfl = jsteps.build_train_algo(cfg_j, None, lay, spec=spec,
                                            lr=0.02)
    stacked = jax.vmap(lambda k: jssm.init_params(k, cfg_j))(
        jax.random.split(jax.random.PRNGKey(0), M))
    sj, jfl = ja.init_flat(stacked, jfl)
    tstacked = convert.params_from_reference(jax.tree.map(np.asarray,
                                                          stacked))
    tspec = tmake_spec("dfedpgp", topology="ring", n_neighbors=2, seed=0,
                       gossip="matrix", resident=True)
    ta, _, _, tfl = tsteps.build_train_algo(
        configs.get_reduced(ARCH), None, tsteps.Layout(
            ("data",), (), ("model",), (), M, 2), spec=tspec)
    st, tfl = ta.init_flat(tstacked, tfl, device="cpu")
    return sj, jfl, st, tfl, tstacked


def test_flat_row_matches_reference_leaf_for_leaf():
    # the shared part (embed and the 2 layers' leaves, layer 1 the sLSTM)
    # packed in the reference's treedef order: the (m, d_flat) buffer
    # bitwise, leaf by leaf
    sj, jfl, st, tfl, tstacked = _reference_flat()
    assert tfl.shapes == jfl.shapes and tfl.sizes == jfl.sizes
    assert tfl.d_flat == jfl.d_flat == sj.flat.shape[1]
    flat_j = np.asarray(sj.flat)
    np.testing.assert_array_equal(st.flat.numpy(), flat_j)
    jmask = jax.tree_util.tree_flatten_with_path(
        jsteps.build_train_algo(
            jconfigs.get_reduced(ARCH), None,
            jsteps.Layout(("data",), (), ("model",), (), M, 2))[1])[0]
    shared = [_jkey(p) for p, keep in jmask if keep]
    assert list(tfl.paths) == shared
    assert shared[1][:2] == ("layers", 0) and ("layers", 1, "r_gates") \
        in shared
    off = 0
    for p, n in zip(tfl.paths, tfl.sizes):
        np.testing.assert_array_equal(
            flat_j[:, off:off + n],
            tree.get(tstacked, p).reshape(M, -1).numpy(), err_msg=str(p))
        off += n
    assert set(st.personal) == {"final_norm", "lm_head"}


def test_reference_checkpoint_loads_in_port(tmp_path):
    # the reference writes its params and decode cache (keys layers/0/ln,
    # cache/1/3, ...); the port's load_pytree reads them into its own
    # templates bit for bit
    jp, tp, cfg_j, cfg_t = _reference_init()
    jcache = jssm.init_cache(cfg_j.replace(compute_dtype="bfloat16"), 2, 8)
    jcache = jax.tree.map(lambda a: a + 1 if a.dtype == jnp.bfloat16 else a,
                          jcache)
    path = str(tmp_path / "ref.npz")
    jckpt.save_pytree(path, {"params": jp, "cache": jcache})
    template = {"params": tckpt.zeros_like(tp),
                "cache": tssm.init_cache(cfg_t.replace(
                    compute_dtype="bfloat16"), 2, 8, device="cpu")}
    assert set(tckpt.flatten(template)) == set(np.load(path).files)
    got = tckpt.load_pytree(path, template)
    assert isinstance(got["params"]["layers"], list)
    assert all(isinstance(s, tuple) for s in got["cache"])
    for p, x in tree.paths(got["params"]):
        assert torch.equal(x, tree.get(tp, p)), p
    for (p, x), (_, y) in zip(tree.paths(got["cache"]),
                              jax.tree_util.tree_flatten_with_path(jcache)[0]):
        np.testing.assert_array_equal(_t2np(x), _np(y), err_msg=str(p))


def test_port_checkpoint_loads_in_reference(tmp_path):
    # the port's resident state (flat row, the personal tree, momentum)
    # and its list params written by the port, read by the reference's
    # load_pytree into its own templates, bit for bit
    sj, _, st, _, tstacked = _reference_flat()
    path = str(tmp_path / "port.npz")
    tckpt.save_pytree(path, {"state": st, "params": tstacked})
    jstacked = jax.tree.map(lambda a: jnp.asarray(a.numpy()), tstacked)
    back = jckpt.load_pytree(path, {
        "state": jax.tree.map(jnp.zeros_like, sj),
        "params": jax.tree.map(jnp.zeros_like, jstacked)})
    np.testing.assert_array_equal(np.asarray(back["state"].flat),
                                  st.flat.numpy())
    for p, x in jax.tree_util.tree_flatten_with_path(back["params"])[0]:
        np.testing.assert_array_equal(
            np.asarray(x), tree.get(tstacked, _jkey(p)).numpy(),
            err_msg=str(p))
    assert float(np.asarray(back["state"].mu).sum()) == M


def test_partition_paths_name_list_indices():
    _, tp, _, _ = _reference_init()
    seen = []
    tpartition.build_mask(tp, lambda s: seen.append(s) or True)
    assert "layers/1/r_gates" in seen and "layers/0/w_up" in seen


# ---------------------------------------------------------------------------
# Regime B
# ---------------------------------------------------------------------------
def test_trainer_resident_round_matches_reference():
    # one resident round of launch.train.Trainer (ring topology) from the
    # reference's stacked init against the reference's build_train_algo
    # round on the same batches: every state leaf at the Regime-B
    # tolerance (rtol 1e-4, atol 2e-5) but the momentum, the round's
    # gradient, held as the gradients above (TOL)
    ap = ttrain.build_parser()
    args = ap.parse_args(["--arch", ARCH, "--reduced", "--clients", str(M),
                          "--batch", "2", "--seq", str(S), "--resident",
                          "--topology", "ring", "--device", "cpu"])
    run = ttrain.Trainer(args, ap)
    cfg_j = jconfigs.get_reduced(ARCH)
    spec = jmake_spec("dfedpgp", topology="ring", n_neighbors=2, seed=0,
                      gossip="matrix", resident=True)
    lay = jsteps.Layout(("data",), (), ("model",), (), M, 2)
    ja, _, _, jfl = jsteps.build_train_algo(cfg_j, None, lay, spec=spec,
                                            lr=0.02)
    sj, _, _, _, _ = _reference_flat()
    run.state = convert.flat_state_from_reference(
        flat=np.asarray(sj.flat), personal=jax.tree.map(np.asarray,
                                                        sj.personal),
        mu=np.asarray(sj.mu), mom_u=np.asarray(sj.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, sj.opt_v.momentum),
        round=np.asarray(sj.round))
    Pj = spec.schedule(M).at(0)
    P, _ = run.topology(0)
    np.testing.assert_array_equal(P.idx.numpy(), np.asarray(Pj.idx))
    rng = np.random.default_rng(12)
    toks = {k: rng.integers(0, cfg_j.vocab, (M, 1, 2, S)).astype(np.int32)
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
    st = run.state
    tol = TOL["float32"]
    np.testing.assert_allclose(st.flat.numpy(), np.asarray(sj.flat),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(st.opt_u.momentum.numpy(),
                               np.asarray(sj.opt_u.momentum),
                               rtol=tol["rtol"], atol=tol["atol"])
    for p, x in jax.tree_util.tree_flatten_with_path(sj.personal)[0]:
        np.testing.assert_allclose(
            tree.get(st.personal, _jkey(p)).numpy(), np.asarray(x),
            rtol=1e-4, atol=2e-5, err_msg=str(p))
    np.testing.assert_array_equal(st.mu.numpy(), np.asarray(sj.mu))


def test_launch_structs_and_steps():
    # the meta structs take the list tree (stacked per leaf) and the
    # list-of-tuples cache; the prefill and decode steps run the clients
    cfg = configs.get_reduced(ARCH)
    ps = tsteps.stacked_param_struct(cfg, 3)
    assert isinstance(ps["layers"], list)
    assert tuple(ps["layers"][1]["r_gates"].shape) == (3, 4, 32, 128)
    shape = configs.InputShape("decode", 64, 6, "decode")
    lay = tsteps.Layout(("data",), (), ("model",), (), 3, 2)
    specs = tsteps.input_specs(cfg, shape, lay)
    assert isinstance(specs["cache"], list) and isinstance(
        specs["cache"][0], tuple)
    assert tuple(specs["cache"][0][0].shape) == (3, 2, 4, 64, 64)
    fn, _, _, args = tsteps.build_decode_step(cfg, None, lay, shape)
    params = ttrain.init_stacked(cfg, 3, torch.device("cpu"))
    cache = tree.tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype),
                          args[1])
    logits, new = fn(params, cache, torch.ones((3, 2, 1), dtype=torch.long),
                     torch.tensor(0))
    assert logits.shape == (3, 2, 1, cfg.vocab)
    assert isinstance(new, list) and tuple(new[1][3].shape) == (3, 2, 4, 32)
    pshape = configs.InputShape("prefill", S, 6, "prefill")
    pfn, _, _, pargs = tsteps.build_prefill_step(cfg, None, lay, pshape)
    out = pfn(params, {"tokens": torch.ones((3, 2, S), dtype=torch.long)})
    assert out.shape == (3, 2, 1, cfg.vocab)
